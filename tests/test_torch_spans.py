"""The port's spans (``utils.profiling.span``): off they record nothing;
on, under ``recording()`` or a profiler, each keeps its name, times,
parent and request; the log is bounded; a span is a host operation of the
profiler's trace; the metrics and ``fit`` open the spans of their layers;
and nothing they compute changes with spans on."""

import collections
import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions
from spotlight_tpu_torch.data.interactions import SequenceInteractions
from spotlight_tpu_torch.factorization.explicit import \
    ExplicitFactorizationModel
from spotlight_tpu_torch.factorization.implicit import \
    ImplicitFactorizationModel
from spotlight_tpu_torch.sequence.implicit import ImplicitSequenceModel
from spotlight_tpu_torch.utils import profiling
from spotlight_tpu_torch.utils.profiling import SpanRecord, span

NUM_USERS, NUM_ITEMS, PAIRS, BATCH = 60, 50, 700, 128
SEQUENCES, LENGTH = 90, 6


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@contextlib.contextmanager
def spans_on(mode, tmp_path):
    """Spans on by ``recording()`` or by a profiler (``profiling.trace``
    on the CPU)."""
    if mode == 'recording':
        with profiling.recording():
            yield
    else:
        with profiling.trace(str(tmp_path / 'trace'), device='cpu'):
            yield


def pairs(ratings=False, seed=0):
    rs = np.random.RandomState(seed)
    return Interactions(rs.randint(0, NUM_USERS, PAIRS),
                        rs.randint(0, NUM_ITEMS, PAIRS),
                        ratings=(rs.randint(1, 6, PAIRS).astype(np.float32)
                                 if ratings else None),
                        num_users=NUM_USERS, num_items=NUM_ITEMS)


def sequences(seed=0):
    rs = np.random.RandomState(seed)
    return SequenceInteractions(rs.randint(1, NUM_ITEMS, (SEQUENCES, LENGTH)),
                                num_items=NUM_ITEMS)


#: Estimators whose ``fit`` opens spans: (class, keyword arguments, data).
ESTIMATORS = {
    'implicit': (ImplicitFactorizationModel, {}, pairs),
    'implicit-lazy': (ImplicitFactorizationModel, {'sparse': True}, pairs),
    'implicit-in-batch': (ImplicitFactorizationModel,
                          {'negative_sampling': 'in_batch'}, pairs),
    'explicit': (ExplicitFactorizationModel, {},
                 lambda: pairs(ratings=True)),
    'explicit-lazy': (ExplicitFactorizationModel, {'sparse': True},
                      lambda: pairs(ratings=True)),
    'lstm': (ImplicitSequenceModel, {'representation': 'lstm'}, sequences),
    'lstm-lazy': (ImplicitSequenceModel,
                  {'representation': 'lstm', 'sparse': True}, sequences),
    'mixture': (ImplicitSequenceModel, {'representation': 'mixture'},
                sequences),
}


def estimator(kind, n_iter=2, seed=1):
    cls, kwargs, data = ESTIMATORS[kind]
    model = cls(n_iter=n_iter, batch_size=BATCH if cls is not
                ImplicitSequenceModel else 32, embedding_dim=8,
                random_state=np.random.RandomState(seed), device='cpu',
                **kwargs)
    return model, data()


def shape(records):
    """Counts of (name, parent's name), and whether every record shares
    its request with its parent."""
    by_id = {r.id: r for r in records}
    counts = collections.Counter(
        (r.name, by_id[r.parent].name if r.parent else None)
        for r in records)
    for r in records:
        if r.parent is None:
            assert r.request == r.id
        else:
            assert r.request == by_id[r.parent].request
    return dict(counts)


@pytest.mark.parametrize('what', ['span', 'fit', 'mrr_score'])
def test_nothing_is_recorded_when_off(what):
    assert not torch.autograd._profiler_enabled()
    if what == 'span':
        with span('spotlight.test'):
            pass
    elif what == 'fit':
        model, data = estimator('implicit')
        model.fit(data)
    else:
        model, data = estimator('implicit')
        model.fit(data)
        evaluation.mrr_score(model, data)
    assert profiling.spans() == []
    assert profiling.SPANS_DROPPED == 0


@pytest.mark.parametrize('mode', ['recording', 'profiler'])
def test_records_carry_name_times_parent_and_request(mode, tmp_path):
    before = time.perf_counter()
    with spans_on(mode, tmp_path):
        for _ in range(2):
            with span('outer'):
                with span('inner'):
                    with span('innermost'):
                        pass
                with span('second'):
                    pass
    after = time.perf_counter()
    records = profiling.spans()
    assert [r.name for r in records] == [
        'innermost', 'inner', 'second', 'outer'] * 2
    assert all(isinstance(r, SpanRecord) for r in records)
    assert all(before <= r.start <= r.end <= after for r in records)
    for call in (records[:4], records[4:]):
        innermost, inner, second, outer = call
        assert outer.parent is None and outer.request == outer.id
        assert inner.parent == outer.id and second.parent == outer.id
        assert innermost.parent == inner.id
        assert {r.request for r in call} == {outer.id}
        assert outer.start <= inner.start <= innermost.start
        assert innermost.end <= inner.end <= second.start
        assert second.end <= outer.end
    assert records[0].request != records[4].request
    assert len({r.id for r in records}) == 8


def test_self_time_is_the_duration_less_the_children_cover():
    with profiling.recording():
        with span('a'):
            time.sleep(0.002)
            with span('b'):
                time.sleep(0.003)
            with span('c'):
                time.sleep(0.001)
    b, c, a = profiling.spans()
    want = (a.end - a.start) - (b.end - b.start) - (c.end - c.start)
    assert profiling.self_time(a) == pytest.approx(want, abs=1e-12)
    assert profiling.self_time(b) == b.end - b.start
    assert profiling.self_time(a) >= 0.002
    # Children that overlap are covered once; a part past the parent's end
    # is not counted.
    parent = SpanRecord('p', 0.0, 10.0, 1, None, 1)
    children = [SpanRecord('x', 1.0, 4.0, 2, 1, 1),
                SpanRecord('y', 3.0, 6.0, 3, 1, 1),
                SpanRecord('z', 8.0, 12.0, 4, 1, 1),
                SpanRecord('other', 0.0, 10.0, 5, 9, 9)]
    assert profiling.self_time(parent, [parent] + children) == 3.0


def test_the_log_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, 'SPAN_LOG_LIMIT', 5)
    with profiling.recording():
        for i in range(12):
            with span('s{}'.format(i)):
                pass
    records = profiling.spans()
    assert [r.name for r in records] == ['s{}'.format(i) for i in range(5)]
    assert profiling.SPANS_DROPPED == 7
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.SPANS_DROPPED == 0


def test_recording_nests_and_ends():
    with profiling.recording():
        with profiling.recording():
            with span('inside'):
                pass
        with span('outer block'):
            pass
    with span('after'):
        pass
    assert [r.name for r in profiling.spans()] == ['inside', 'outer block']


def test_a_span_that_raises_is_recorded():
    with profiling.recording():
        with pytest.raises(ZeroDivisionError):
            with span('raises'):
                raise ZeroDivisionError
        with span('next'):
            pass
    raised, following = profiling.spans()
    assert raised.name == 'raises' and following.parent is None


def test_a_span_is_a_host_operation_of_the_trace():
    """``torch.profiler`` records a span as an operation of the host on
    the caller's thread, not as a user annotation (which the benchmark's
    reading of idle gaps leaves out)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    assert profiling._marker is torch._C._profiler._RecordFunctionFast
    with profile(activities=[ProfilerActivity.CPU]) as traced:
        with record_function('annotation'):
            with span('spotlight.test'):
                torch.ones(4) + 1
    events = {e.name(): e for e in traced.profiler.kineto_results.events()}
    mine, op = events['spotlight.test'], events['aten::add']
    assert not mine.is_user_annotation()
    assert events['annotation'].is_user_annotation()
    assert mine.device_type() == torch.autograd.DeviceType.CPU
    assert mine.start_thread_id() == op.start_thread_id()
    assert mine.start_ns() <= op.start_ns() <= op.end_ns() <= mine.end_ns()
    assert [r.name for r in profiling.spans()] == ['spotlight.test']


FIT_SPANS = {'spotlight.fit.epoch_data', 'spotlight.fit.epoch_draws',
             'spotlight.fit.step'}


@pytest.mark.parametrize('kind', sorted(ESTIMATORS))
def test_fit_opens_the_spans_of_its_layers(kind):
    model, data = estimator(kind, n_iter=2)
    with profiling.recording():
        model.fit(data)
    rows = len(data.sequences) if kind in ('lstm', 'lstm-lazy', 'mixture') \
        else len(data)
    batches = -(-rows // model._batch_size)
    assert shape(profiling.spans()) == {
        ('spotlight.fit', None): 1,
        ('spotlight.fit.epoch_data', 'spotlight.fit'): 1,
        ('spotlight.fit.epoch_draws', 'spotlight.fit'): 2,
        ('spotlight.fit.step', 'spotlight.fit'): 2 * batches}


def _mf():
    model, data = estimator('implicit', n_iter=1)
    model.fit(data)
    return model, data


def _lstm(representation='lstm'):
    model = ImplicitSequenceModel(
        representation=representation, n_iter=1, batch_size=32,
        embedding_dim=8, random_state=np.random.RandomState(1), device='cpu')
    model.fit(sequences())
    return model, sequences(seed=3)


#: The metrics' calls: (the model and its test data, the call given
#: ``streaming``, its root span).
METRICS = {
    'mrr': (_mf, lambda m, d, s: evaluation.mrr_score(
        m, d, batch_size=16, streaming=s), 'spotlight.mrr_score'),
    'mrr-masked': (_mf, lambda m, d, s: evaluation.mrr_score(
        m, d, train=d, batch_size=16, streaming=s), 'spotlight.mrr_score'),
    'precision': (_mf, lambda m, d, s: evaluation.precision_recall_score(
        m, d, k=3, batch_size=16, streaming=s),
        'spotlight.precision_recall_score'),
    'sequence-mrr': (_lstm, lambda m, d, s: evaluation.sequence_mrr_score(
        m, d, batch_size=32, streaming=s), 'spotlight.sequence_mrr_score'),
    'sequence-mrr-excluded': (
        lambda: _lstm('mixture'),
        lambda m, d, s: evaluation.sequence_mrr_score(
            m, d, exclude_preceding=True, batch_size=32, streaming=s),
        'spotlight.sequence_mrr_score'),
    'sequence-precision': (
        _lstm, lambda m, d, s: evaluation.sequence_precision_recall_score(
            m, d, k=2, batch_size=32, streaming=s),
        'spotlight.sequence_precision_recall_score'),
}


def _batches(name, data):
    rows = (len(data.sequences) if name.startswith('sequence')
            else len(np.unique(data.user_ids)))
    return -(-rows // (32 if name.startswith('sequence') else 16))


@pytest.mark.parametrize('streaming', [True, False])
@pytest.mark.parametrize('name', sorted(METRICS))
def test_metrics_open_the_spans_of_their_layers(name, streaming):
    make, call, root = METRICS[name]
    model, data = make()
    profiling.clear_spans()
    with profiling.recording():
        call(model, data, streaming)
    batches = _batches(name, data)
    want = {(root, None): 1, ('spotlight.eval.rows', root): 1,
            ('spotlight.eval.upload', root): batches}
    if streaming:
        want[('spotlight.eval.factors', root)] = batches
    assert shape(profiling.spans()) == want


def _equal(a, b):
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize('mode', ['recording', 'profiler'])
@pytest.mark.parametrize('name', sorted(METRICS))
def test_metric_results_are_bit_identical_with_spans_on(name, mode,
                                                        tmp_path):
    make, call, _ = METRICS[name]
    model, data = make()
    off = call(model, data, True)
    with spans_on(mode, tmp_path):
        on = call(model, data, True)
    assert profiling.spans()
    assert _equal(off, on)


@pytest.mark.parametrize('mode', ['recording', 'profiler'])
@pytest.mark.parametrize('kind', ['implicit', 'implicit-lazy', 'explicit',
                                  'lstm'])
def test_fitted_tables_are_bit_identical_with_spans_on(kind, mode,
                                                       tmp_path):
    off, data = estimator(kind, n_iter=2)
    off.fit(data)
    on, _ = estimator(kind, n_iter=2)
    with spans_on(mode, tmp_path):
        on.fit(data)
    assert profiling.spans()
    got, want = on._net.state_dict(), off._net.state_dict()
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    assert on._last_epoch_loss == off._last_epoch_loss


def test_threads_keep_their_own_parents(monkeypatch):
    """Threads recording at once under a short switch interval: every
    span ends in the log or in the dropped count, and each record's parent
    is the span its own thread had open."""
    monkeypatch.setattr(profiling, 'SPAN_LOG_LIMIT', 3000)
    workers, rounds = 8, 60

    def work(k):
        for _ in range(rounds):
            with span('outer.{}'.format(k)):
                with span('inner.{}'.format(k)):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(workers)]
            for thread in threads:
                thread.start()
            deadline = time.monotonic() + 60
            for thread in threads:
                thread.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(interval)
    assert not any(thread.is_alive() for thread in threads)
    records = profiling.spans()
    assert len(records) + profiling.SPANS_DROPPED == 2 * workers * rounds
    by_id = {r.id: r for r in records}
    for r in records:
        kind, k = r.name.split('.')
        if kind == 'outer':
            assert r.parent is None and r.request == r.id
        else:
            assert r.parent is not None and r.request == r.parent
            if r.parent in by_id:
                assert by_id[r.parent].name == 'outer.' + k
