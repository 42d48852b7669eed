"""The port's evaluation path against the JAX package's.

On a JAX model converted into the port (``params_from_jax``), the port's
``mrr_score`` and ``precision_recall_score`` must agree with the JAX
functions, with and without a train mask, at scalar and vector ``k``, on
the streaming path (the port's plain kernel versions on the CPU against the
JAX Pallas kernels in interpret mode) and on the materialize path.

MRR agrees to rtol 1e-6: ranks are half-integer counts, equal in both
packages, and the reciprocal means are float32 sums taken alike.
Precision and recall are ratios of hit counts and must be exactly equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu import evaluation as jax_eval
from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions
from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
from spotlight_tpu_torch.ops.kernels import ranking, topk
from spotlight_tpu_torch.sequence import ImplicitSequenceModel

from tests.test_torch_factorization import fitted_pair, to_port
from tests.test_torch_sequence import _tests as sequence_tests
from tests.test_torch_sequence import pair as sequence_pair

MRR_RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def _setup(fused=True):
    jax_model, port, train, test = fitted_pair(fused)
    return jax_model, port, train, test, to_port(train), to_port(test)


def _heavy(train, user, extra, seed=0):
    """``train`` plus ``extra`` more items for ``user`` (a heavy row that
    widens the top-k over-fetch)."""
    items = np.random.RandomState(seed).choice(train.num_items, extra,
                                               replace=False)
    return (np.concatenate([np.full(extra, user), train.user_ids]),
            np.concatenate([items, train.item_ids]))


@pytest.mark.parametrize('streaming', [True, False])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('fused', [True, False])
def test_mrr_matches_jax(streaming, masked, fused):
    jax_model, port, train, test, ptrain, ptest = _setup(fused)
    got = evaluation.mrr_score(port, ptest, train=ptrain if masked else None,
                               streaming=streaming)
    want = jax_eval.mrr_score(jax_model, test,
                              train=train if masked else None,
                              streaming=streaming)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)


@pytest.mark.parametrize('streaming', [True, False])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('k', [5, (1, 5, 10)])
def test_precision_recall_matches_jax(streaming, masked, k):
    jax_model, port, train, test, ptrain, ptest = _setup()
    k_arg = list(k) if isinstance(k, tuple) else k
    got = evaluation.precision_recall_score(
        port, ptest, train=ptrain if masked else None, k=k_arg,
        streaming=streaming)
    want = jax_eval.precision_recall_score(
        jax_model, test, train=train if masked else None, k=k_arg,
        streaming=streaming)
    for got_part, want_part in zip(got, want):
        assert got_part.shape == want_part.shape
        np.testing.assert_array_equal(got_part, want_part)


@pytest.mark.parametrize('streaming', [True, False])
def test_heavy_train_user_over_fetch_matches_jax(streaming):
    """A 60-item train row forces a fetch of k + 60 and, in small batches,
    widens only its own batch."""
    jax_model, port, train, test, _, ptest = _setup()
    users, items = _heavy(train, int(test.user_ids[0]), 60)
    heavy = Interactions(users, items, num_users=train.num_users,
                         num_items=train.num_items)
    from spotlight_tpu.data.interactions import Interactions as JaxInter
    jax_heavy = JaxInter(users, items, num_users=train.num_users,
                         num_items=train.num_items)
    got = evaluation.precision_recall_score(port, ptest, train=heavy, k=10,
                                            batch_size=16,
                                            streaming=streaming)
    want = jax_eval.precision_recall_score(jax_model, test, train=jax_heavy,
                                           k=10, batch_size=16,
                                           streaming=streaming)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    got = evaluation.mrr_score(port, ptest, train=heavy, batch_size=16,
                               streaming=streaming)
    want = jax_eval.mrr_score(jax_model, test, train=jax_heavy,
                              batch_size=16, streaming=streaming)
    np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)


@pytest.mark.parametrize('batch_size', [7, 50])
def test_streaming_equals_materialize_in_ragged_batches(batch_size):
    _, port, _, _, ptrain, ptest = _setup()
    for kwargs in ({}, {'train': ptrain}):
        np.testing.assert_allclose(
            evaluation.mrr_score(port, ptest, batch_size=batch_size,
                                 **kwargs),
            evaluation.mrr_score(port, ptest, streaming=False, **kwargs),
            rtol=MRR_RTOL, atol=0)
        for got, want in zip(
                evaluation.precision_recall_score(
                    port, ptest, k=[3, 8], batch_size=batch_size, **kwargs),
                evaluation.precision_recall_score(
                    port, ptest, k=[3, 8], streaming=False, **kwargs)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('masked', [False, True])
def test_mrr_of_heavy_and_light_users_in_one_batch(monkeypatch, masked):
    """Two users with 80 and 40 test items beside users with one to four:
    the pads reach the rank pass as NaN target scores, which count nothing,
    with each row's count of targets from the host, and the MRR equals
    JAX's and the materialize path's."""
    jax_model, port, train, test, ptrain, _ = _setup()
    rs = np.random.RandomState(5)
    users = [np.full(80, 3), np.full(40, 7)]
    items = [rs.choice(train.num_items, 80, replace=False),
             rs.choice(train.num_items, 40, replace=False)]
    for user in range(10, 60):
        count = 1 + user % 4
        users.append(np.full(count, user))
        items.append(rs.choice(train.num_items, count, replace=False))
    users, items = np.concatenate(users), np.concatenate(items)
    from spotlight_tpu.data.interactions import Interactions as JaxInter
    jax_heavy = JaxInter(users, items, num_users=train.num_users,
                         num_items=train.num_items)
    heavy = to_port(jax_heavy)
    seen = []
    original = evaluation.rank_weights

    def spy(users, items, bias, target_scores, mixture, widths):
        seen.append((torch.isnan(target_scores).sum(dim=1), widths))
        return original(users, items, bias, target_scores, mixture, widths)

    monkeypatch.setattr(evaluation, 'rank_weights', spy)
    kwargs = {'train': ptrain} if masked else {}
    got = evaluation.mrr_score(port, heavy, **kwargs)
    want = jax_eval.mrr_score(jax_model, jax_heavy,
                              train=train if masked else None)
    np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)
    np.testing.assert_allclose(
        got, evaluation.mrr_score(port, heavy, streaming=False, **kwargs),
        rtol=MRR_RTOL, atol=0)
    counts = np.bincount(users)[np.unique(users)]
    assert len(seen) == 1
    assert seen[0][0].tolist() == (80 - counts).tolist()
    assert seen[0][1].tolist() == counts.tolist()


class _PredictOnly:
    """A model that only predicts: the metrics score it user by user.  It
    asks for the CPU through ``_device``, as any model must that wants the
    metrics off the card."""

    _device = torch.device('cpu')

    def __init__(self, scores):
        self._scores = scores

    def predict(self, user_ids, item_ids=None):
        return self._scores[user_ids]


def test_predict_only_model_without_device_needs_the_card(monkeypatch):
    """A model that names no device is evaluated on ``cuda``, as the
    estimators are by default: without a card the metrics raise rather
    than run on the CPU unasked."""
    _, _, _, _, _, ptest = _setup()

    class NoDevice:
        def predict(self, user_ids, item_ids=None):
            raise AssertionError('scored on the CPU unasked')

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for metric in (evaluation.mrr_score, evaluation.precision_recall_score):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            metric(NoDevice(), ptest)


def test_predict_only_model_matches_jax():
    _, _, train, test, ptrain, ptest = _setup()
    rs = np.random.RandomState(3)
    # Scores on a coarse grid, so the catalogue holds many exact ties.
    scores = rs.randint(0, 6, (train.num_users, train.num_items)).astype(
        np.float32)
    model = _PredictOnly(scores)
    np.testing.assert_allclose(
        evaluation.mrr_score(model, ptest, train=ptrain),
        jax_eval.mrr_score(model, test, train=train), rtol=MRR_RTOL, atol=0)
    for got, want in zip(
            evaluation.precision_recall_score(model, ptest, train=ptrain,
                                              k=[1, 4]),
            jax_eval.precision_recall_score(model, test, train=train,
                                            k=[1, 4])):
        np.testing.assert_array_equal(got, want)


def test_k_beyond_catalogue_raises():
    _, port, _, _, _, ptest = _setup()
    with pytest.raises(ValueError, match='exceeds the catalog size'):
        evaluation.precision_recall_score(port, ptest, k=ptest.num_items + 1)


def test_kernel_failure_is_not_rerouted(monkeypatch):
    """The port has no fallback: a failing kernel fails the metric."""
    _, port, _, _, _, ptest = _setup()

    def broken(*args):
        raise RuntimeError('kernel launch failed')

    monkeypatch.setattr(evaluation, 'rank_weights', broken)
    monkeypatch.setattr(evaluation, 'streaming_topk', broken)
    with pytest.raises(RuntimeError, match='kernel launch failed'):
        evaluation.mrr_score(port, ptest)
    with pytest.raises(RuntimeError, match='kernel launch failed'):
        evaluation.precision_recall_score(port, ptest)
    assert not hasattr(evaluation, 'FALLBACK_COUNTS')


def test_refused_route_runs_the_materialize_path(monkeypatch):
    """Where the kernels do not take the model's factors (the route queries
    refuse, as on a card past the kernels' shared memory), each metric call
    runs whole on the materialize path at MATERIALIZE_BATCH rows a batch,
    counts once in MATERIALIZE_ROUTES, and equals JAX's and
    streaming=False's."""
    jax_model, port, train, test, ptrain, ptest = _setup()
    jax_seq, port_seq, sequences = sequence_pair('mixture', 4)
    jax_seq_test, port_seq_test = sequence_tests(sequences)
    refuse = lambda *args: False  # noqa: E731
    monkeypatch.setattr(ranking, 'streams', refuse)
    monkeypatch.setattr(topk, 'streams', refuse)
    monkeypatch.setattr(evaluation, 'MATERIALIZE_BATCH', 7)
    batches = []

    def spy(name):
        original = getattr(evaluation, name)

        def scored(model, rows, *args):
            batches.append(len(rows))
            return original(model, rows, *args)
        monkeypatch.setattr(evaluation, name, scored)

    spy('_score_user_batch')
    spy('_sequence_final_scores')
    calls = (
        (evaluation.mrr_score, jax_eval.mrr_score, port, jax_model, ptest,
         test, {'train': ptrain}, {'train': train}),
        (evaluation.precision_recall_score, jax_eval.precision_recall_score,
         port, jax_model, ptest, test, {'train': ptrain, 'k': [1, 5]},
         {'train': train, 'k': [1, 5]}),
        (evaluation.sequence_mrr_score, jax_eval.sequence_mrr_score,
         port_seq, jax_seq, port_seq_test, jax_seq_test,
         {'exclude_preceding': True}, {'exclude_preceding': True}),
        (evaluation.sequence_precision_recall_score,
         jax_eval.sequence_precision_recall_score, port_seq, jax_seq,
         port_seq_test, jax_seq_test, {'k': 3}, {'k': 3}))
    for (metric, jax_metric, model, jax_model_, data, jax_data, kwargs,
         jax_kwargs) in calls:
        del batches[:]
        before = evaluation.MATERIALIZE_ROUTES
        got = metric(model, data, **kwargs)
        assert evaluation.MATERIALIZE_ROUTES - before == 1, metric
        assert max(batches) == 7, metric
        materialized = metric(model, data, streaming=False, **kwargs)
        want = jax_metric(jax_model_, jax_data, **jax_kwargs)
        if isinstance(got, tuple):   # precision and recall: exactly
            for got_part, mat_part, want_part in zip(got, materialized,
                                                     want):
                np.testing.assert_array_equal(got_part, mat_part)
                np.testing.assert_array_equal(got_part, want_part)
        else:
            np.testing.assert_array_equal(got, materialized)
            np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)


class _CustomNet(torch.nn.Module):
    """A custom representation: it scores as the network it wraps and
    carries its ``embedding_dim``, but it is none of the networks whose
    factors the streaming kernels take."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.embedding_dim = inner.embedding_dim

    def score_catalog(self, *args):
        return self.inner.score_catalog(*args)

    def user_representation(self, *args):
        return self.inner.user_representation(*args)


@pytest.mark.parametrize('metric,kwargs', [
    ('mrr_score', {}),
    ('precision_recall_score', {'k': [1, 5]}),
    ('sequence_mrr_score', {'exclude_preceding': True}),
    ('sequence_precision_recall_score', {'k': 3})])
def test_network_the_kernels_do_not_take_is_materialized(monkeypatch,
                                                         metric, kwargs):
    """A model whose network has an ``embedding_dim`` but is not one the
    kernels stream runs on the materialize path from its first batch: no
    factors are asked for, MATERIALIZE_ROUTES stays where it was, and the
    result equals streaming=False's, and the wrapped network's, exactly."""
    if metric.startswith('sequence'):
        _, inner, sequences = sequence_pair('lstm', None)
        _, data = sequence_tests(sequences)
        model = ImplicitSequenceModel(
            loss='bpr', representation=_CustomNet(inner._net),
            embedding_dim=inner._embedding_dim, device='cpu')
        model._initialize(data)
    else:
        _, inner, _, _, ptrain, data = _setup()
        kwargs = dict(kwargs, train=ptrain)
        model = ImplicitFactorizationModel(
            loss='bpr', representation=_CustomNet(inner._net), device='cpu')
        model._initialize(ptrain)
    assert model._rank_factor_shape() is None
    assert inner._rank_factor_shape() is not None
    metric = getattr(evaluation, metric)
    want = metric(inner, data, streaming=False, **kwargs)

    def refuse(*args):
        raise AssertionError('factors asked of a model that gives none')

    monkeypatch.setattr(evaluation, '_rank_factors', refuse)
    before = evaluation.MATERIALIZE_ROUTES
    got = metric(model, data, **kwargs)
    assert evaluation.MATERIALIZE_ROUTES == before
    parts = lambda out: out if isinstance(out, tuple) else (out,)  # noqa
    for other in (metric(model, data, streaming=False, **kwargs), want):
        for got_part, other_part in zip(parts(got), parts(other)):
            np.testing.assert_array_equal(got_part, other_part)


def test_padded_and_trimmed_rows_match_jax():
    """The users' rows and the sequences' excluded rows, built through
    ``_rows_on``, equal the JAX package's padded rows, each batch cut to
    its own widest row (JAX's ``_trim_batch_rows`` of its ``_dedup_rows``
    for the excluded rows, without its power-of-two width)."""
    _, _, train, _, ptrain, _ = _setup()
    users = np.array([0, 3, 5, 9, 40])
    got, = evaluation._rows_on(
        [evaluation._csr_rows(ptrain.tocsr(), users)], torch.device('cpu'))
    want = jax_eval._padded_rows(train.tocsr(), users)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    rs = np.random.RandomState(4)
    prefixes = rs.randint(0, 40, (9, 20)).astype(np.int32)
    prefixes[3] = 7                  # one distinct item
    prefixes[5, :12] = 0             # left padding
    excluded = evaluation._excluded_rows(prefixes, True)
    batches = list(excluded.batches(4))
    assert len(batches) == 3
    for start, rows in zip(range(0, 9, 4), batches):
        got, = evaluation._rows_on([rows], torch.device('cpu'))
        want = jax_eval._trim_batch_rows(
            jax_eval._dedup_rows(prefixes.astype(np.int64))[start:start + 4])
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), _trimmed(want))
    assert evaluation._excluded_rows(prefixes, False) is None
    assert [len(b) for b in evaluation._batched(np.arange(10), 4)] == [4, 4,
                                                                      2]


def _row_case(case):
    """(test, train or None, batch size) of a named case of rows."""
    num_users, num_items = 30, 50
    rs = np.random.RandomState(len(case))

    def pairs(users, counts):
        items = [rs.choice(num_items, c, replace=False) for c in counts]
        return Interactions(np.repeat(np.asarray(users, np.int64), counts),
                            np.concatenate(items + [np.array([], int)]),
                            num_users=num_users, num_items=num_items)

    if case == 'empty':
        return pairs([], []), pairs([1, 2], [3, 1]), 4
    if case == 'one_user':
        return pairs([7], [5]), None, 4
    if case == 'batches_of_different_widths':
        users = np.arange(2, 25)
        return pairs(users, 1 + (users * 7) % 11), None, 5
    if case == 'train_rows_where_some_users_have_none':
        users = np.arange(0, 20, 2)
        return (pairs(users, 1 + users % 3),
                pairs(users[::3], 2 + users[::3] % 9), 3)
    # Duplicate pairs, in the test set and the train set: the CSR keeps
    # each pair once.
    test = pairs([4, 9, 12], [6, 2, 4])
    train = pairs([9, 12, 20], [3, 8, 2])
    double = lambda x: Interactions(  # noqa: E731
        np.concatenate([x.user_ids, x.user_ids[::2]]),
        np.concatenate([x.item_ids, x.item_ids[::2]]),
        num_users=num_users, num_items=num_items)
    return double(test), double(train), 2


ROW_CASES = ['empty', 'one_user', 'batches_of_different_widths',
             'train_rows_where_some_users_have_none', 'duplicate_pairs']


def _trimmed(rows):
    """Padded rows cut to their widest row: a column slice, as the JAX
    package's trim without its power-of-two width."""
    return rows[:, :max(int((rows >= 0).sum(axis=1).max(initial=0)), 1)]


def _host_padded_batches(test, train, batch_size):
    """The JAX package's form of each batch: its ``_padded_rows`` over the
    users with test items, trimmed to the batch's widest."""
    csr = test.tocsr()
    counts = np.diff(csr.indptr)
    users = np.where(counts > 0)[0]
    targets = jax_eval._padded_rows(csr, users)
    train_rows = (jax_eval._padded_rows(train.tocsr(), users)
                  if train is not None else None)
    out = []
    for start in range(0, len(users), batch_size):
        part = slice(start, start + batch_size)
        out.append((users[part], _trimmed(targets[part]),
                    _trimmed(train_rows[part]) if train is not None
                    else None,
                    counts[users][part]))
    return users, targets, train_rows, out


def _on_card_as_cpu(monkeypatch):
    """Make the card's upload a CPU tensor, so that ``_batches`` given a
    ``cuda`` device builds its rows as on a card, on CPU tensors."""
    monkeypatch.setattr(ranking, '_upload',
                        lambda array, device: torch.from_numpy(array))


@pytest.mark.parametrize('case', ROW_CASES)
@pytest.mark.parametrize('device', ['cpu', 'card'])
def test_compact_rows_build_the_padded_rows(monkeypatch, case, device):
    """Each batch's rows from the compact form, built for a CPU model or
    as for a card (on CPU tensors), equal the JAX package's
    ``_padded_rows`` trimmed to the batch exactly: ids, dtype, shape and
    the batch's counts."""
    test, train, batch_size = _row_case(case)
    users_want, targets, train_rows, want = _host_padded_batches(
        test, train, batch_size)
    users, got_targets, got_train = evaluation._eval_rows(test, train)
    np.testing.assert_array_equal(users, users_want)
    assert users.dtype == users_want.dtype
    if device == 'card':
        _on_card_as_cpu(monkeypatch)
    got = list(evaluation._batches(users, got_targets, got_train,
                                   batch_size,
                                   'cuda' if device == 'card' else 'cpu'))
    assert len(got) == len(want)
    for got_batch, want_batch in zip(got, want):
        np.testing.assert_array_equal(got_batch[0], want_batch[0])
        np.testing.assert_array_equal(got_batch[4], want_batch[3])
        assert torch.equal(got_batch[2], got_batch[1] >= 0)
        for got_rows, want_rows in zip(got_batch[1:4:2], want_batch[1:3]):
            if want_rows is None:
                assert got_rows is None
                continue
            assert got_rows.dtype == torch.int64
            assert got_rows.device.type == 'cpu'
            np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    # A call of no users gives the padded form's (0, 1) matrix.
    for rows, padded in ((got_targets, targets), (got_train, train_rows)):
        if rows is None:
            continue
        assert rows.width == padded.shape[1] == _trimmed(padded).shape[1]
        empty = evaluation._Rows(rows.counts[:0], rows.ids[:0])
        built, = evaluation._rows_on([empty], torch.device('cpu'))
        assert built.shape == jax_eval._padded_rows(
            test.tocsr(), np.array([], np.int64)).shape == (0, 1)


def test_row_counters_move_as_documented(monkeypatch):
    """ROWS_BUILT_ON_DEVICE counts the rows built for a card (the targets'
    and the train rows', one a user each) and ROW_UPLOAD_BYTES 8 bytes a
    real id (its id and position as int32); rows built for a CPU model
    count nothing."""
    test, train, batch_size = _row_case(
        'train_rows_where_some_users_have_none')
    users, targets, train_rows = evaluation._eval_rows(test, train)
    _, port, _, _, _, _ = _setup()

    def moved(fn):
        before = (evaluation.ROWS_BUILT_ON_DEVICE,
                  evaluation.ROW_UPLOAD_BYTES)
        fn()
        return (evaluation.ROWS_BUILT_ON_DEVICE - before[0],
                evaluation.ROW_UPLOAD_BYTES - before[1])

    ptest = Interactions(test.user_ids, test.item_ids,
                         num_users=port._num_users, num_items=port._num_items)
    assert moved(lambda: evaluation.mrr_score(port, ptest)) == (0, 0)
    assert moved(lambda: list(evaluation._batches(
        users, targets, None, batch_size, 'cpu'))) == (0, 0)
    _on_card_as_cpu(monkeypatch)
    assert moved(lambda: list(evaluation._batches(
        users, targets, None, batch_size, 'cuda'))) == (
            len(users), 8 * len(targets.ids))
    assert moved(lambda: list(evaluation._batches(
        users, targets, train_rows, batch_size, 'cuda'))) == (
            2 * len(users), 8 * (len(targets.ids) + len(train_rows.ids)))
    assert len(train_rows.ids) < len(targets.ids)


@pytest.mark.parametrize('k', [None, 5, (1, 5, 10)])
@pytest.mark.parametrize('masked', [False, True])
def test_metrics_on_device_built_rows_match_jax(monkeypatch, k, masked):
    """The metrics on rows built by the device builder (on CPU tensors)
    return the host-built rows' arrays exactly, and JAX's."""
    jax_model, port, train, test, ptrain, ptest = _setup()
    kwargs = {'train': ptrain} if masked else {}
    jax_kwargs = {'train': train} if masked else {}
    if k is None:
        metric, jax_metric = evaluation.mrr_score, jax_eval.mrr_score
    else:
        k_arg = list(k) if isinstance(k, tuple) else k
        kwargs['k'] = jax_kwargs['k'] = k_arg
        metric = evaluation.precision_recall_score
        jax_metric = jax_eval.precision_recall_score
    host = metric(port, ptest, batch_size=50, **kwargs)
    original = evaluation._batches
    monkeypatch.setattr(
        evaluation, '_batches',
        lambda users, targets, train_rows, batch_size, device: original(
            users, targets, train_rows, batch_size, 'cuda'))
    _on_card_as_cpu(monkeypatch)
    before = evaluation.ROWS_BUILT_ON_DEVICE
    got = metric(port, ptest, batch_size=50, **kwargs)
    assert evaluation.ROWS_BUILT_ON_DEVICE - before == (
        len(np.unique(ptest.user_ids)) * (2 if masked else 1))
    want = jax_metric(jax_model, test, batch_size=50, **jax_kwargs)
    for got_part, host_part, want_part in zip(
            got if k is not None else (got,),
            host if k is not None else (host,),
            want if k is not None else (want,)):
        np.testing.assert_array_equal(got_part, host_part)
        if k is None:
            np.testing.assert_allclose(got_part, want_part, rtol=MRR_RTOL,
                                       atol=0)
        else:
            np.testing.assert_array_equal(got_part, want_part)


def test_train_correction_matches_jax():
    rs = np.random.RandomState(8)
    batch, num_items = 6, 40
    weights = rs.randint(1, 80, (batch, 3)).astype(np.float32) * 0.5
    targets = rs.randint(0, num_items, (batch, 3))
    target_scores = rs.randint(0, 4, (batch, 3)).astype(np.float32)
    train_rows = rs.randint(-1, num_items, (batch, 5))
    train_rows[:, 0] = targets[:, 0]          # some targets are masked
    train_scores = rs.randint(0, 4, (batch, 5)).astype(np.float32)
    args = (weights, num_items, targets, target_scores, train_rows >= 0,
            np.clip(train_rows, 0, num_items - 1), train_scores)
    got = evaluation._ranks_with_train_correction(
        *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args])
    want = jax_eval._ranks_with_train_correction(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_score_helpers_match_jax():
    rs = np.random.RandomState(2)
    scores = rs.randint(0, 5, (4, 30)).astype(np.float32)
    mask = np.array([[1, 2, -1], [0, -1, -1], [29, 5, 6], [-1, -1, -1]])
    targets = np.array([[3, 1], [4, -1], [7, 8], [0, 2]])
    masked = evaluation._mask_scores(torch.from_numpy(scores),
                                     torch.from_numpy(mask))
    jax_masked = jax_eval._mask_scores(jnp.asarray(scores),
                                       jnp.asarray(mask))
    np.testing.assert_array_equal(masked.numpy(), np.asarray(jax_masked))
    np.testing.assert_array_equal(
        evaluation._reciprocal_ranks(masked, torch.from_numpy(targets),
                                     torch.from_numpy(targets >= 0)).numpy(),
        np.asarray(jax_eval._reciprocal_ranks(
            jax_masked, jnp.asarray(targets), jnp.asarray(targets >= 0))))
    for got, want in zip(
            evaluation._precision_recall_from_topk(
                evaluation._top_items(masked, 10), torch.from_numpy(targets),
                torch.from_numpy(targets >= 0), (1, 3, 10)),
            jax_eval._precision_recall_from_scores(
                jax_masked, jnp.asarray(targets), jnp.asarray(targets >= 0),
                (1, 3, 10))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compact_train_mask_matches_jax():
    top = np.array([[5, 3, 9, 1, 0], [2, 4, 6, 8, 7]])
    train = np.array([[3, 1, -1], [8, -1, -1]])
    got = evaluation._compact_train_mask(torch.from_numpy(top),
                                         torch.from_numpy(train), 3)
    want = jax_eval._compact_train_mask(jnp.asarray(top), jnp.asarray(train),
                                        3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_streaming_mrr_uses_the_bit_matched_target_scores(monkeypatch):
    """The streaming ranks take their target scores from
    matched_target_scores, whose values tie the catalogue pass exactly."""
    _, port, _, _, _, ptest = _setup()
    calls = []
    original = ranking.matched_target_scores

    def spy(*args):
        calls.append(args[3].shape)
        return original(*args)

    monkeypatch.setattr(evaluation, 'matched_target_scores', spy)
    evaluation.mrr_score(port, ptest)
    assert calls and all(len(shape) == 2 for shape in calls)


def test_empty_test_set_shapes():
    """No test interactions: empty results of the JAX package's shapes (one
    column for vector k)."""
    jax_model, port, train, _, _, ptest = _setup()
    empty = Interactions(np.array([], np.int64), np.array([], np.int64),
                         num_users=ptest.num_users, num_items=ptest.num_items)
    from spotlight_tpu.data.interactions import Interactions as JaxInter
    jax_empty = JaxInter(np.array([], np.int64), np.array([], np.int64),
                         num_users=train.num_users, num_items=train.num_items)
    assert (evaluation.mrr_score(port, empty).shape
            == jax_eval.mrr_score(jax_model, jax_empty).shape == (0,))
    for k in ([1, 2, 3], 2):
        got = evaluation.precision_recall_score(port, empty, k=k)
        want = jax_eval.precision_recall_score(jax_model, jax_empty, k=k)
        for got_part, want_part in zip(got, want):
            assert got_part.shape == want_part.shape
