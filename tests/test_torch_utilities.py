"""The port's utilities against the JAX package's.

- ``utils.results.Results``: the same JSONL rows and the same md5 of the
  sorted JSON of a configuration, so either package reads and extends the
  other's log; the committed ML-1M sweep logs give the same best rows.
- ``utils.profiling``: ``ThroughputMeter`` leaves the warm-up steps out as
  JAX's does; ``trace`` writes a Chrome trace on the CPU.
- ``native.markov_walk``: bit-equal to the Python loop and to the JAX
  package's walk; ``generate_sequential`` equals JAX's with the native walk
  and without it.
- Each alias module's names are the very objects of their home modules.
"""

import importlib
import inspect
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from spotlight_tpu import native as jax_native
from spotlight_tpu.data import synthetic as jax_synthetic
from spotlight_tpu.utils import profiling as jax_profiling
from spotlight_tpu.utils.profiling import ThroughputMeter as JaxMeter
from spotlight_tpu.utils.results import Results as JaxResults
from spotlight_tpu_torch import native
from spotlight_tpu_torch.data import synthetic
from spotlight_tpu_torch.utils import profiling
from spotlight_tpu_torch.utils.results import Results

REPO = pathlib.Path(__file__).resolve().parents[1]
SWEEP_LOGS = REPO / 'examples' / 'movielens_sequence' / 'results' / 'ml1m'


# -- results -------------------------------------------------------------------

def test_results_roundtrip(tmp_path):
    results = Results(str(tmp_path / 'sweep.jsonl'))
    config_a = {'lr': 0.01, 'dim': 32}
    config_b = {'lr': 0.1, 'dim': 64}

    assert config_a not in results
    row = results.save(config_a, test_mrr=0.5, elapsed=1.0)
    assert row == dict(config_a, hash=Results._hash(config_a), test_mrr=0.5,
                       elapsed=1.0)
    results.save(config_b, test_mrr=0.7, elapsed=2.0)

    assert config_a in results and {'dim': 32, 'lr': 0.01} in results
    assert results[config_a]['test_mrr'] == 0.5
    assert len(results) == 2
    assert results.best('test_mrr')['lr'] == 0.1
    assert results.best('elapsed', maximize=False)['lr'] == 0.01
    with pytest.raises(KeyError):
        results.best('validation_mrr')
    with pytest.raises(KeyError):
        results[{'lr': 1.0}]

    resumed = Results(str(tmp_path / 'sweep.jsonl'))
    assert config_b in resumed
    resumed.remove(config_a)
    assert config_a not in resumed and config_b in resumed
    assert repr(resumed) == '<Results sweep.jsonl (1 rows)>'


@pytest.mark.parametrize('config', [
    {},
    {'lr': 0.01, 'dim': 32},
    {'dim': 32, 'lr': 0.01},
    {'dilation': (1, 2, 4), 'residual': True, 'l2': 0.0, 'loss': 'bpr'},
    {'nested': {'b': [1, 2], 'a': None}, 'x': 1e-5},
    {'dtype': np.float32, 'n_iter': 12},
])
def test_results_hash_equals_jax(config):
    assert Results._hash(config) == JaxResults._hash(config)


def test_one_log_for_both_packages(tmp_path):
    path = str(tmp_path / 'shared.jsonl')
    port, jax_log = Results(path), JaxResults(path)
    port.save({'lr': 0.1, 'dilation': (1, 2)}, test_mrr=0.2)
    jax_log.save({'lr': 0.2, 'dilation': (1,)}, test_mrr=0.3)
    assert {'dilation': (1, 2), 'lr': 0.1} in jax_log
    assert {'lr': 0.2, 'dilation': (1,)} in port
    assert list(port) == list(jax_log)
    assert port.best('test_mrr') == jax_log.best('test_mrr')
    lines = (tmp_path / 'shared.jsonl').read_text().splitlines()
    assert [json.loads(line)['hash'] for line in lines] == [
        row['hash'] for row in jax_log]


@pytest.mark.parametrize('representation', ['cnn', 'pooling', 'lstm',
                                            'mixture'])
@pytest.mark.parametrize('key', ['validation_mrr', 'test_mrr'])
def test_committed_sweep_logs_read_as_jax(representation, key):
    path = str(SWEEP_LOGS / '{}_results.jsonl'.format(representation))
    before = pathlib.Path(path).read_bytes()
    port, jax_log = Results(path), JaxResults(path)
    assert len(port) == len(jax_log) == 100
    assert port.best(key) == jax_log.best(key)
    best = port.best(key)
    hyperparameters = {name: value for name, value in best.items()
                       if name not in ('hash', 'validation_mrr', 'test_mrr',
                                       'elapsed')}
    assert Results._hash(hyperparameters) == best['hash']
    assert hyperparameters in port
    assert pathlib.Path(path).read_bytes() == before


# -- profiling -----------------------------------------------------------------

def test_throughput_meter_excludes_warmup():
    meters = (profiling.ThroughputMeter(warmup_steps=1), JaxMeter(1))
    for meter in meters:
        for seconds in (0.3, 0.01, 0.01):
            with meter.step(100):
                time.sleep(seconds)
        assert meter.measured_steps == 2
        # The 0.3 s warm-up step is left out of the two measured ones.
        assert 0.02 <= meter._elapsed < 0.3
        assert meter.examples_per_second() == pytest.approx(
            200 / meter._elapsed)
        assert meter.examples_per_second(num_chips=2) == pytest.approx(
            meter.examples_per_second() / 2)


def test_throughput_meter_before_any_measured_step():
    meter = profiling.ThroughputMeter(warmup_steps=2, device='cpu')
    with meter.step(10):
        pass
    assert meter.measured_steps == 0
    assert meter.examples_per_second() == 0.0


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / 'trace'
    x = torch.randn(64, 64)
    with profiling.trace(str(log_dir), device='cpu') as traced:
        for _ in range(3):
            x = torch.tanh(x @ x)
    assert traced == str(log_dir)
    names = {event.key for event in traced.profiler.key_averages()}
    assert {'aten::mm', 'aten::tanh'} <= names
    events = json.loads((log_dir / 'trace.json').read_text())['traceEvents']
    assert sum(event.get('name') == 'aten::mm' for event in events) == 3


def test_trace_defaults_and_yield_match_jax():
    """JAX's ``trace`` defaults to /tmp/spotlight_tpu_trace and yields its
    directory; so does the port's (a ``str``, with the profiler beside)."""
    want = inspect.signature(jax_profiling.trace).parameters['log_dir']
    got = inspect.signature(profiling.trace).parameters['log_dir']
    assert got.default == want.default == '/tmp/spotlight_tpu_trace'
    assert issubclass(profiling.TraceDir, str)


def test_trace_is_written_when_the_block_raises(tmp_path):
    log_dir = tmp_path / 'raised'
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(log_dir), device='cpu') as traced:
            torch.tanh(torch.ones(8, 8) @ torch.ones(8, 8))
            raise ZeroDivisionError
    events = json.loads((log_dir / 'trace.json').read_text())['traceEvents']
    assert any(event.get('name') == 'aten::mm' for event in events)
    assert traced.profiler is not None


# -- native ----------------------------------------------------------------------

def _python_walk(cumulative, rvs, state):
    state, out = state.copy(), np.empty(len(rvs), dtype=np.int32)
    for step, rv in enumerate(rvs):
        row = cumulative[state].mean(axis=0)
        state[:-1] = state[1:]
        state[-1] = min(len(cumulative) - 1, int(np.searchsorted(row, rv)))
        out[step] = state[-1]
    return out


@pytest.mark.parametrize('order', [1, 3])
def test_markov_walk_bit_equal_to_python_and_jax(order):
    assert native.load() is not None
    transition = synthetic._build_transition_matrix(
        200, 0.05, np.random.RandomState(42))
    cumulative = np.cumsum(transition, axis=1)
    rvs = np.random.RandomState(1).rand(5000)
    state = np.random.RandomState(2).randint(200, size=order).astype(
        np.int64)
    got = native.markov_walk(cumulative, rvs, state)
    np.testing.assert_array_equal(state, np.random.RandomState(2).randint(
        200, size=order))
    np.testing.assert_array_equal(got, _python_walk(cumulative, rvs, state))
    np.testing.assert_array_equal(
        got, jax_native.markov_walk(cumulative, rvs, state.copy()))
    assert got.dtype == np.int32


def test_markov_walk_checks_its_operands():
    cumulative = np.cumsum(np.full((4, 4), 0.25), axis=1)
    with pytest.raises(ValueError):
        native.markov_walk(cumulative, np.zeros(3), np.array([4]))
    with pytest.raises(ValueError):
        native.markov_walk(cumulative[:3], np.zeros(3), np.array([0]))
    with pytest.raises(ValueError):
        native.markov_walk(cumulative, np.zeros(3), np.array([0]),
                           out=np.empty(3, dtype=np.int64))


def test_native_builds_outside_the_sources():
    assert native.load() is not None
    path = native.library_path()
    assert path.parent == REPO / 'build' / 'native'
    assert path.exists()
    assert not list(native.SOURCE.parent.glob('*.so'))


@pytest.mark.parametrize('order', [1, 3])
def test_generate_sequential_equals_jax_either_way(order, monkeypatch):
    kwargs = dict(num_users=20, num_items=50, num_interactions=500,
                  order=order)
    want = jax_synthetic.generate_sequential(
        random_state=np.random.RandomState(5), **kwargs)
    got = synthetic.generate_sequential(
        random_state=np.random.RandomState(5), **kwargs)
    monkeypatch.setattr(native, 'markov_walk', lambda *args: None)
    looped = synthetic.generate_sequential(
        random_state=np.random.RandomState(5), **kwargs)
    for data in (got, looped):
        np.testing.assert_array_equal(data.item_ids, want.item_ids)
        np.testing.assert_array_equal(data.user_ids, want.user_ids)
        assert data.item_ids.dtype == want.item_ids.dtype


def test_without_a_compiler_the_walk_is_none(monkeypatch, tmp_path):
    """JAX's contract: no library, ``markov_walk`` returns None and the
    generator runs its loop, with the same result."""
    def no_compiler(*args, **kwargs):
        raise FileNotFoundError('g++')

    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_build_failed', False)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'native')
    monkeypatch.setattr(native.subprocess, 'run', no_compiler)
    assert native.load() is None
    assert native.markov_walk(np.ones((2, 2)), np.zeros(3),
                              np.array([0])) is None
    got = synthetic.generate_sequential(
        num_users=10, num_items=30, num_interactions=200,
        random_state=np.random.RandomState(9))
    want = jax_synthetic.generate_sequential(
        num_users=10, num_items=30, num_interactions=200,
        random_state=np.random.RandomState(9))
    np.testing.assert_array_equal(got.item_ids, want.item_ids)


# -- alias modules -------------------------------------------------------------

ALIASES = {
    'interactions': ['data.interactions'],
    'cross_validation': ['data.cross_validation'],
    'layers': ['ops.embeddings', 'ops.hashing'],
    'losses': ['ops.losses'],
    'sampling': ['ops.sampling'],
    'ops': ['ops.embeddings', 'ops.losses', 'ops.sampling'],
    'sequence': ['sequence.implicit', 'sequence.representations'],
    'datasets.movielens': ['data.movielens'],
    'datasets.amazon': ['data.amazon'],
    'datasets.goodbooks': ['data.goodbooks'],
    'datasets.synthetic': ['data.synthetic'],
}


def _public(module):
    return {name for name in vars(module) if not name.startswith('_')
            and not isinstance(getattr(module, name), type(importlib))}


@pytest.mark.parametrize('alias', sorted(ALIASES))
def test_alias_names_are_their_homes_objects(alias):
    module = importlib.import_module('spotlight_tpu_torch.' + alias)
    jax_module = importlib.import_module('spotlight_tpu.' + alias)
    homes = [importlib.import_module('spotlight_tpu_torch.' + home)
             for home in ALIASES[alias]]
    names = _public(jax_module) - {'annotations'}
    assert names and names <= _public(module)
    for name in names:
        home = next(h for h in homes if hasattr(h, name))
        assert getattr(module, name) is getattr(home, name), name
