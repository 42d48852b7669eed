"""The port's dataset loaders and fixtures against the JAX package's.

- The four fixture generators give the JAX package's columns bit for bit
  for the same seed (one ML-1M generation a package, shared by the module).
- Each loader reads an installed fixture from a temporary
  ``SPOTLIGHT_DATA_DIR`` into the same ``Interactions`` as the JAX loader
  reads from the same file, field by field; installers never overwrite.
- A cache miss raises ``IOError`` (no download); an unknown variant
  ``ValueError``.
- Every module of the port imports with ``h5py``, ``requests`` and
  ``sklearn`` unimportable.
- The ML-1M sweep's data (``chip_smoke.py`` phase 14): the loader's and the
  columns' routes give equal ``Interactions``, and the sweep's two
  user-based splits and ``to_sequence`` equal JAX's.
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from spotlight_tpu.data import amazon as jax_amazon
from spotlight_tpu.data import cross_validation as jax_cv
from spotlight_tpu.data import fixtures as jax_fixtures
from spotlight_tpu.data import goodbooks as jax_goodbooks
from spotlight_tpu.data import movielens as jax_movielens
from spotlight_tpu_torch.data import (amazon, fixtures, goodbooks, movielens,
                                      transport)

PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / 'spotlight_tpu_torch'
_FIELDS = ('user_ids', 'item_ids', 'ratings', 'timestamps', 'weights')


@functools.lru_cache(maxsize=None)
def ml1m(package):
    """One ML-1M generation a package for the module."""
    module = fixtures if package == 'port' else jax_fixtures
    return module.generate_movielens_1m_like()


def _assert_same_interactions(got, want):
    assert type(got).__module__.startswith('spotlight_tpu_torch.')
    assert (got.num_users, got.num_items) == (want.num_users, want.num_items)
    for name in _FIELDS:
        got_field, want_field = getattr(got, name), getattr(want, name)
        if want_field is None:
            assert got_field is None, name
        else:
            np.testing.assert_array_equal(got_field, want_field)
            assert got_field.dtype == want_field.dtype, name


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv('SPOTLIGHT_DATA_DIR', str(tmp_path))
    return tmp_path


# -- generators ------------------------------------------------------------------

@pytest.mark.parametrize('name', ['generate_movielens_100k_like',
                                  'generate_amazon_like'])
def test_column_generators_equal_jax(name):
    got, want = getattr(fixtures, name)(), getattr(jax_fixtures, name)()
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype, key


def test_ml1m_generator_equals_jax():
    got, want = ml1m('port'), ml1m('jax')
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype, key
    assert len(got['user_id']) == fixtures.ML1M_NUM_RATINGS


@pytest.mark.parametrize('seed', [None, 7])
def test_goodbooks_generator_equals_jax(seed):
    kwargs = {} if seed is None else {'seed': seed}
    got = fixtures.generate_goodbooks_like(**kwargs)
    want = jax_fixtures.generate_goodbooks_like(**kwargs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_constants_equal_jax():
    names = [name for name in vars(jax_fixtures) if name.isupper()]
    assert len(names) == 22
    for name in names:
        assert getattr(fixtures, name) == getattr(jax_fixtures, name), name


# -- loaders ---------------------------------------------------------------------

LOADERS = {
    'movielens 100K': (
        lambda: fixtures.install_movielens_100k_fixture(),
        lambda: movielens.get_movielens_dataset('100K'),
        lambda: jax_movielens.get_movielens_dataset('100K')),
    'movielens 1M': (
        lambda: fixtures.install_movielens_1m_fixture(columns=ml1m('port')),
        lambda: movielens.get_movielens_dataset('1M'),
        lambda: jax_movielens.get_movielens_dataset('1M')),
    'amazon': (
        lambda: fixtures.install_amazon_fixture(),
        lambda: amazon.get_amazon_dataset(),
        lambda: jax_amazon.get_amazon_dataset()),
    'amazon 3/20': (
        lambda: fixtures.install_amazon_fixture(),
        lambda: amazon.get_amazon_dataset(3, 20),
        lambda: jax_amazon.get_amazon_dataset(3, 20)),
    'goodbooks': (
        lambda: fixtures.install_goodbooks_fixture(),
        lambda: goodbooks.get_goodbooks_dataset(),
        lambda: jax_goodbooks.get_goodbooks_dataset()),
}


@pytest.mark.parametrize('name', sorted(LOADERS))
def test_loader_equals_jax_from_the_same_file(name, data_dir):
    install, load, jax_load = LOADERS[name]
    path = install()
    assert pathlib.Path(path).is_relative_to(data_dir)
    assert fixtures.is_synthetic_fixture(path)
    _assert_same_interactions(load(), jax_load())


def test_amazon_filters_and_remaps(data_dir):
    fixtures.install_amazon_fixture()
    got = amazon.get_amazon_dataset()
    raw = fixtures.generate_amazon_like()
    assert got.num_users < len(np.unique(raw['user_id']))
    assert got.num_items < len(np.unique(raw['item_id']))
    # Contiguous ids from 1; 0 stays free.
    assert got.user_ids.min() == 1 and got.item_ids.min() == 1
    assert got.num_users == got.user_ids.max() + 1
    assert got.num_items == got.item_ids.max() + 1
    assert np.bincount(got.user_ids)[1:].min() > 0


@pytest.mark.parametrize('install', [
    fixtures.install_movielens_100k_fixture,
    fixtures.install_amazon_fixture,
    fixtures.install_goodbooks_fixture])
def test_installers_never_overwrite(install, data_dir):
    path = install()
    stamp = os.stat(path).st_mtime_ns
    assert install(seed=1) == path
    assert os.stat(path).st_mtime_ns == stamp
    # The JAX installer finds the port's file at its own path, and keeps it.
    jax_install = getattr(jax_fixtures, install.__name__)
    assert jax_install() == path
    assert os.stat(path).st_mtime_ns == stamp


def test_ml1m_installer_takes_given_columns(tmp_path):
    columns = {key: value[:1000] for key, value in ml1m('port').items()}
    path = fixtures.install_movielens_1m_fixture(
        data_directory=str(tmp_path), columns=columns)
    assert path == os.path.join(str(tmp_path), 'movielens', 'v0.2.0',
                                'movielens_movielens_1M.hdf5')
    assert fixtures.install_movielens_1m_fixture(
        data_directory=str(tmp_path)) == path
    import h5py
    with h5py.File(path, 'r') as f:
        np.testing.assert_array_equal(f['/item_id'][:], columns['item_id'])
        assert f.attrs['generator_seed'] == fixtures.ML1M_SEED


def test_cache_miss_raises_ioerror(data_dir):
    with pytest.raises(IOError, match='Dataset missing'):
        transport.get_data('never-fetched', 'movielens', 'none.hdf5',
                           download_if_missing=False)
    assert (data_dir / 'movielens').is_dir()


def test_data_dir_honours_the_environment(data_dir, monkeypatch):
    assert transport.data_dir() == str(data_dir)
    monkeypatch.delenv('SPOTLIGHT_DATA_DIR')
    assert transport.data_dir() == os.path.join(
        os.path.expanduser('~'), 'spotlight_data')


@pytest.mark.parametrize('variant', ['100k', '2M', ''])
def test_unknown_variant_raises(variant, data_dir):
    with pytest.raises(ValueError, match='Variant must be one of'):
        movielens.get_movielens_dataset(variant)
    with pytest.raises(ValueError, match='Variant must be one of'):
        jax_movielens.get_movielens_dataset(variant)
    assert movielens.VARIANTS == jax_movielens.VARIANTS


def _port_modules():
    return sorted('.'.join(path.relative_to(PORT_ROOT.parent)
                           .with_suffix('').parts).replace('.__init__', '')
                  for path in PORT_ROOT.rglob('*.py'))


def test_port_imports_without_h5py_requests_sklearn():
    code = ('import importlib, sys\n'
            'for blocked in ("h5py", "requests", "sklearn", "jax",\n'
            '                "spotlight_tpu"):\n'
            '    sys.modules[blocked] = None\n'
            'for name in {!r}:\n'
            '    importlib.import_module(name)\n'
            'print("ok")\n').format(_port_modules())
    result = subprocess.run([sys.executable, '-c', code],
                            cwd=PORT_ROOT.parent, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == 'ok'


# -- the ML-1M sweep's data (chip_smoke.py phase 14) ------------------------------

def test_ml1m_routes_give_equal_interactions(tmp_path, monkeypatch):
    columns = ml1m('port')
    via_loader, route = chip_smoke.ml1m_interactions(columns, str(tmp_path))
    assert route == 'get_movielens_dataset'
    monkeypatch.setitem(sys.modules, 'h5py', None)
    via_columns, route = chip_smoke.ml1m_interactions(columns, str(tmp_path))
    assert route == 'columns'
    _assert_same_interactions(via_columns, via_loader)
    assert via_loader.num_items == fixtures.ML1M_NUM_ITEMS + 1


def test_ml1m_sweep_splits_and_sequences_equal_jax():
    """``movielens_sequence.py``'s ``load_data`` on the ML-1M stand-in:
    two user-based splits of 0.2 from ``RandomState(42)``, then
    ``to_sequence(200, 20, step 200)``."""
    from spotlight_tpu.data.interactions import Interactions as JaxInteractions

    columns = ml1m('port')
    got = chip_smoke.ml1m_sequences(
        chip_smoke.ml1m_interactions_from_columns(columns))
    data = JaxInteractions(columns['user_id'], columns['item_id'],
                           ratings=columns['rating'],
                           timestamps=columns['timestamp'])
    random_state = np.random.RandomState(42)
    rest, test = jax_cv.user_based_train_test_split(
        data, test_percentage=0.2, random_state=random_state)
    train, validation = jax_cv.user_based_train_test_split(
        rest, test_percentage=0.2, random_state=random_state)
    kwargs = dict(max_sequence_length=200, min_sequence_length=20,
                  step_size=200)
    want = [part.to_sequence(**kwargs) for part in (train, validation, test)]
    for got_part, want_part in zip(got, want):
        np.testing.assert_array_equal(got_part.sequences, want_part.sequences)
        np.testing.assert_array_equal(got_part.user_ids, want_part.user_ids)
        assert got_part.num_items == want_part.num_items == 3707
    assert [len(part.sequences) for part in got] == [5139, 1287, 1637]
