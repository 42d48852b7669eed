"""Explicit matrix factorization in the port against the JAX package's.

A JAX ``ExplicitFactorizationModel`` trains one epoch to reach a warm state;
its parameters and optimizer state go through ``params_from_jax`` and
``opt_state_from_jax`` into the port.  Then both packages take the same next
epoch, the port handed JAX's own permutation (an explicit epoch draws no
negatives), reproduced from the JAX epoch key as the JAX engines split it.
One batch (with padding rows) is one step; it is held at the tolerances of
the implicit engines (``tests/test_torch_training.py``): moments within
``MOMENT_SCALE`` = 1e-6 of each table's largest, parameters to atol 1e-6,
the loss to rtol 1e-6.  A whole epoch of three batches agrees to 1e-5.
``predict`` (with the poisson model's ``exp`` and the logistic model's
sigmoid) and ``rmse_score`` agree to 1e-6 on the same parameters.

Whole fits draw from different generators, so the port is held to the JAX
package's learning gates instead: ``tests/factorization/test_explicit.py``
on the synthetic explicit data, and ``tests/test_ml100k_gates.py`` on the
ML-100K stand-in of the port's own ``data.fixtures`` (bit-equal to the JAX
package's) in the port's ``Interactions``.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.data import Interactions as JaxInteractions
from spotlight_tpu.evaluation import rmse_score as jax_rmse_score
from spotlight_tpu.factorization import (
    ExplicitFactorizationModel as JaxExplicitModel)
from spotlight_tpu.factorization.representations import (
    BilinearNet as JaxBilinearNet)
from spotlight_tpu_torch.data import (Interactions, fixtures,
                                      random_train_test_split)
from spotlight_tpu_torch.data.synthetic import generate_factorization
from spotlight_tpu_torch.evaluation import rmse_score
from spotlight_tpu_torch.factorization import (BilinearNet,
                                               ExplicitFactorizationModel)
from spotlight_tpu_torch.utils import training
from spotlight_tpu_torch.utils.convert import (opt_state_from_jax,
                                               params_from_jax)

LOSSES = ('regression', 'poisson', 'logistic')
NUM_USERS, NUM_ITEMS, DIM, BATCH = 40, 30, 8, 64
MOMENT_SCALE, PARAM_ATOL, LOSS_RTOL, EPOCH_ATOL = 1e-6, 1e-6, 1e-6, 1e-5
PREDICT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Many small ops: on one thread each, they do not wait on the other
    test workers' threads for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_port(interactions):
    return Interactions(interactions.user_ids, interactions.item_ids,
                        ratings=interactions.ratings,
                        timestamps=interactions.timestamps,
                        num_users=interactions.num_users,
                        num_items=interactions.num_items)


def ratings_for(loss, n, rs):
    """Ratings the loss takes: 1-5 stars, or +-1 for the logistic loss."""
    if loss == 'logistic':
        return np.where(rs.rand(n) < 0.6, 1.0, -1.0).astype(np.float32)
    return rs.randint(1, 6, n).astype(np.float32)


def dataset(loss, n, seed=0):
    rs = np.random.RandomState(seed)
    users = rs.randint(0, NUM_USERS, n).astype(np.int32)
    items = rs.randint(0, NUM_ITEMS, n).astype(np.int32)
    return JaxInteractions(users, items, ratings=ratings_for(loss, n, rs),
                           num_users=NUM_USERS, num_items=NUM_ITEMS)


def jax_perm(key, num_batches):
    """The permutation ``fit`` derives from the model's key: ``_next_key``'s
    subkey, split as the JAX engines split it (``utils/training.epoch_scan``
    and ``factorization/lazy.py``: a permutation key and a negatives key
    that an explicit epoch does not use)."""
    _, subkey = jax.random.split(key)
    perm_key, _ = jax.random.split(subkey)
    perm = jax.random.permutation(perm_key, num_batches * BATCH)
    return torch.from_numpy(np.asarray(perm).astype(np.int64))


def tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def models(loss, sparse, table='float32', l2=1e-6):
    kwargs = dict(loss=loss, embedding_dim=DIM, n_iter=1, batch_size=BATCH,
                  l2=l2, sparse=sparse)
    jax_rep = port_rep = None
    if table != 'float32':
        jax_rep = JaxBilinearNet(NUM_USERS, NUM_ITEMS, DIM,
                                 table_dtype=jnp.bfloat16)
        port_rep = BilinearNet(NUM_USERS, NUM_ITEMS, DIM,
                               table_dtype=torch.bfloat16)
    jax_model = JaxExplicitModel(representation=jax_rep,
                                 random_state=np.random.RandomState(42),
                                 **kwargs)
    port = ExplicitFactorizationModel(representation=port_rep,
                                      random_state=np.random.RandomState(42),
                                      device='cpu', **kwargs)
    return jax_model, port


def compare_epoch(loss, sparse, n, table='float32', l2=1e-6):
    """Warm both models, run one more JAX epoch and the same epoch in the
    port; returns (jax_model, port, port epoch loss)."""
    jax_data = dataset(loss, n)
    jax_model, port = models(loss, sparse, table, l2)
    jax_model.fit(jax_data)
    port_data = to_port(jax_data)
    port._initialize(port_data)
    assert port._lazy == jax_model._lazy == sparse
    port._load_params(params_from_jax(port._net, tree(jax_model._params)))
    port._opt_state = opt_state_from_jax(port._net,
                                         tree(jax_model._opt_state))

    key = jax_model._key
    jax_model.fit(jax_data)
    data, n_valid, num_batches = port._epoch_data(port_data)
    perm = jax_perm(key, num_batches)
    epoch_loss = training.run_epoch(port._step_fn(), data, n_valid,
                                    num_batches, BATCH, perm)
    return jax_model, port, float(epoch_loss)


def assert_state_close(jax_model, port, param_atol):
    params = tree(jax_model._params)
    state = port._net.state_dict()
    for name in ('user_embeddings', 'item_embeddings'):
        np.testing.assert_allclose(
            state[name + '.weight'].float().numpy(),
            np.asarray(params[name]['weight'], np.float32), rtol=0,
            atol=param_atol, err_msg=name)
    want = opt_state_from_jax(port._net, tree(jax_model._opt_state))
    step_key = 't' if port._lazy else 'count'
    assert port._opt_state[step_key] == want[step_key]
    for moment in ('mu', 'nu'):
        for name, value in want[moment].items():
            want_moment = value.float().numpy()
            np.testing.assert_allclose(
                port._opt_state[moment][name].float().numpy(), want_moment,
                rtol=0, atol=MOMENT_SCALE * np.abs(want_moment).max(),
                err_msg='{} {}'.format(moment, name))


@pytest.mark.parametrize('sparse', [True, False], ids=['lazy', 'dense'])
@pytest.mark.parametrize('loss', LOSSES)
def test_one_step_matches_jax(loss, sparse):
    """One batch of 59 examples and 5 padding rows."""
    jax_model, port, epoch_loss = compare_epoch(loss, sparse, BATCH - 5)
    assert_state_close(jax_model, port, PARAM_ATOL)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize('sparse', [True, False], ids=['lazy', 'dense'])
def test_one_step_with_a_bfloat16_table_matches_jax(sparse):
    jax_model, port, epoch_loss = compare_epoch('poisson', sparse, BATCH - 5,
                                                table='bfloat16')
    assert port._net.user_embeddings.weight.dtype == torch.bfloat16
    assert_state_close(jax_model, port, PARAM_ATOL)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize('loss, sparse', [('regression', True),
                                          ('poisson', False),
                                          ('logistic', True)])
def test_one_epoch_of_three_batches_matches_jax(loss, sparse):
    jax_model, port, epoch_loss = compare_epoch(loss, sparse, 3 * BATCH - 7,
                                                l2=0.0)
    assert_state_close(jax_model, port, EPOCH_ATOL)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=EPOCH_ATOL)


@pytest.mark.parametrize('loss', LOSSES)
def test_predict_and_rmse_match_jax(loss):
    """On the JAX model's trained parameters: pair predictions, a user's
    catalogue and ``rmse_score`` (float32, as JAX computes it)."""
    jax_data = dataset(loss, 500, seed=1)
    jax_model, port = models(loss, False)
    jax_model._n_iter = 3
    jax_model.fit(jax_data)
    port._initialize(to_port(jax_data))
    port._load_params(params_from_jax(port._net, tree(jax_model._params)))
    test = dataset(loss, 200, seed=2)
    got = port.predict(test.user_ids, test.item_ids)
    want = jax_model.predict(test.user_ids, test.item_ids)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=PREDICT_RTOL, atol=1e-7)
    np.testing.assert_allclose(port.predict(3), jax_model.predict(3),
                               rtol=PREDICT_RTOL, atol=1e-7)
    if loss == 'poisson':
        assert (got > 0).all()
    if loss == 'logistic':
        assert ((got >= 0) & (got <= 1)).all()
    got_rmse, want_rmse = rmse_score(port, to_port(test)), jax_rmse_score(
        jax_model, test)
    assert np.asarray(got_rmse).dtype == np.float32
    np.testing.assert_allclose(got_rmse, want_rmse, rtol=PREDICT_RTOL)


# -- the JAX package's learning gates -----------------------------------------

@functools.lru_cache(maxsize=None)
def gate_data():
    """``tests/factorization/test_explicit.py``'s data."""
    interactions = generate_factorization(
        600, 400, 30000, rank=8, noise=0.15, explicit=True,
        random_state=np.random.RandomState(42))
    return random_train_test_split(interactions,
                                   random_state=np.random.RandomState(0))


def mean_baseline(train, test):
    return np.sqrt(((test.ratings - train.ratings.mean()) ** 2).mean())


def gate_model(loss, learning_rate, sparse=False):
    return ExplicitFactorizationModel(
        loss=loss, embedding_dim=32, n_iter=10, batch_size=1024,
        learning_rate=learning_rate, l2=1e-6, sparse=sparse,
        random_state=np.random.RandomState(42), device='cpu')


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'lazy'])
def test_regression_gate(sparse):
    """``test_explicit.py:24``: RMSE < 0.85 and below 0.65 of the mean
    baseline's; both engines."""
    train, test = gate_data()
    model = gate_model('regression', 1e-2, sparse).fit(train)
    assert model._lazy == sparse
    rmse = rmse_score(model, test)
    assert rmse < 0.85
    assert rmse < mean_baseline(train, test) * 0.65


def test_poisson_gate():
    """``test_explicit.py:40``: below the mean baseline, with positive
    predictions."""
    train, test = gate_data()
    model = gate_model('poisson', 1e-3).fit(train)
    assert rmse_score(model, test) < mean_baseline(train, test)
    assert (model.predict(0) > 0).all()


def signs(interactions):
    return Interactions(
        interactions.user_ids, interactions.item_ids,
        ratings=np.where(interactions.ratings >= 3, 1.0, -1.0).astype(
            np.float32),
        timestamps=interactions.timestamps,
        num_users=interactions.num_users, num_items=interactions.num_items)


def test_logistic_gate():
    """``test_explicit.py:56``: probabilities, and accuracy above the base
    rate + 0.03."""
    train, test = (signs(part) for part in gate_data())
    model = gate_model('logistic', 1e-2).fit(train)
    predictions = model.predict(test.user_ids, test.item_ids)
    assert ((predictions >= 0) & (predictions <= 1)).all()
    accuracy = ((predictions > 0.5) == (test.ratings > 0)).mean()
    base_rate = max((train.ratings > 0).mean(),
                    1 - (train.ratings > 0).mean())
    assert accuracy > base_rate + 0.03


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'lazy'])
def test_degenerate_loss_raises(sparse):
    """``test_explicit.py:85``: at lr 1e12 the loss degenerates within 30
    resumed fits."""
    train, _ = gate_data()
    model = ExplicitFactorizationModel(
        n_iter=1, learning_rate=1e12, sparse=sparse,
        random_state=np.random.RandomState(42), device='cpu')
    with pytest.raises(ValueError, match='Degenerate epoch loss'):
        for _ in range(30):
            model.fit(train)


# -- the ML-100K stand-in -------------------------------------------------------

EPSILON = 0.005


@functools.lru_cache(maxsize=None)
def ml100k():
    """The port's ML-100K stand-in, its columns as
    ``get_movielens_dataset('100K')`` hands them to ``Interactions``."""
    columns = fixtures.generate_movielens_100k_like()
    return Interactions(columns['user_id'], columns['item_id'],
                        ratings=columns['rating'],
                        timestamps=columns['timestamp'])


def test_ml100k_stand_in_is_the_jax_loaders(tmp_path, monkeypatch):
    """The conversion equals what the JAX loader reads back from the
    fixture the port installed."""
    from spotlight_tpu.data.movielens import get_movielens_dataset

    fixtures.install_movielens_100k_fixture(data_directory=str(tmp_path))
    monkeypatch.setenv('SPOTLIGHT_DATA_DIR', str(tmp_path))
    want = get_movielens_dataset('100K')
    got = ml100k()
    for field in ('user_ids', 'item_ids', 'ratings', 'timestamps'):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (got.num_users, got.num_items) == (want.num_users,
                                              want.num_items)


def ml100k_split(interactions):
    return random_train_test_split(interactions,
                                   random_state=np.random.RandomState(42))


def ml100k_rmse(loss, train, test, l2):
    model = ExplicitFactorizationModel(
        loss=loss, n_iter=10, batch_size=1024, learning_rate=1e-3, l2=l2,
        random_state=np.random.RandomState(42), device='cpu').fit(train)
    return rmse_score(model, test)


@pytest.mark.parametrize('loss, l2', [('regression', 1e-5),
                                      ('poisson', 1e-6)])
def test_ml100k_gates(loss, l2):
    """``tests/test_ml100k_gates.py:125`` and ``:135``: RMSE - 0.005 < 1.0."""
    rmse = ml100k_rmse(loss, *ml100k_split(ml100k()), l2)
    assert rmse - EPSILON < 1.0, rmse


def test_ml100k_logistic_gate():
    """``tests/test_ml100k_gates.py:145``: ratings above 3 as +1, the rest
    as -1; RMSE - 0.005 < 1.05."""
    data = ml100k()
    binary = Interactions(
        data.user_ids, data.item_ids,
        ratings=(data.ratings > 3).astype(np.float32) * 2 - 1,
        timestamps=data.timestamps,
        num_users=data.num_users, num_items=data.num_items)
    rmse = ml100k_rmse('logistic', *ml100k_split(binary), 1e-6)
    assert rmse - EPSILON < 1.05, rmse


# -- the estimator ----------------------------------------------------------------

@pytest.mark.parametrize('sparse', [True, False], ids=['lazy', 'dense'])
def test_repeated_fit_resumes(sparse):
    """A second ``fit`` continues from the state (parameters, moments, step
    count and the random stream); a new model would not."""
    train, _ = gate_data()

    def model():
        return ExplicitFactorizationModel(
            n_iter=1, batch_size=4096, sparse=sparse,
            random_state=np.random.RandomState(9), device='cpu')

    resumed = model().fit(train).fit(train)
    fresh = model().fit(train)
    twice = model()
    twice._n_iter = 2
    twice.fit(train)
    step = 't' if sparse else 'count'
    assert resumed._opt_state[step] == twice._opt_state[step] == 12
    for name, value in resumed._net.state_dict().items():
        assert torch.equal(value, twice._net.state_dict()[name])
        assert not torch.equal(value, fresh._net.state_dict()[name])


def test_sparse_with_a_custom_optimizer_warns_and_trains_dense():
    train, _ = gate_data()
    model = ExplicitFactorizationModel(
        n_iter=1, batch_size=4096, sparse=True,
        optimizer_func=lambda: training.Adam(1e-2),
        random_state=np.random.RandomState(0), device='cpu')
    with pytest.warns(RuntimeWarning,
                      match='sparse=True falls back to the dense engine'):
        model.fit(train)
    assert not model._lazy and model._opt_state['count'] == 6


@pytest.mark.parametrize('kwargs', [
    {'loss': 'bpr'},
    {'mesh': SimpleNamespace(shape={'data': 3, 'model': 1}, device='cpu')}])
def test_constructor_refusals(kwargs):
    """An unknown loss, and a batch size that the mesh's data axis does not
    divide (256 over 3), raise as the JAX package's do."""
    with pytest.raises(ValueError):
        ExplicitFactorizationModel(device='cpu', **kwargs)


def test_fit_needs_ratings():
    train, _ = gate_data()
    unrated = Interactions(train.user_ids, train.item_ids,
                           num_users=train.num_users,
                           num_items=train.num_items)
    with pytest.raises(ValueError, match='ratings'):
        ExplicitFactorizationModel(device='cpu').fit(unrated)
