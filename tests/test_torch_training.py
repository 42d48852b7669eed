"""Training in the port against the JAX package, on the CPU.

A JAX ``ImplicitFactorizationModel`` trains one epoch to reach a warm state
(moments non-zero, step count past 1); its parameters and optimizer state go
through ``params_from_jax`` and ``opt_state_from_jax`` into the port.  Then
both packages take the same next epoch: the port is handed JAX's own
permutation and negatives, reproduced from the JAX epoch key exactly as the
JAX engines split it.  One batch (with padding rows) is one step.

The moments cannot equal JAX's bit for bit here, although P1 computes them
in JAX's order (``tests/test_torch_row_update.py`` holds them equal on
equal gradients): the gradients come out of autograd, which sums the
batch's terms in another order than XLA, and a gradient that is a
difference of near-equal terms can differ by hundreds of ulps of itself
(up to 7,626 ulps of one ``mu`` element in these cases).  Measured against
the table's largest moment, the gap is at most 2.2e-7 (about two ulps of
it; ``python -m tests.torch_moment_gaps`` prints the gaps case by case):
moments are held within ``MOMENT_SCALE`` = 1e-6 of each table's
largest ``mu`` and ``nu``, so a ``nu`` of 1e-9 is held at 1e-15, not at a
fixed atol that would pass any value.  Parameters agree to atol 1e-6
(XLA's CPU float32 ``sqrt`` is not correctly rounded, and Adam's
normalisation magnifies the gradients' gaps), the loss to rtol 1e-6.  A
whole epoch of three batches agrees to atol 1e-5 on parameters and loss.

The packages draw from different generators (threefry against torch's), so
whole fits cannot match; the port is held to the JAX package's learning
gates instead.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.data import random_train_test_split as jax_split
from spotlight_tpu.data.synthetic import (
    generate_factorization as jax_generate_factorization)
from spotlight_tpu.factorization import (
    ImplicitFactorizationModel as JaxImplicitModel)
from spotlight_tpu.factorization.representations import (
    BilinearNet as JaxBilinearNet)
from spotlight_tpu.ops.sampling import sample_items_device
from spotlight_tpu_torch.data import Interactions, random_train_test_split
from spotlight_tpu_torch.data.synthetic import generate_factorization
from spotlight_tpu_torch.evaluation import mrr_score
from spotlight_tpu_torch.factorization import (BilinearNet,
                                               ImplicitFactorizationModel)
from spotlight_tpu_torch.utils import training
from spotlight_tpu_torch.utils.convert import (opt_state_from_jax,
                                               params_from_jax)

from tests._fixtures import factorization_dataset

LOSSES = ('pointwise', 'bpr', 'hinge', 'adaptive_hinge')


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The steps here are many small ops: on one thread each, they do not
    wait on the other test workers' threads for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NUM_USERS, NUM_ITEMS, DIM, BATCH = 40, 30, 8, 64
MOMENT_SCALE, PARAM_ATOL, LOSS_RTOL, EPOCH_ATOL = 1e-6, 1e-6, 1e-6, 1e-5


def to_port(interactions):
    return Interactions(interactions.user_ids, interactions.item_ids,
                        num_users=interactions.num_users,
                        num_items=interactions.num_items)


def dataset(n, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, NUM_USERS, n).astype(np.int32),
            rs.randint(0, NUM_ITEMS, n).astype(np.int32))


def jax_draws(key, jax_model, num_batches):
    """The permutation and per-batch negatives that ``fit`` derives from the
    model's key: ``_next_key``'s subkey, split as the JAX engines split it
    (``factorization/lazy.py`` and ``utils/training.epoch_scan``)."""
    _, subkey = jax.random.split(key)
    perm_key, negatives_key = jax.random.split(subkey)
    perm = jax.random.permutation(perm_key, num_batches * BATCH)
    batch_keys = jax.random.split(negatives_key, num_batches)
    adaptive = jax_model._loss == 'adaptive_hinge'
    n_neg = jax_model._num_negative_samples if adaptive else 1
    if jax_model._lazy or adaptive:
        shape = (n_neg, BATCH)
    else:
        shape = (BATCH,)
    negatives = [np.asarray(sample_items_device(k, NUM_ITEMS, shape))
                 for k in batch_keys]
    negatives = np.stack(negatives).reshape(num_batches, n_neg, BATCH)
    return (torch.from_numpy(np.asarray(perm).astype(np.int64)),
            torch.from_numpy(negatives.astype(np.int64)))


def tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def models(loss, negative_sampling, sparse, table='float32', l2=1e-6):
    kwargs = dict(loss=loss, embedding_dim=DIM, n_iter=1, batch_size=BATCH,
                  l2=l2, sparse=sparse, num_negative_samples=3,
                  negative_sampling=negative_sampling)
    jax_rep = port_rep = None
    if table != 'float32':
        jax_rep = JaxBilinearNet(NUM_USERS, NUM_ITEMS, DIM,
                                 table_dtype=jnp.bfloat16)
        port_rep = BilinearNet(NUM_USERS, NUM_ITEMS, DIM,
                               table_dtype=torch.bfloat16)
    jax_model = JaxImplicitModel(representation=jax_rep,
                                 random_state=np.random.RandomState(42),
                                 **kwargs)
    port = ImplicitFactorizationModel(representation=port_rep,
                                      random_state=np.random.RandomState(42),
                                      device='cpu', **kwargs)
    return jax_model, port


def compare_epoch(loss, negative_sampling, sparse, n, table='float32',
                  l2=1e-6):
    """Warm both models, run one more JAX epoch and the same epoch in the
    port; returns (jax_model, port, port epoch loss)."""
    from spotlight_tpu.data import Interactions as JaxInteractions

    users, items = dataset(n)
    jax_data = JaxInteractions(users, items, num_users=NUM_USERS,
                               num_items=NUM_ITEMS)
    jax_model, port = models(loss, negative_sampling, sparse, table, l2)
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
    perm, negatives = jax_draws(key, jax_model, num_batches)
    if negative_sampling == 'in_batch':
        negatives = None
    epoch_loss = training.run_epoch(port._step_fn(), data, n_valid,
                                    num_batches, BATCH, perm, negatives)
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
@pytest.mark.parametrize('negative_sampling', ['uniform', 'in_batch'])
@pytest.mark.parametrize('loss', LOSSES)
def test_one_step_matches_jax(loss, negative_sampling, sparse):
    """One batch of 59 examples and 5 padding rows: the padding rows' ids
    take their momentum step in both packages."""
    jax_model, port, epoch_loss = compare_epoch(loss, negative_sampling,
                                                sparse, BATCH - 5)
    assert_state_close(jax_model, port, PARAM_ATOL)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize('negative_sampling', ['uniform', 'in_batch'])
def test_one_lazy_step_with_a_bfloat16_table_matches_jax(negative_sampling):
    jax_model, port, epoch_loss = compare_epoch('bpr', negative_sampling,
                                                True, BATCH - 5,
                                                table='bfloat16')
    assert port._net.user_embeddings.weight.dtype == torch.bfloat16
    assert_state_close(jax_model, port, PARAM_ATOL)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize('loss, negative_sampling, sparse', [
    ('bpr', 'uniform', True),
    ('adaptive_hinge', 'in_batch', True),
    ('hinge', 'uniform', False),
])
def test_one_epoch_of_three_batches_matches_jax(loss, negative_sampling,
                                                sparse):
    jax_model, port, epoch_loss = compare_epoch(loss, negative_sampling,
                                                sparse, 3 * BATCH - 7,
                                                l2=0.0)
    assert_state_close(jax_model, port, EPOCH_ATOL)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=EPOCH_ATOL)


def test_generate_factorization_equals_jax():
    for explicit in (False, True):
        want = jax_generate_factorization(
            50, 40, 700, rank=4, noise=0.2, explicit=explicit,
            random_state=np.random.RandomState(3))
        got = generate_factorization(
            50, 40, 700, rank=4, noise=0.2, explicit=explicit,
            random_state=np.random.RandomState(3))
        for field in ('user_ids', 'item_ids', 'ratings', 'timestamps'):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert (got.num_users, got.num_items) == (50, 40)


@functools.lru_cache(maxsize=None)
def gate_data(num_users, num_items, num_interactions, rank=8, noise=0.1):
    interactions = generate_factorization(
        num_users, num_items, num_interactions, rank=rank, noise=noise,
        random_state=np.random.RandomState(42))
    return random_train_test_split(interactions,
                                   random_state=np.random.RandomState(0))


@pytest.mark.parametrize('loss, n_iter, gate, seeds', [
    ('bpr', 20, 0.05, (0, 1, 2, 3)),
    ('adaptive_hinge', 10, 0.04, (42,)),
])
def test_lazy_engine_passes_the_jax_gates(loss, n_iter, gate, seeds):
    """``tests/test_lazy_adam.py::test_lazy_implicit_learns``'s gates on the
    same data, ``generate_factorization(120, 90, 6000)`` seeded as the JAX
    fixture seeds it.  The bpr gate sits inside what either package
    reaches (``python -m tests.torch_gate_seeds`` prints the readings):
    over the model seeds 0-7 and 42, JAX scores 0.0448-0.0583 (mean
    0.0514, seeds 0 and 5 under the gate) and the port 0.0475-0.0541 (mean
    0.0507, seeds 3, 4, 7 and 42 under it), so one seed of a different
    random stream is a coin toss at the gate; it is held by the mean of
    seeds 0-3 (0.0510).  Every seed clears the adaptive-hinge gate in both
    packages (0.0487-0.0603)."""
    train, test = gate_data(120, 90, 6000)
    scores = []
    for seed in seeds:
        model = ImplicitFactorizationModel(
            loss=loss, n_iter=n_iter, batch_size=512, sparse=True,
            random_state=np.random.RandomState(seed), device='cpu')
        assert model.fit(train) is model
        assert model._lazy and model._opt_state['t'] == n_iter * 10
        scores.append(mrr_score(model, test, train=train).mean())
    assert np.mean(scores) > gate


def test_dense_engine_passes_the_jax_gate():
    """``tests/factorization/test_implicit.py::test_implicit_losses``'s
    ``bpr`` case (its gate less its epsilon), and the untrained model at
    chance."""
    train, test = gate_data(600, 400, 30000, noise=0.15)
    model = ImplicitFactorizationModel(
        loss='bpr', embedding_dim=32, n_iter=10, batch_size=1024,
        learning_rate=1e-2, l2=1e-6, random_state=np.random.RandomState(42),
        device='cpu')
    untrained = ImplicitFactorizationModel(
        random_state=np.random.RandomState(42), device='cpu')
    untrained._initialize(train)
    assert mrr_score(untrained, test, train=train).mean() < 0.02
    model.fit(train)
    assert not model._lazy
    assert mrr_score(model, test, train=train).mean() > 0.030


def test_gate_data_equals_the_jax_fixture():
    want_train, _ = jax_split(factorization_dataset(
        num_users=120, num_items=90, num_interactions=6000),
        random_state=np.random.RandomState(0))
    train, _ = gate_data(120, 90, 6000)
    np.testing.assert_array_equal(train.user_ids, want_train.user_ids)
    np.testing.assert_array_equal(train.item_ids, want_train.item_ids)


@pytest.mark.parametrize('sparse', [True, False], ids=['lazy', 'dense'])
def test_repeated_fit_resumes(sparse):
    """A second ``fit`` continues from the state (parameters, moments,
    step count and the random stream); a new model would not."""
    train, _ = gate_data(120, 90, 6000)

    def model():
        return ImplicitFactorizationModel(
            loss='bpr', n_iter=1, batch_size=1024, sparse=sparse,
            random_state=np.random.RandomState(9), device='cpu')

    resumed = model().fit(train).fit(train)
    fresh = model().fit(train)
    twice = model()
    twice._n_iter = 2
    twice.fit(train)
    step = 't' if sparse else 'count'
    assert resumed._opt_state[step] == twice._opt_state[step] == 10
    for name, value in resumed._net.state_dict().items():
        assert torch.equal(value, twice._net.state_dict()[name])
        assert not torch.equal(value, fresh._net.state_dict()[name])


@pytest.mark.parametrize('sparse', [True, False], ids=['lazy', 'dense'])
def test_diverging_fit_raises(sparse):
    """The hinge loss is unbounded: at lr 1e18 the epoch loss reaches inf,
    in both packages (the bounded ``bpr`` saturates instead, in both)."""
    train, _ = gate_data(120, 90, 6000)
    model = ImplicitFactorizationModel(
        loss='hinge', n_iter=3, batch_size=1024, learning_rate=1e18,
        sparse=sparse, random_state=np.random.RandomState(0), device='cpu')
    with pytest.raises(ValueError, match='Degenerate epoch loss'):
        model.fit(train)


def test_degenerate_guard_catches_inf_and_zero():
    for value in (float('inf'), float('nan'), 0.0):
        with pytest.raises(ValueError, match='Degenerate'):
            training.check_degenerate(value)
    training.check_degenerate(0.5)


def test_loss_drain_reads_one_epoch_late(capsys):
    drain = training.EpochLossDrain(verbose=True)
    drain.push(0, torch.tensor(0.5))
    assert drain.last_loss is None
    drain.push(1, torch.tensor(0.25))
    assert drain.last_loss == 0.5
    drain.finish()
    assert drain.last_loss == 0.25
    assert capsys.readouterr().out.splitlines() == ['Epoch 0: loss 0.5',
                                                    'Epoch 1: loss 0.25']


@pytest.mark.parametrize('kwargs', [
    {'representation': 'four_table'},
    {'optimizer_func': lambda: training.Adam(1e-2)},
])
def test_sparse_with_custom_parts_warns_and_trains_dense(kwargs):
    train, _ = gate_data(120, 90, 6000)
    if kwargs.get('representation') == 'four_table':
        kwargs = {'representation': BilinearNet(120, 90, 8, fused=False)}
    model = ImplicitFactorizationModel(
        loss='bpr', n_iter=1, batch_size=1024, sparse=True,
        random_state=np.random.RandomState(0), device='cpu', **kwargs)
    with pytest.warns(RuntimeWarning,
                      match='sparse=True falls back to the dense engine'):
        model.fit(train)
    assert not model._lazy and model._opt_state['count'] == 5


@pytest.mark.parametrize('sparse', [True, False], ids=['lazy', 'dense'])
def test_bfloat16_tables_train_in_their_dtype(sparse):
    """A bfloat16 fused table trains with either engine; the lazy engine
    keeps float32 moments, the dense one moments of the table's dtype (as
    optax's Adam keeps them)."""
    train, _ = gate_data(120, 90, 6000)
    net = BilinearNet(120, 90, 8, table_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    before = net.item_embeddings.weight.detach().clone()
    model = ImplicitFactorizationModel(
        loss='bpr', n_iter=1, batch_size=1024, sparse=sparse,
        representation=net, random_state=np.random.RandomState(0),
        device='cpu').fit(train)
    weight = model._net.item_embeddings.weight
    assert weight.dtype == torch.bfloat16 and not torch.equal(weight, before)
    moment = model._opt_state['mu']['item_embeddings.weight']
    assert moment.dtype == (torch.float32 if sparse else torch.bfloat16)
    assert np.isfinite(model._last_epoch_loss)


def test_mesh_raises_naming_the_roadmap():
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        ImplicitFactorizationModel(mesh=object(), device='cpu')


def test_same_seed_same_training_stream():
    """The epoch's draws come from the estimator's CPU generator: the same
    seed trains to the same bits."""
    train, _ = gate_data(120, 90, 6000)
    states = []
    for _ in range(2):
        model = ImplicitFactorizationModel(
            loss='adaptive_hinge', n_iter=2, batch_size=1024, sparse=True,
            random_state=np.random.RandomState(5), device='cpu')
        with warnings.catch_warnings():
            warnings.simplefilter('error')
            model.fit(train)
        states.append(model._net.state_dict())
    for name, value in states[0].items():
        assert torch.equal(value, states[1][name])


def test_shuffled_mask_is_the_valid_mask_shuffled():
    generator = torch.Generator().manual_seed(1)
    perm, _ = training.epoch_draws(generator, 12)
    data = {'ids': torch.arange(12) * 10}
    batched = training.shuffle_and_batch(perm, data, 9, 3, 4)
    valid = torch.zeros(12)
    valid[:9] = 1.0
    want = valid[perm].reshape(3, 4)
    assert torch.equal(batched['mask'], want)
    assert torch.equal(batched['ids'], (perm * 10).reshape(3, 4))


def test_epoch_draws_move_in_one_copy():
    generator = torch.Generator().manual_seed(0)
    perm, negatives = training.epoch_draws(generator, 12, (3, 2, 4), 7)
    assert sorted(perm.tolist()) == list(range(12))
    assert negatives.shape == (3, 2, 4)
    assert int(negatives.max()) < 7
    assert negatives.data_ptr() - perm.data_ptr() == 12 * 8
    perm, none = training.epoch_draws(generator, 5)
    assert none is None and sorted(perm.tolist()) == list(range(5))


def test_jax_split_helper_is_the_fixture_split():
    """The gates' split equals the JAX package's on the same data."""
    data = jax_generate_factorization(30, 20, 300,
                                      random_state=np.random.RandomState(1))
    want, _ = jax_split(data, random_state=np.random.RandomState(0))
    got, _ = random_train_test_split(
        to_port(data), random_state=np.random.RandomState(0))
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
