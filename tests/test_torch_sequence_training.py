"""Sequence training in the port against the JAX package's, on the CPU.

A JAX ``ImplicitSequenceModel`` trains one epoch to reach a warm state
(moments non-zero, step count past 1); its parameters and Adam state go
through ``params_from_jax`` and ``opt_state_from_jax`` into the port.  Then
both packages take the same next epoch: the port is handed JAX's own
permutation and negatives, reproduced from the JAX epoch key exactly as
``utils/training.epoch_scan`` splits it (a permutation key, then one key a
batch, each drawing that batch's ``(B, T)`` negatives, or ``(n, B, T)``
for ``adaptive_hinge``).  One batch (with padding rows and padded
positions) is one step.

The recurrence needs no looser tolerance than the implicit MF engines
(``tests/test_torch_training.py``): the port runs the LSTM as a Python loop
under autograd where JAX runs a ``lax.scan``, and over the LSTM and mixture
cases here the largest gaps measured are 7.5e-8 on parameters, 9.7e-7 of
each moment's largest value and 1.2e-7 relative on the loss.  So moments
are held within ``MOMENT_SCALE`` = 1e-6 of each parameter's largest moment
(the bloom layer's within ``BLOOM_MOMENT_SCALE``, below), parameters to
atol 1e-6 and the loss to rtol 1e-6; a whole epoch of three batches to
1e-5.  The item table's padding row reads as zeros, gets no gradient and
stays zero under coupled ``l2``, in both packages.

Whole fits draw from different generators (threefry against torch's), so
the port is held to the JAX package's learning gates instead
(``tests/test_torch_sequence_gates.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.data.interactions import (
    SequenceInteractions as JaxSequenceInteractions)
from spotlight_tpu.data.synthetic import (
    generate_sequential as jax_generate_sequential)
from spotlight_tpu.ops.embeddings import BloomEmbedding as JaxBloomEmbedding
from spotlight_tpu.ops.sampling import sample_items_device
from spotlight_tpu.sequence import ImplicitSequenceModel as JaxSequenceModel
from spotlight_tpu.sequence.representations import LSTMNet as JaxLSTMNet
from spotlight_tpu.sequence.representations import (
    MixtureLSTMNet as JaxMixtureLSTMNet)
from spotlight_tpu_torch.data import (SequenceInteractions,
                                      user_based_train_test_split)
from spotlight_tpu_torch.data.synthetic import generate_sequential
from spotlight_tpu_torch.ops.embeddings import BloomEmbedding
from spotlight_tpu_torch.sequence import (ImplicitSequenceModel, LSTMNet,
                                          MixtureLSTMNet)
from spotlight_tpu_torch.utils import training
from spotlight_tpu_torch.utils.convert import (opt_state_from_jax,
                                               params_from_jax)

LOSSES = ('pointwise', 'bpr', 'hinge', 'adaptive_hinge')
NUM_ITEMS, DIM, LENGTH, BATCH, NEGATIVES = 30, 8, 6, 64, 3
MOMENT_SCALE, PARAM_ATOL, LOSS_RTOL, EPOCH_ATOL = 1e-6, 1e-6, 1e-6, 1e-5
#: The bloom layer's moments: measured up to 1.14e-6 of the largest ``nu``
#: of the compressed table (in-batch negatives), whose rows sum the
#: gradients of several items through their hashes in another order.
BLOOM_MOMENT_SCALE = 2e-6


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The steps are many small ops: on one thread each, they do not wait
    on the other test workers' threads for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sequences_of(rows, seed=0):
    """Random sequences with left padding, as ``to_sequence`` makes it,
    and one all-padding row."""
    rs = np.random.RandomState(seed)
    sequences = rs.randint(1, NUM_ITEMS, (rows, LENGTH))
    sequences[:10, :2] = 0
    sequences[3] = 0
    return sequences


def representations(kind):
    """(JAX representation, port representation) of ``kind``, or the
    built-in name for both."""
    if kind == 'bloom':
        return (JaxLSTMNet(NUM_ITEMS, DIM,
                           item_embedding_layer=JaxBloomEmbedding(
                               NUM_ITEMS, DIM, compression_ratio=0.5,
                               num_hash_functions=2)),
                LSTMNet(NUM_ITEMS, DIM, item_embedding_layer=BloomEmbedding(
                    NUM_ITEMS, DIM, compression_ratio=0.5,
                    num_hash_functions=2)))
    if kind == 'lstm bfloat16':
        return (JaxLSTMNet(NUM_ITEMS, DIM, table_dtype=jnp.bfloat16),
                LSTMNet(NUM_ITEMS, DIM, table_dtype=torch.bfloat16))
    if kind == 'mixture bfloat16':
        return (JaxMixtureLSTMNet(NUM_ITEMS, DIM, table_dtype=jnp.bfloat16),
                MixtureLSTMNet(NUM_ITEMS, DIM, table_dtype=torch.bfloat16))
    return kind, kind


def tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def jax_draws(key, jax_model, num_batches):
    """The permutation and per-batch negatives that ``fit`` derives from the
    model's key: ``_next_key``'s subkey, split as ``epoch_scan`` splits
    it.  Negatives are None for in-batch sampling."""
    _, subkey = jax.random.split(key)
    perm_key, negatives_key = jax.random.split(subkey)
    perm = jax.random.permutation(perm_key, num_batches * BATCH)
    perm = torch.from_numpy(np.asarray(perm).astype(np.int64))
    if jax_model._negative_sampling == 'in_batch':
        return perm, None
    shape = (BATCH, LENGTH)
    if jax_model._loss == 'adaptive_hinge':
        shape = (jax_model._num_negative_samples,) + shape
    negatives = np.stack([
        np.asarray(sample_items_device(k, NUM_ITEMS, shape))
        for k in jax.random.split(negatives_key, num_batches)])
    return perm, torch.from_numpy(negatives.astype(np.int64))


def compare_epoch(kind, loss, negative_sampling, rows, l2=1e-6):
    """Warm both models, run one more JAX epoch and the same epoch in the
    port; returns (jax_model, port, port epoch loss)."""
    sequences = sequences_of(rows)
    jax_rep, port_rep = representations(kind)
    kwargs = dict(loss=loss, embedding_dim=DIM, n_iter=1, batch_size=BATCH,
                  l2=l2, num_negative_samples=NEGATIVES,
                  negative_sampling=negative_sampling)
    jax_model = JaxSequenceModel(representation=jax_rep,
                                 random_state=np.random.RandomState(42),
                                 **kwargs)
    port = ImplicitSequenceModel(representation=port_rep,
                                 random_state=np.random.RandomState(42),
                                 device='cpu', **kwargs)
    jax_data = JaxSequenceInteractions(sequences, num_items=NUM_ITEMS)
    port_data = SequenceInteractions(sequences, num_items=NUM_ITEMS)
    jax_model.fit(jax_data)
    port._initialize(port_data)
    port._load_params(params_from_jax(port._net, tree(jax_model._params)))
    port._opt_state = opt_state_from_jax(port._net,
                                         tree(jax_model._opt_state))

    key = jax_model._key
    jax_model.fit(jax_data)
    data, n_valid, num_batches = port._epoch_data(port_data)
    perm, negatives = jax_draws(key, jax_model, num_batches)
    epoch_loss = training.run_epoch(port._step_fn(), data, n_valid,
                                    num_batches, BATCH, perm, negatives)
    return jax_model, port, float(epoch_loss)


def assert_state_close(jax_model, port, param_atol,
                       moment_scale=MOMENT_SCALE):
    params = params_from_jax(port._net, tree(jax_model._params))
    for name, value in port._net.state_dict().items():
        np.testing.assert_allclose(
            value.float().numpy(), params[name].float().numpy(), rtol=0,
            atol=param_atol, err_msg=name)
    want = opt_state_from_jax(port._net, tree(jax_model._opt_state))
    assert port._opt_state['count'] == want['count']
    for moment in ('mu', 'nu'):
        for name, value in want[moment].items():
            got = port._opt_state[moment][name]
            assert got.dtype == value.dtype
            want_moment = value.float().numpy()
            np.testing.assert_allclose(
                got.float().numpy(), want_moment, rtol=0,
                atol=moment_scale * np.abs(want_moment).max(),
                err_msg='{} {}'.format(moment, name))


def assert_padding_row_zero(port):
    if port._net.fused:
        assert not port._net.item_embeddings.weight[0].any()


@pytest.mark.parametrize('negative_sampling', ['uniform', 'in_batch'])
@pytest.mark.parametrize('loss', LOSSES)
@pytest.mark.parametrize('kind', ['lstm', 'mixture'])
def test_one_step_matches_jax(kind, loss, negative_sampling):
    """One batch of 59 sequences and 5 padding rows; the padded positions
    and the all-padding row are masked out of the loss."""
    jax_model, port, epoch_loss = compare_epoch(kind, loss,
                                                negative_sampling,
                                                BATCH - 5)
    assert_state_close(jax_model, port, PARAM_ATOL)
    assert_padding_row_zero(port)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize('kind, negative_sampling', [
    ('bloom', 'uniform'),
    ('bloom', 'in_batch'),
    ('lstm bfloat16', 'uniform'),
    ('lstm bfloat16', 'in_batch'),
    ('mixture bfloat16', 'uniform'),
])
def test_one_step_of_the_other_layers_matches_jax(kind, negative_sampling):
    """The bloom LSTM (``BloomEmbedding`` item layer, classic layout) and
    bfloat16 item tables, whose Adam moments stay bfloat16 as optax keeps
    them."""
    jax_model, port, epoch_loss = compare_epoch(kind, 'bpr',
                                                negative_sampling,
                                                BATCH - 5)
    if 'bfloat16' in kind:
        assert port._net.item_embeddings.weight.dtype == torch.bfloat16
    assert_state_close(jax_model, port, PARAM_ATOL,
                       BLOOM_MOMENT_SCALE if kind == 'bloom'
                       else MOMENT_SCALE)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize('kind, loss, negative_sampling', [
    ('lstm', 'hinge', 'uniform'),
    ('mixture', 'adaptive_hinge', 'in_batch'),
])
def test_one_epoch_of_three_batches_matches_jax(kind, loss,
                                                negative_sampling):
    jax_model, port, epoch_loss = compare_epoch(kind, loss,
                                                negative_sampling,
                                                3 * BATCH - 7, l2=0.0)
    assert_state_close(jax_model, port, EPOCH_ATOL)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=EPOCH_ATOL)


@pytest.mark.parametrize('shifts', [1, NEGATIVES])
def test_score_inbatch_negatives_matches_jax(shifts):
    jax_model, port, _ = compare_epoch('mixture', 'bpr', 'uniform',
                                       BATCH - 5)
    sequences = sequences_of(BATCH - 5)
    params = jax_model._params
    jax_reprs, _ = jax_model._net.user_representation(params, sequences)
    want = jax_model._net.score_inbatch_negatives(
        params, jax_reprs, sequences, num_negatives=shifts)
    with torch.no_grad():
        reprs, _ = port._net.user_representation(torch.from_numpy(sequences))
        got = port._net.score_inbatch_negatives(
            reprs, torch.from_numpy(sequences), num_negatives=shifts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- data ----------------------------------------------------------------------

@pytest.mark.parametrize('num_items, num_interactions, concentration, order',
                         [(100, 10000, 1e-3, 2), (100, 20000, 1e-3, 2),
                          (100, 10000, 1e2, 2), (1000, 10000, 1e-4, 3)])
def test_generate_sequential_equals_jax(num_items, num_interactions,
                                        concentration, order):
    """At the sizes of the JAX fixtures (``tests/_fixtures.py``)."""
    kwargs = dict(num_users=100, num_items=num_items,
                  num_interactions=num_interactions,
                  concentration_parameter=concentration, order=order)
    want = jax_generate_sequential(random_state=np.random.RandomState(42),
                                   **kwargs)
    got = generate_sequential(random_state=np.random.RandomState(42),
                              **kwargs)
    for field in ('user_ids', 'item_ids', 'ratings', 'timestamps'):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype
    assert (got.num_users, got.num_items) == (want.num_users,
                                              want.num_items)


# -- the estimator ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def small_fit_data():
    """The sequences of the learning gates' training set."""
    interactions = generate_sequential(
        num_users=100, num_items=100, num_interactions=10000,
        concentration_parameter=1e-3, order=2,
        random_state=np.random.RandomState(42))
    train, _ = user_based_train_test_split(
        interactions, random_state=np.random.RandomState(42))
    return train.to_sequence(max_sequence_length=10)


def test_repeated_fit_resumes():
    """A second ``fit`` continues from the state (parameters, moments,
    step count and the random stream); a new model would not."""
    train = small_fit_data()

    def model():
        return ImplicitSequenceModel(
            loss='bpr', representation='lstm', n_iter=1, batch_size=256,
            embedding_dim=8, random_state=np.random.RandomState(9),
            device='cpu')

    resumed = model().fit(train).fit(train)
    fresh = model().fit(train)
    twice = model()
    twice._n_iter = 2
    twice.fit(train)
    steps = 2 * -(-len(train.sequences) // 256)
    assert resumed._opt_state['count'] == twice._opt_state['count'] == steps
    for name, value in resumed._net.state_dict().items():
        assert torch.equal(value, twice._net.state_dict()[name])
        assert not torch.equal(value, fresh._net.state_dict()[name])


def test_padding_row_stays_zero_under_l2():
    train = small_fit_data()
    model = ImplicitSequenceModel(
        loss='hinge', representation='mixture', n_iter=2, batch_size=256,
        embedding_dim=8, l2=1e-2, negative_sampling='in_batch',
        random_state=np.random.RandomState(0), device='cpu').fit(train)
    weight = model._net.item_embeddings.weight
    assert not weight[0].any() and weight[1:].abs().sum() > 0
    assert not model._opt_state['mu']['item_embeddings.weight'][0].any()


def test_diverging_fit_raises():
    """The LSTM's hidden state is bounded, so the scores grow only with the
    item table: at lr 1e38 one Adam step leaves float32's range and the
    epoch loss is NaN."""
    model = ImplicitSequenceModel(
        loss='hinge', representation='lstm', n_iter=3, batch_size=256,
        embedding_dim=8, learning_rate=1e38,
        random_state=np.random.RandomState(0), device='cpu')
    with pytest.raises(ValueError, match='Degenerate epoch loss'):
        model.fit(small_fit_data())


def test_sparse_refuses_where_jax_takes_its_lazy_engine():
    """Where the JAX package takes its row-sparse sequence engine, so does
    the port (it refused before the engine was ported): the hybrid state,
    a lazy item table and a dense tower, counts the steps."""
    train = small_fit_data()
    model = ImplicitSequenceModel(representation='lstm', sparse=True,
                                  n_iter=1, batch_size=256, embedding_dim=8,
                                  random_state=np.random.RandomState(0),
                                  device='cpu').fit(train)
    steps = -(-len(train.sequences) // 256)
    assert model._lazy and 'tower' in model._opt_state
    assert model._opt_state['t'] == model._opt_state['tower']['count'] == (
        steps)


@pytest.mark.parametrize('case', ['bloom layer', 'optimizer_func'])
def test_sparse_falls_back_to_dense_where_jax_does(case):
    """A classic layout or a custom optimizer: the JAX package's warning,
    then dense training."""
    train = small_fit_data()
    kwargs = {}
    representation = 'lstm'
    if case == 'bloom layer':
        representation = LSTMNet(train.num_items, 8,
                                 item_embedding_layer=BloomEmbedding(
                                     train.num_items, 8,
                                     compression_ratio=0.5))
    else:
        kwargs['optimizer_func'] = lambda: training.Adam(1e-2)
    model = ImplicitSequenceModel(
        representation=representation, sparse=True, n_iter=1,
        batch_size=256, embedding_dim=8,
        random_state=np.random.RandomState(0), device='cpu', **kwargs)
    with pytest.warns(RuntimeWarning,
                      match='sparse=True falls back to the dense engine'):
        model.fit(train)
    assert not model._lazy and model._opt_state['count'] > 0
