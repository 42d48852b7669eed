"""The row-sparse sequence engine in the port against the JAX package's, on
the CPU.

A JAX ``ImplicitSequenceModel(sparse=True)`` trains one epoch on its lazy
engine (``spotlight_tpu/sequence/lazy.py``) to reach a warm state; its
parameters and hybrid optimizer state (the item table's float32 moments,
the tower's optax Adam state, the step ``t``) go through ``params_from_jax``
and ``opt_state_from_jax`` into the port.  Then both packages take the same
next epoch of one batch (59 sequences with left padding, one all-padding
row, 5 padded rows): the port is handed JAX's own permutation and
negatives, reproduced from the JAX epoch key as the lazy epoch splits it (a
permutation key, then one key a batch drawing ``(n, B, T)`` negatives, n = 1
but for ``adaptive_hinge``).  Parameters, table moments, tower moments and
the loss are held at the tolerances of
``tests/test_torch_sequence_training.py``; ``t`` and the tower's step count
exactly.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.data.interactions import (
    SequenceInteractions as JaxSequenceInteractions)
from spotlight_tpu.ops.sampling import sample_items_device
from spotlight_tpu.sequence import ImplicitSequenceModel as JaxSequenceModel
from spotlight_tpu.sequence.representations import CNNNet as JaxCNNNet
from spotlight_tpu.sequence.representations import LSTMNet as JaxLSTMNet
from spotlight_tpu.sequence.representations import PoolNet as JaxPoolNet
from spotlight_tpu_torch.data import SequenceInteractions
from spotlight_tpu_torch.ops.embeddings import BloomEmbedding
from spotlight_tpu_torch.sequence import (CNNNet, ImplicitSequenceModel,
                                          LSTMNet, PoolNet)
from spotlight_tpu_torch.utils import training
from spotlight_tpu_torch.utils.convert import (opt_state_from_jax,
                                               params_from_jax)

from tests.test_torch_sequence_training import (BATCH, LENGTH, LOSS_RTOL,
                                                MOMENT_SCALE, NEGATIVES,
                                                NUM_ITEMS, PARAM_ATOL, DIM,
                                                sequences_of, tree)

REPRESENTATIONS = ('pooling', 'lstm', 'cnn', 'mixture')
TABLE = 'item_embeddings.weight'


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Many small ops: on one thread each, they do not wait on the other
    test workers' threads for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def representations(kind, table):
    """(JAX representation, port representation), a bfloat16 item table
    for ``table == 'bfloat16'``, else the built-in name for both."""
    if table != 'bfloat16':
        return kind, kind
    jax_kind = {'pooling': JaxPoolNet, 'lstm': JaxLSTMNet,
                'cnn': JaxCNNNet}[kind]
    port_kind = {'pooling': PoolNet, 'lstm': LSTMNet, 'cnn': CNNNet}[kind]
    return (jax_kind(NUM_ITEMS, DIM, table_dtype=jnp.bfloat16),
            port_kind(NUM_ITEMS, DIM, table_dtype=torch.bfloat16))


def lazy_draws(key, jax_model, num_batches):
    """The permutation and per-batch ``(n, B, T)`` negatives that the JAX
    lazy epoch derives from the model's key; None in-batch."""
    _, subkey = jax.random.split(key)
    perm_key, negatives_key = jax.random.split(subkey)
    perm = jax.random.permutation(perm_key, num_batches * BATCH)
    perm = torch.from_numpy(np.asarray(perm).astype(np.int64))
    if jax_model._negative_sampling == 'in_batch':
        return perm, None
    n_neg = (jax_model._num_negative_samples
             if jax_model._loss == 'adaptive_hinge' else 1)
    negatives = np.stack([
        np.asarray(sample_items_device(k, NUM_ITEMS,
                                       (n_neg, BATCH, LENGTH)))
        for k in jax.random.split(negatives_key, num_batches)])
    return perm, torch.from_numpy(negatives.astype(np.int64))


def compare_lazy_epoch(kind, loss, negative_sampling, table='float32',
                       l2=1e-6):
    """Warm both lazy models, run one more JAX epoch and the same epoch in
    the port; returns (jax_model, port, port epoch loss)."""
    sequences = sequences_of(BATCH - 5)
    jax_rep, port_rep = representations(kind, table)
    kwargs = dict(loss=loss, embedding_dim=DIM, n_iter=1, batch_size=BATCH,
                  l2=l2, num_negative_samples=NEGATIVES, sparse=True,
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
    assert jax_model._lazy and port._lazy
    port._load_params(params_from_jax(port._net, tree(jax_model._params)))
    port._opt_state = opt_state_from_jax(port._net,
                                         tree(jax_model._opt_state))

    key = jax_model._key
    jax_model.fit(jax_data)
    data, n_valid, num_batches = port._epoch_data(port_data)
    perm, negatives = lazy_draws(key, jax_model, num_batches)
    epoch_loss = training.run_epoch(port._step_fn(), data, n_valid,
                                    num_batches, BATCH, perm, negatives)
    return jax_model, port, float(epoch_loss)


def assert_close_to_scale(got, want, what):
    want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=MOMENT_SCALE * np.abs(want).max(),
                               err_msg=what)


def assert_lazy_state_close(jax_model, port):
    params = params_from_jax(port._net, tree(jax_model._params))
    for name, value in port._net.state_dict().items():
        assert value.dtype == params[name].dtype
        np.testing.assert_allclose(
            value.float().numpy(), params[name].float().numpy(), rtol=0,
            atol=PARAM_ATOL, err_msg=name)
    want = opt_state_from_jax(port._net, tree(jax_model._opt_state))
    got = port._opt_state
    assert got['t'] == want['t'] == got['tower']['count'] == (
        want['tower']['count'])
    for moment in ('mu', 'nu'):
        assert got['table'][moment].dtype == torch.float32
        assert_close_to_scale(got['table'][moment], want['table'][moment],
                              'table ' + moment)
        assert set(got['tower'][moment]) == set(want['tower'][moment])
        for name, value in want['tower'][moment].items():
            assert_close_to_scale(got['tower'][moment][name], value,
                                  '{} {}'.format(moment, name))


@pytest.mark.parametrize('loss, negative_sampling', [
    ('bpr', 'uniform'), ('bpr', 'in_batch'), ('adaptive_hinge', 'uniform')])
@pytest.mark.parametrize('kind', REPRESENTATIONS)
def test_one_lazy_step_matches_jax(kind, loss, negative_sampling):
    jax_model, port, epoch_loss = compare_lazy_epoch(kind, loss,
                                                     negative_sampling)
    assert_lazy_state_close(jax_model, port)
    assert not port._net.item_embeddings.weight[0].any()
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize('kind, negative_sampling', [
    ('pooling', 'uniform'), ('lstm', 'in_batch'), ('cnn', 'uniform')])
def test_one_lazy_step_with_a_bfloat16_table_matches_jax(kind,
                                                         negative_sampling):
    """bfloat16 storage, float32 moments and update arithmetic."""
    jax_model, port, epoch_loss = compare_lazy_epoch(
        kind, 'bpr', negative_sampling, table='bfloat16')
    assert port._net.item_embeddings.weight.dtype == torch.bfloat16
    assert_lazy_state_close(jax_model, port)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)


def test_one_lazy_step_without_l2_matches_jax():
    jax_model, port, epoch_loss = compare_lazy_epoch('cnn', 'hinge',
                                                     'uniform', l2=0.0)
    assert_lazy_state_close(jax_model, port)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)


def _padded_sequences():
    """``test_lazy_sequence_padding_row_stays_frozen``'s data: every row
    starts with three padding positions."""
    rs = np.random.RandomState(5)
    sequences = rs.randint(1, 40, size=(128, 8))
    sequences[:, :3] = 0
    return SequenceInteractions(sequences, num_items=40)


@pytest.mark.parametrize('kind', REPRESENTATIONS)
def test_padding_row_stays_frozen(kind):
    """``tests/test_lazy_adam.py:542``: the padding row and its moments
    stay exactly zero (its ids are routed past the table before P1), and
    the other rows train."""
    model = ImplicitSequenceModel(
        loss='bpr', representation=kind, embedding_dim=16, n_iter=2,
        batch_size=64, sparse=True, l2=1e-2,
        random_state=np.random.RandomState(0), device='cpu')
    model.fit(_padded_sequences())
    assert model._lazy
    weight = model._net.item_embeddings.weight
    assert not weight[0].any() and weight[1:].abs().sum() > 0
    for moment in ('mu', 'nu'):
        table = model._opt_state['table'][moment]
        assert not table[0].any() and table[1:].any()


def test_resume_doubles_t():
    """``tests/test_lazy_adam.py:416``: a second ``fit`` resumes the
    hybrid state, so ``t`` (and the tower's count) double."""
    rs = np.random.RandomState(3)
    data = SequenceInteractions(rs.randint(1, 60, size=(256, 8)),
                                num_items=60)
    model = ImplicitSequenceModel(
        loss='bpr', representation='lstm', embedding_dim=16, n_iter=2,
        batch_size=64, sparse=True, random_state=np.random.RandomState(0),
        device='cpu')
    model.fit(data)
    t_after = model._opt_state['t']
    assert model._lazy and t_after == 8
    model.fit(data)
    assert model._opt_state['t'] == model._opt_state['tower']['count'] == (
        2 * t_after)


def _fallback_warning(package_model, data):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        package_model.fit(data)
    messages = [str(w.message) for w in caught
                if issubclass(w.category, RuntimeWarning)]
    assert len(messages) == 1 and not package_model._lazy
    return messages[0]


@pytest.mark.parametrize('case', ['classic layout', 'optimizer_func'])
@pytest.mark.parametrize('kind', ['pooling', 'cnn'])
def test_fallback_warnings_are_the_jax_packages(kind, case):
    """Where the JAX package falls back to its dense engine (a classic
    item layout, a custom optimizer), so does the port, with the same
    warning."""
    import optax

    sequences = sequences_of(BATCH - 5)
    jax_kwargs, port_kwargs = {}, {}
    jax_rep, port_rep = kind, kind
    if case == 'classic layout':
        jax_kind = JaxPoolNet if kind == 'pooling' else JaxCNNNet
        port_kind = PoolNet if kind == 'pooling' else CNNNet
        jax_rep = jax_kind(NUM_ITEMS, DIM, fused=False)
        port_rep = port_kind(NUM_ITEMS, DIM, fused=False)
    else:
        jax_kwargs['optimizer_func'] = lambda: optax.adam(1e-2)
        port_kwargs['optimizer_func'] = lambda: training.Adam(1e-2)
    settings = dict(loss='bpr', embedding_dim=DIM, n_iter=1,
                    batch_size=BATCH, sparse=True)
    want = _fallback_warning(
        JaxSequenceModel(representation=jax_rep, **settings, **jax_kwargs),
        JaxSequenceInteractions(sequences, num_items=NUM_ITEMS))
    got = _fallback_warning(
        ImplicitSequenceModel(representation=port_rep, device='cpu',
                              **settings, **port_kwargs),
        SequenceInteractions(sequences, num_items=NUM_ITEMS))
    assert got == want


def test_bloom_pooling_falls_back_with_the_warning():
    """A ``BloomEmbedding`` item layer (the classic layout) trains dense."""
    rs = np.random.RandomState(1)
    data = SequenceInteractions(rs.randint(1, 60, size=(128, 8)),
                                num_items=60)
    net = PoolNet(60, 8, item_embedding_layer=BloomEmbedding(
        60, 8, compression_ratio=0.5))
    model = ImplicitSequenceModel(representation=net, sparse=True, n_iter=1,
                                  batch_size=64, device='cpu')
    with pytest.warns(RuntimeWarning, match='falls back to the dense'):
        model.fit(data)
    assert not model._lazy and model._opt_state['count'] == 2


def test_opt_state_from_jax_carries_the_hybrid_state():
    """The hybrid state of a three-layer CNN with a bfloat16 table: float32
    table moments, tower moments by the port's three-part names (the
    table excluded), ``t`` and the tower's count."""
    sequences = sequences_of(BATCH - 5)
    jax_rep = JaxCNNNet(NUM_ITEMS, DIM, dilation=(1, 2, 4), num_layers=3,
                        table_dtype=jnp.bfloat16)
    jax_model = JaxSequenceModel(representation=jax_rep, embedding_dim=DIM,
                                 n_iter=1, batch_size=16, sparse=True,
                                 random_state=np.random.RandomState(0))
    jax_model.fit(JaxSequenceInteractions(sequences, num_items=NUM_ITEMS))
    net = CNNNet(NUM_ITEMS, DIM, dilation=(1, 2, 4), num_layers=3,
                 table_dtype=torch.bfloat16)
    state = opt_state_from_jax(net, tree(jax_model._opt_state))
    jax_state = tree(jax_model._opt_state)
    assert state['t'] == state['tower']['count'] == 4
    for moment in ('mu', 'nu'):
        got = state['table'][moment]
        assert got.dtype == torch.float32 and got.shape == (NUM_ITEMS,
                                                            DIM + 1)
        np.testing.assert_array_equal(got.numpy(),
                                      jax_state['table'][moment])
        names = set(state['tower'][moment])
        assert names == {'cnn_layers.{}.{}'.format(i, leaf)
                         for i in range(3) for leaf in ('weight', 'bias')}
        assert TABLE not in names
    assert state['tower']['mu']['cnn_layers.2.weight'].abs().sum() > 0
