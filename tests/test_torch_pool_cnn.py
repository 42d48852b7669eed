"""The port's pooling and CNN sequence representations against the JAX
package's, on the CPU.

A JAX ``ImplicitSequenceModel`` over a ``PoolNet`` or ``CNNNet`` is
initialised (not fitted) and its item biases filled with seeded values; its
parameters go through ``params_from_jax`` into the port (the CNN's list of
``(W, I, O)`` layers as ``cnn_layers.<i>.weight``), and both packages must
then agree on the same numpy sequences, 6 of 7 over 50 items:

- per-step and final representations, step scores, catalogue scores and
  ``predict``: within rtol 1e-5 of the largest element (the float32 sums
  run in other orders: JAX's cumulative sums and its convolution against
  the port's ``cumsum`` and one product a tap);
- ``sequence_mrr_score`` (rtol 1e-6: ranks are half-integer counts) and
  ``sequence_precision_recall_score`` (exactly), streaming or not;
- one dense training step from the same warm state and JAX's own draws, at
  the tolerances of ``tests/test_torch_sequence_training.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu import evaluation as jax_eval
from spotlight_tpu.data.interactions import (
    SequenceInteractions as JaxSequenceInteractions)
from spotlight_tpu.ops.embeddings import BloomEmbedding as JaxBloomEmbedding
from spotlight_tpu.sequence import ImplicitSequenceModel as JaxSequenceModel
from spotlight_tpu.sequence.representations import CNNNet as JaxCNNNet
from spotlight_tpu.sequence.representations import PoolNet as JaxPoolNet
from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import SequenceInteractions
from spotlight_tpu_torch.ops.embeddings import BloomEmbedding
from spotlight_tpu_torch.sequence import (CNNNet, ImplicitSequenceModel,
                                          PoolNet)
from spotlight_tpu_torch.utils.convert import params_from_jax

from tests.test_torch_sequence_training import (BATCH, LOSS_RTOL, PARAM_ATOL,
                                                assert_padding_row_zero,
                                                assert_state_close,
                                                compare_epoch)

NUM_ITEMS, BATCH_ROWS, LENGTH = 50, 6, 7
RTOL = 1e-5
MRR_RTOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """Many small ops: on one thread each, they do not wait on the other
    test workers' threads for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: Pooling cases: (dim, table layout).
POOL_CASES = [(8, 'fused'), (16, 'fused'), (8, 'bfloat16'), (16, 'bfloat16'),
              (8, 'classic'), (16, 'bloom')]
#: CNN cases: (dim, kernel_width, dilation, num_layers, residual,
#: nonlinearity, table layout).
CNN_CASES = [
    (8, 1, (1,), 1, True, 'tanh', 'fused'),
    (16, 3, (1,), 1, True, 'tanh', 'fused'),
    (8, 5, (1,), 1, False, 'relu', 'fused'),
    (8, 3, (1, 2), 2, True, 'relu', 'bfloat16'),
    (16, 3, (1, 2), 2, False, 'tanh', 'classic'),
    (8, 5, (1, 2, 4), 3, True, 'tanh', 'fused'),
    (16, 3, (1, 2, 4), 3, False, 'relu', 'bfloat16'),
    (8, (1, 3, 5), 2, 3, True, 'relu', 'fused'),
]
CASES = ([('pooling',) + case for case in POOL_CASES]
         + [('cnn',) + case for case in CNN_CASES])


def _layers(layout, dim):
    """(JAX keyword arguments, port keyword arguments) of a table layout."""
    if layout == 'bfloat16':
        return ({'table_dtype': jnp.bfloat16},
                {'table_dtype': torch.bfloat16})
    if layout == 'classic':
        return {'fused': False}, {'fused': False}
    if layout == 'bloom':
        bloom = dict(compression_ratio=0.5, num_hash_functions=2)
        return ({'item_embedding_layer': JaxBloomEmbedding(NUM_ITEMS, dim,
                                                           **bloom)},
                {'item_embedding_layer': BloomEmbedding(NUM_ITEMS, dim,
                                                        **bloom)})
    return {}, {}


def _nets(case):
    kind, dim, *rest = case
    jax_layers, port_layers = _layers(rest[-1], dim)
    if kind == 'pooling':
        return (JaxPoolNet(NUM_ITEMS, dim, **jax_layers),
                PoolNet(NUM_ITEMS, dim, **port_layers), dim)
    kernel_width, dilation, num_layers, residual, nonlinearity, _ = rest
    settings = dict(kernel_width=kernel_width, dilation=dilation,
                    num_layers=num_layers, residual_connections=residual,
                    nonlinearity=nonlinearity)
    return (JaxCNNNet(NUM_ITEMS, dim, **settings, **jax_layers),
            CNNNet(NUM_ITEMS, dim, **settings, **port_layers), dim)


def _sequences(seed=0):
    rs = np.random.RandomState(seed)
    sequences = rs.randint(1, NUM_ITEMS, (BATCH_ROWS, LENGTH))
    sequences[:2, :3] = 0          # left padding, as to_sequence makes it
    sequences[3, :] = 0            # an all-padding row
    return sequences


@functools.lru_cache(maxsize=None)
def pair(case):
    """(JAX model, port model holding its parameters, sequences); the item
    biases are seeded values (JAX initialises them to zero)."""
    sequences = _sequences()
    jax_net, port_net, dim = _nets(case)
    jax_model = JaxSequenceModel(loss='bpr', representation=jax_net,
                                 random_state=np.random.RandomState(1))
    jax_model._initialize(JaxSequenceInteractions(sequences,
                                                  num_items=NUM_ITEMS))
    params = jax.tree_util.tree_map(np.array, jax_model._params)
    bias = (0.1 * np.random.RandomState(2).randn(NUM_ITEMS - 1)).astype(
        np.float32)
    if 'item_biases' in params:
        params['item_biases']['weight'][1:, 0] = bias
    else:
        weight = params['item_embeddings']['weight']
        weight[1:, dim] = bias.astype(weight.dtype)
    jax_model._params = jax.tree_util.tree_map(jnp.asarray, params)
    port = ImplicitSequenceModel(loss='bpr', representation=port_net,
                                 device='cpu',
                                 random_state=np.random.RandomState(1))
    port._initialize(SequenceInteractions(sequences, num_items=NUM_ITEMS))
    port._load_params(params_from_jax(port._net, params))
    return jax_model, port, sequences


def assert_close(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_cases_cover_the_layer_settings():
    """Kernel widths 1, 3 and 5, dilations (1,), (1, 2) and (1, 2, 4) over
    one to three layers, residual on and off, both nonlinearities, both
    dimensions and every table layout."""
    assert {c[1] for c in CNN_CASES} >= {1, 3, 5}
    assert {c[2] for c in CNN_CASES} >= {(1,), (1, 2), (1, 2, 4)}
    assert {(c[3], c[4], c[5]) for c in CNN_CASES} >= {
        (1, True, 'tanh'), (2, True, 'relu'), (3, False, 'relu')}
    assert {c[1] for c in CASES} == {8, 16}
    assert {c[-1] for c in CASES} == {'fused', 'bfloat16', 'classic',
                                      'bloom'}


@pytest.mark.parametrize('case', CASES)
def test_representations_and_scores_match_jax(case):
    jax_model, port, sequences = pair(case)
    net, params = jax_model._net, jax_model._params
    want_steps, want_final = net.user_representation(
        params, jnp.asarray(sequences))
    with torch.no_grad():
        got_steps, got_final = port._net.user_representation(
            torch.as_tensor(sequences))
        got_scores = port._net.score(got_steps, torch.as_tensor(sequences))
        got_catalog = port._net.score_catalog(got_final)
    assert_close(got_steps, want_steps)
    assert_close(got_final, want_final)
    assert_close(got_scores, net.score(params, want_steps,
                                       jnp.asarray(sequences)))
    assert_close(got_catalog, net.score_catalog(params, want_final))


@pytest.mark.parametrize('case', CASES[::3])
def test_predict_matches_jax(case):
    jax_model, port, sequences = pair(case)
    for row in (0, 3, BATCH_ROWS - 1):
        assert_close(torch.from_numpy(port.predict(sequences[row])),
                     jax_model.predict(sequences[row]))
    items = np.array([1, 5, NUM_ITEMS - 1])
    assert_close(torch.from_numpy(port.predict(sequences[1], items)),
                 jax_model.predict(sequences[1], items))


def test_cnn_layers_keep_the_jax_layout():
    """A list of ``(kernel width, D, D)`` weights and ``(D,)`` biases,
    drawn from U(-1/sqrt(D kw), 1/sqrt(D kw)); a bad nonlinearity
    raises as in JAX."""
    net = CNNNet(NUM_ITEMS, 16, kernel_width=(1, 3, 5), num_layers=3,
                 generator=torch.Generator().manual_seed(0))
    names = sorted(name for name, _ in net.named_parameters())
    assert names == sorted(['item_embeddings.weight'] + [
        'cnn_layers.{}.{}'.format(i, leaf) for i in range(3)
        for leaf in ('weight', 'bias')])
    for layer, kw in zip(net.cnn_layers, (1, 3, 5)):
        assert layer['weight'].shape == (kw, 16, 16)
        bound = 1 / np.sqrt(16 * kw)
        for value in (layer['weight'], layer['bias']):
            assert float(value.abs().max()) <= bound
            assert float(value.abs().max()) > 0.8 * bound
    with pytest.raises(ValueError, match='tanh, relu'):
        CNNNet(NUM_ITEMS, 8, nonlinearity='sigmoid')
    with pytest.raises(ValueError, match='tanh, relu'):
        JaxCNNNet(NUM_ITEMS, 8, nonlinearity='sigmoid')


@pytest.mark.parametrize('case', CASES[::2])
def test_rank_factors_feed_the_kernels(case):
    """``_rank_factors_sequences`` hands the kernels the pooling and CNN
    factors (dot scoring), equal to JAX's; the metrics stream (no
    materialize route)."""
    jax_model, port, sequences = pair(case)
    got = port._rank_factors_sequences(sequences[:4])
    want = jax_model._rank_factors_sequences(sequences[:4])
    assert got is not None and got[3] is None
    for got_part, want_part in zip(got[:3], want[:3]):
        assert_close(got_part, want_part)
    routes = evaluation.MATERIALIZE_ROUTES
    _, test = _tests(sequences)
    evaluation.sequence_mrr_score(port, test)
    evaluation.sequence_precision_recall_score(port, test, k=3)
    assert evaluation.MATERIALIZE_ROUTES == routes


def _tests(sequences):
    return (JaxSequenceInteractions(sequences, num_items=NUM_ITEMS),
            SequenceInteractions(sequences, num_items=NUM_ITEMS))


@pytest.mark.parametrize('streaming', [True, False])
@pytest.mark.parametrize('case', CASES[::2])
def test_sequence_metrics_match_jax(case, streaming):
    jax_model, port, sequences = pair(case)
    jax_test, port_test = _tests(sequences)
    for exclude in (False, True):
        got = evaluation.sequence_mrr_score(port, port_test,
                                            exclude_preceding=exclude,
                                            streaming=streaming)
        want = jax_eval.sequence_mrr_score(jax_model, jax_test,
                                           exclude_preceding=exclude,
                                           streaming=streaming)
        np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)
    got = evaluation.sequence_precision_recall_score(
        port, port_test, k=3, streaming=streaming)
    want = jax_eval.sequence_precision_recall_score(
        jax_model, jax_test, k=3, streaming=streaming)
    for got_part, want_part in zip(got, want):
        np.testing.assert_array_equal(got_part, want_part)


@pytest.mark.parametrize('loss, negative_sampling', [
    ('bpr', 'uniform'), ('bpr', 'in_batch'), ('adaptive_hinge', 'uniform')])
@pytest.mark.parametrize('kind', ['pooling', 'cnn'])
def test_one_dense_step_matches_jax(kind, loss, negative_sampling):
    """One batch of 59 sequences and 5 padding rows, from the same warm
    state and JAX's draws."""
    jax_model, port, epoch_loss = compare_epoch(kind, loss,
                                                negative_sampling,
                                                BATCH - 5)
    assert type(port._net) is {'pooling': PoolNet, 'cnn': CNNNet}[kind]
    assert_state_close(jax_model, port, PARAM_ATOL)
    assert_padding_row_zero(port)
    np.testing.assert_allclose(epoch_loss, jax_model._last_epoch_loss,
                               rtol=LOSS_RTOL)
