"""The port's bloom slice against the JAX package's: the in-graph hashing,
the bag and bloom layers, the gather-sum kernels K6 and K7f/K7b (their
plain versions on the CPU against the Pallas kernels in interpret mode),
and bloom-compressed models end to end.

Tolerances:

- hashing and hashed rows: exact;
- layers on dyadic tables (entries k / 8): exact, since every sum of a few
  of them is exact in any order;
- K6 (``bloom_gather_sum``): exact, float32 and bfloat16 alike; both sum
  in hash order in the table's dtype;
- K7f (``multihot_gather_sum``): the JAX kernel splits a float32 table into
  bf16 hi and lo halves (about 16 bits), the port sums in float32, so the
  two agree to ``2^-15 * sum_j |table[rows_j]|`` elementwise; the port
  equals the float32 gather-sum exactly on dyadic tables and to rtol 1e-6
  otherwise;
- gradients: exact on dyadic operands; K7b also equals ``index_add_``
  (sequential on the CPU) there;
- the models: predictions to rtol 1e-5 (the LSTM's float32 sums run in
  another order), MRR to rtol 1e-6 (half-integer ranks), precision and
  recall exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu import evaluation as jax_eval
from spotlight_tpu.data.interactions import Interactions as JaxInteractions
from spotlight_tpu.data.interactions import (
    SequenceInteractions as JaxSequenceInteractions)
from spotlight_tpu.factorization import (
    ImplicitFactorizationModel as JaxImplicitModel)
from spotlight_tpu.factorization.representations import (
    BilinearNet as JaxBilinearNet)
from spotlight_tpu.ops import embeddings as jax_embeddings
from spotlight_tpu.ops.hashing import bloom_hash_jnp
from spotlight_tpu.ops.hashing import murmurhash3_32 as numpy_murmurhash
from spotlight_tpu.ops.kernels import bloom as jax_bloom
from spotlight_tpu.ops.kernels import multihot as jax_multihot
from spotlight_tpu.sequence import ImplicitSequenceModel as JaxSequenceModel
from spotlight_tpu.sequence.representations import LSTMNet as JaxLSTMNet
from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions, SequenceInteractions
from spotlight_tpu_torch.factorization import (BilinearNet,
                                               ImplicitFactorizationModel)
from spotlight_tpu_torch.ops import hashing
from spotlight_tpu_torch.ops.embeddings import (BloomEmbedding,
                                                ScaledEmbeddingBag)
from spotlight_tpu_torch.ops.kernels import bloom, multihot
from spotlight_tpu_torch.sequence import ImplicitSequenceModel, LSTMNet
from spotlight_tpu_torch.utils.convert import params_from_jax

RTOL, ATOL = 1e-5, 1e-6
MRR_RTOL = 1e-6


def _dyadic(rs, shape):
    return (rs.randint(-8, 9, shape) / 8).astype(np.float32)


# -- hashing -------------------------------------------------------------------

def _edge_ids(rs):
    """Random int32 ids and the edges: 0, 1, -1, and ids near 2^31."""
    edges = [0, 1, -1, 2 ** 31 - 1, 2 ** 31 - 2, -2 ** 31, -2 ** 31 + 1,
             2 ** 30, 123456789]
    return np.concatenate([rs.randint(-2 ** 31, 2 ** 31 - 1, 3995),
                           edges]).astype(np.int32)


@pytest.mark.parametrize('seed', [0, 179424941, 179426549, 2 ** 32 - 1])
def test_murmurhash_torch_matches_numpy(seed):
    ids = _edge_ids(np.random.RandomState(0))
    got = hashing.murmurhash3_32_torch(torch.from_numpy(ids), seed)
    want = numpy_murmurhash(ids, seed, positive=True)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # The port's own numpy copy is the JAX package's.
    np.testing.assert_array_equal(hashing.murmurhash3_32(ids, seed),
                                  numpy_murmurhash(ids, seed))


@pytest.mark.parametrize('padding_idx', [0, None, 7])
@pytest.mark.parametrize('num_hashes,compressed', [(4, 200), (24, 7),
                                                   (1, 1), (3, 2 ** 31 - 1)])
def test_bloom_hash_matches_jax(padding_idx, num_hashes, compressed):
    rs = np.random.RandomState(num_hashes)
    ids = _edge_ids(rs).reshape(-1, 7)                # any shape
    ids[0, :3] = [0, 7, 7]
    got = hashing.bloom_hash(torch.from_numpy(ids), num_hashes, compressed,
                             padding_idx=padding_idx)
    want = bloom_hash_jnp(jnp.asarray(ids), num_hashes, compressed,
                          padding_idx=padding_idx)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # sklearn's convention: the signed hash modulo the size, numpy's sign.
    signed = numpy_murmurhash(ids[..., None], np.array(
        hashing.SEEDS[:num_hashes]).reshape(1, 1, -1))
    rows = np.mod(signed.astype(np.int64), compressed)
    if padding_idx is not None:
        rows[ids == padding_idx] = 0
    np.testing.assert_array_equal(got.numpy(), rows)


# -- layers --------------------------------------------------------------------

def _jax_bloom_layer(num, dim, ratio, hashes, padding_idx=0):
    return jax_embeddings.BloomEmbedding(num, dim, compression_ratio=ratio,
                                         num_hash_functions=hashes,
                                         padding_idx=padding_idx)


@pytest.mark.parametrize('padding_idx', [0, None])
@pytest.mark.parametrize('num,ratio,hashes', [(1000, 0.2, 4), (50, 0.1, 24),
                                              (300, 1.5, 2)])
def test_bloom_embedding_matches_jax(padding_idx, num, ratio, hashes):
    dim = 8
    jax_layer = _jax_bloom_layer(num, dim, ratio, hashes, padding_idx)
    layer = BloomEmbedding(num, dim, compression_ratio=ratio,
                           num_hash_functions=hashes, padding_idx=padding_idx,
                           generator=torch.Generator().manual_seed(0))
    rows = jax_layer.compressed_num_embeddings
    assert layer.compressed_num_embeddings == rows
    assert layer.weight.shape == (rows, dim)
    assert bool((layer.weight[0] == 0).all()) == (padding_idx is not None)

    rs = np.random.RandomState(num)
    weight = _dyadic(rs, (rows, dim))
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(weight))
    ids = rs.randint(0, num, (9, 5))
    ids[0, :2] = 0
    got = layer(torch.from_numpy(ids))
    want = jax_layer.apply({'weight': jnp.asarray(weight)}, jnp.asarray(ids))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        layer.hashed_rows(torch.from_numpy(ids)).numpy(),
        np.asarray(jax_layer.hashed_rows(jnp.asarray(ids))))


def test_bloom_embedding_refusals_match_jax():
    for kwargs in ({'num_hash_functions': 25}, {'num_hash_functions': 0},
                   {'compression_ratio': 0.001}):
        with pytest.raises(ValueError) as port_error:
            BloomEmbedding(100, 4, **kwargs)
        with pytest.raises(ValueError) as jax_error:
            jax_embeddings.BloomEmbedding(100, 4, **kwargs)
        assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize('offsets', [None, [0, 3, 3, 7], [2, 5, 9]])
def test_scaled_embedding_bag_matches_jax(offsets):
    """Bags over the last axis, and the offsets form: an empty bag, and
    offsets that do not start at 0 (the ids before the first bag belong to
    none)."""
    rs = np.random.RandomState(5)
    weight = _dyadic(rs, (40, 6))
    layer = ScaledEmbeddingBag(40, 6)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(weight))
    jax_layer = jax_embeddings.ScaledEmbeddingBag(40, 6)
    params = {'weight': jnp.asarray(weight)}
    if offsets is None:
        ids = rs.randint(0, 40, (3, 4, 5))
        got = layer(torch.from_numpy(ids))
        want = jax_layer.apply(params, jnp.asarray(ids))
    else:
        ids = rs.randint(0, 40, 11)
        got = layer(torch.from_numpy(ids), torch.tensor(offsets))
        want = jax_layer.apply(params, jnp.asarray(ids),
                               jnp.asarray(offsets))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="mode='sum'"):
        ScaledEmbeddingBag(40, 6, mode='mean')


# -- K6, K7f, K7b --------------------------------------------------------------

def _lookup_operands(seed, batch=37, num_rows=100, dim=16, hashes=4,
                     dyadic=True):
    rs = np.random.RandomState(seed)
    draw = _dyadic if dyadic else (
        lambda rs, shape: rs.randn(*shape).astype(np.float32))
    table = draw(rs, (num_rows, dim))
    rows = rs.randint(0, num_rows, (batch, hashes)).astype(np.int32)
    rows[0, :2] = 3                          # a duplicated hash
    rows[1, 0] = 0                           # row 0
    cotangent = draw(rs, (batch, dim))
    return table, rows, cotangent


def _port_value_and_grad(fn, table, rows, cotangent, dtype):
    weight = torch.from_numpy(table).to(dtype).requires_grad_(True)
    out = fn(weight, torch.from_numpy(rows))
    grad, = torch.autograd.grad(out, weight,
                                torch.from_numpy(cotangent).to(dtype))
    return out.detach(), grad


def _jax_value_and_grad(fn, table, rows, cotangent, dtype):
    weight = jnp.asarray(table, dtype)
    out = fn(weight, jnp.asarray(rows))
    grad = jax.grad(lambda t: (fn(t, jnp.asarray(rows)).astype(jnp.float32)
                               * cotangent).sum())(weight)
    return out, grad


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_bloom_gather_sum_matches_jax(dtype):
    table, rows, cotangent = _lookup_operands(0)
    got = _port_value_and_grad(bloom.bloom_gather_sum, table, rows,
                               cotangent, getattr(torch, dtype))
    want = _jax_value_and_grad(
        lambda t, r: jax_bloom.bloom_gather_sum(t, r, 8, True), table, rows,
        cotangent, getattr(jnp, dtype))
    assert got[0].dtype == got[1].dtype == getattr(torch, dtype)
    for got_part, want_part in zip(got, want):
        np.testing.assert_array_equal(_as_numpy(got_part),
                                      _as_numpy(want_part))


def test_bloom_gather_sum_bf16_accumulates_in_bf16():
    """The JAX kernel's accumulator has the table's dtype: a bfloat16
    table sums in bfloat16, rounding after every addition."""
    table = torch.tensor([[1.0], [2.0 ** -8], [2.0 ** -8]],
                         dtype=torch.bfloat16)
    rows = torch.tensor([[0, 1, 2]])
    # 1 + 2^-8 is a tie between bf16 neighbours 1 and 1 + 2^-7: each step
    # rounds to even, back to 1; in float32 the sum is 1 + 2^-7 exactly.
    assert float(bloom.bloom_gather_sum(table, rows)) == 1.0
    assert float(multihot.multihot_gather_sum(table, rows)) == 1.0 + 2 ** -7


@pytest.mark.parametrize('mask', [False, True])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_multihot_gather_sum_matches_jax(mask, dtype):
    table, rows, cotangent = _lookup_operands(1, dyadic=False)
    if dtype == 'bfloat16':
        table = table.astype(jnp.bfloat16).astype(np.float32)
    fn = functools.partial(multihot.multihot_gather_sum, mask_row_zero=mask)
    got = _port_value_and_grad(fn, table, rows, cotangent,
                               getattr(torch, dtype))
    want = _jax_value_and_grad(
        lambda t, r: jax_multihot.multihot_gather_sum(t, r, mask, 512, 2048,
                                                      True),
        table, rows, cotangent, getattr(jnp, dtype))
    terms = np.abs(table[rows])
    if mask:
        terms[rows == 0] = 0.0
    scale = terms.sum(axis=1)
    err = np.abs(_as_numpy(got[0]) - _as_numpy(want[0]))
    if dtype == 'float32':
        assert np.all(err <= 2.0 ** -15 * scale)
    else:
        # Both round one float32 sum to bfloat16 (the JAX pass over a bf16
        # table is exact), so they agree exactly.
        assert np.all(err == 0)
    # The f32 gather-sum oracle: the port sums in float32, one order.
    vectors = table[rows].astype(np.float64)
    if mask:
        vectors[rows == 0] = 0.0
    np.testing.assert_allclose(_as_numpy(got[0]), vectors.sum(axis=1),
                               rtol=1e-6 if dtype == 'float32' else 8e-3,
                               atol=1e-6 * scale.max())
    np.testing.assert_allclose(_as_numpy(got[1]), _as_numpy(want[1]),
                               rtol=1e-6, atol=1e-6)
    if mask:
        assert not got[1][0].any()


@pytest.mark.parametrize('mask', [False, True])
def test_multihot_gather_sum_exact_on_dyadic_tables(mask):
    """Forward: the exact float32 gather-sum, duplicated hashes twice;
    backward: JAX's K7b and ``index_add_`` exactly."""
    table, rows, cotangent = _lookup_operands(2, batch=60, hashes=24)
    fn = functools.partial(multihot.multihot_gather_sum, mask_row_zero=mask)
    out, grad = _port_value_and_grad(fn, table, rows, cotangent,
                                     torch.float32)
    vectors = table[rows]
    if mask:
        vectors = np.where((rows == 0)[..., None], 0.0, vectors)
    np.testing.assert_array_equal(out.numpy(), vectors.sum(axis=1))
    np.testing.assert_array_equal(out[0].numpy(),
                                  (vectors[0, 0] + vectors[0].sum(0)
                                   - vectors[0, 0]))
    _, want_grad = _jax_value_and_grad(
        lambda t, r: jax_multihot.multihot_gather_sum(t, r, mask, 512, 2048,
                                                      True),
        table, rows, cotangent, jnp.float32)
    np.testing.assert_array_equal(grad.numpy(), np.asarray(want_grad))
    flat = torch.from_numpy(rows).reshape(-1).long()
    witness = torch.zeros(table.shape).index_add_(
        0, flat, torch.from_numpy(cotangent).repeat_interleave(
            rows.shape[1], dim=0))
    if mask:
        witness[0] = 0.0
    assert torch.equal(grad, witness)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('entry', ['bloom', 'multihot', 'multihot masked'])
def test_gather_sums_same_bits_for_int32_and_int64_rows(entry, dtype):
    """The entry points take int32 and int64 rows as given (the kernel is
    templated on the index type, no cast): forward and gradient carry the
    same bits either way; K6's equal JAX's kernel on the int32 rows."""
    table, rows, cotangent = _lookup_operands(3, dyadic=False)
    if entry == 'bloom':
        fn = bloom.bloom_gather_sum
    else:
        fn = functools.partial(multihot.multihot_gather_sum,
                               mask_row_zero=entry == 'multihot masked')
    torch_dtype = getattr(torch, dtype)
    results = [_port_value_and_grad(fn, table, rows.astype(index), cotangent,
                                    torch_dtype)
               for index in (np.int32, np.int64)]
    for a, b in zip(*results):
        assert a.dtype == torch_dtype
        assert torch.equal(a.view(torch.int16 if dtype == 'bfloat16'
                                  else torch.int32),
                           b.view(torch.int16 if dtype == 'bfloat16'
                                  else torch.int32))
    if entry == 'bloom':
        want = _jax_value_and_grad(
            lambda t, r: jax_bloom.bloom_gather_sum(t, r, 8, True), table,
            rows, cotangent, getattr(jnp, dtype))
        for got_part, want_part in zip(results[1], want):
            np.testing.assert_array_equal(_as_numpy(got_part),
                                          _as_numpy(want_part))


def test_gather_sums_reject_bad_rows():
    table = torch.zeros(10, 4)
    for bad in ([[0, 10]], [[-1, 2]]):
        with pytest.raises(ValueError, match='rows must lie in'):
            bloom.bloom_gather_sum(table, torch.tensor(bad))
        with pytest.raises(ValueError, match='rows must lie in'):
            multihot.multihot_gather_sum(table, torch.tensor(bad), True)
    with pytest.raises(ValueError, match='table must be'):
        bloom.bloom_gather_sum(table.double(), torch.tensor([[1]]))
    with pytest.raises(ValueError, match='rows must be'):
        multihot.multihot_gather_sum(table, torch.tensor([1.0]))
    empty = multihot.multihot_gather_sum(table, torch.zeros(3, 0,
                                                            dtype=torch.int64))
    assert empty.shape == (3, 4) and not empty.any()


# -- bloom models end to end ---------------------------------------------------

NUM_ITEMS, DIM, LENGTH, NUM_SEQUENCES = 200, 8, 8, 32


@functools.lru_cache(maxsize=None)
def _sequence_pair():
    """A JAX bloom LSTM model (dyadic compressed table, seeded item biases)
    and the port's holding its parameters."""
    rs = np.random.RandomState(0)
    sequences = rs.randint(1, NUM_ITEMS, (NUM_SEQUENCES, LENGTH))
    sequences[:5, :3] = 0
    jax_rep = JaxLSTMNet(NUM_ITEMS, DIM, item_embedding_layer=_jax_bloom_layer(
        NUM_ITEMS, DIM, 0.5, 4))
    jax_model = JaxSequenceModel(loss='bpr', representation=jax_rep,
                                 random_state=np.random.RandomState(1))
    jax_model._initialize(JaxSequenceInteractions(sequences,
                                                  num_items=NUM_ITEMS))
    params = jax.tree_util.tree_map(np.array, jax_model._params)
    table = params['item_embeddings']['weight']
    table[1:] = _dyadic(rs, table[1:].shape)
    params['item_biases']['weight'][1:, 0] = _dyadic(rs, NUM_ITEMS - 1) / 8
    jax_model._params = jax.tree_util.tree_map(jnp.asarray, params)

    rep = LSTMNet(NUM_ITEMS, DIM, item_embedding_layer=BloomEmbedding(
        NUM_ITEMS, DIM, compression_ratio=0.5, num_hash_functions=4))
    port = ImplicitSequenceModel(loss='bpr', representation=rep,
                                 device='cpu')
    port._initialize(SequenceInteractions(sequences, num_items=NUM_ITEMS))
    port._load_params(params_from_jax(port._net, params))
    return jax_model, port, sequences


def test_bloom_sequence_layout_matches_jax():
    jax_model, port, sequences = _sequence_pair()
    assert not port._net.fused and not jax_model._net._fused
    assert set(port._net.state_dict()) == {
        'item_embeddings.weight', 'item_biases.weight', 'lstm.w_ih',
        'lstm.w_hh', 'lstm.b_ih', 'lstm.b_hh'}
    assert port._net.item_embeddings.weight.shape == (NUM_ITEMS // 2, DIM)
    # The densified catalogue: one bloom lookup of every item, exact on
    # the dyadic table.
    got = port._rank_factors_sequences(sequences[:4])
    want = jax_model._rank_factors_sequences(sequences[:4])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


def test_bloom_sequence_predict_matches_jax():
    jax_model, port, sequences = _sequence_pair()
    for row in (0, 9):
        np.testing.assert_allclose(port.predict(sequences[row]),
                                   jax_model.predict(sequences[row]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('streaming', [True, False])
def test_bloom_sequence_metrics_match_jax(streaming):
    jax_model, port, sequences = _sequence_pair()
    jax_test = JaxSequenceInteractions(sequences, num_items=NUM_ITEMS)
    test = SequenceInteractions(sequences, num_items=NUM_ITEMS)
    for exclude in (False, True):
        np.testing.assert_allclose(
            evaluation.sequence_mrr_score(port, test,
                                          exclude_preceding=exclude,
                                          streaming=streaming),
            jax_eval.sequence_mrr_score(jax_model, jax_test,
                                        exclude_preceding=exclude,
                                        streaming=streaming),
            rtol=MRR_RTOL, atol=0)
    for got, want in zip(
            evaluation.sequence_precision_recall_score(
                port, test, k=3, streaming=streaming),
            jax_eval.sequence_precision_recall_score(
                jax_model, jax_test, k=3, streaming=streaming)):
        np.testing.assert_array_equal(got, want)


def test_bloom_factorization_matches_jax():
    """Implicit MF with bloom user and item layers (the four-table
    layout): dyadic tables, so scores are exact and both packages rank
    alike."""
    rs = np.random.RandomState(3)
    num_users, num_items, dim = 60, 80, 8
    users = rs.randint(0, num_users, 600)
    items = rs.randint(0, num_items, 600)
    jax_data = JaxInteractions(users, items, num_users=num_users,
                               num_items=num_items)
    data = Interactions(users, items, num_users=num_users,
                        num_items=num_items)
    jax_model = JaxImplicitModel(
        loss='bpr', representation=JaxBilinearNet(
            num_users, num_items, dim,
            user_embedding_layer=_jax_bloom_layer(num_users, dim, 0.5, 4),
            item_embedding_layer=_jax_bloom_layer(num_items, dim, 0.5, 4)),
        random_state=np.random.RandomState(0))
    jax_model._initialize(jax_data)
    params = jax.tree_util.tree_map(np.array, jax_model._params)
    for name in ('user_embeddings', 'item_embeddings'):
        params[name]['weight'] = _dyadic(rs, params[name]['weight'].shape)
    for name in ('user_biases', 'item_biases'):
        params[name]['weight'] = _dyadic(rs, params[name]['weight'].shape) / 8
    jax_model._params = jax.tree_util.tree_map(jnp.asarray, params)

    port = ImplicitFactorizationModel(
        loss='bpr', representation=BilinearNet(
            num_users, num_items, dim,
            user_embedding_layer=BloomEmbedding(num_users, dim, 0.5),
            item_embedding_layer=BloomEmbedding(num_items, dim, 0.5)),
        device='cpu')
    port._initialize(data)
    port._load_params(params_from_jax(port._net, params))

    np.testing.assert_array_equal(port.predict(3), jax_model.predict(3))
    np.testing.assert_array_equal(port.predict(users[:20], items[:20]),
                                  jax_model.predict(users[:20], items[:20]))
    np.testing.assert_allclose(evaluation.mrr_score(port, data),
                               jax_eval.mrr_score(jax_model, jax_data),
                               rtol=MRR_RTOL, atol=0)
    for got, want in zip(
            evaluation.precision_recall_score(port, data, k=5),
            jax_eval.precision_recall_score(jax_model, jax_data, k=5)):
        np.testing.assert_array_equal(got, want)
