"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``: a CUDA kernel has no CPU
mode, so without a card each test skips.  The file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel and plain version share one score arithmetic (the exact-tie contract
of ``csrc/common.cuh``), so every comparison of dot scores, counts and ids is
exact.  Mixture scores also go through ``expf``: the kernels' and
``torch.exp``'s come from the CUDA math library and should agree bit for
bit, but the two may be built from different CUDA versions, so mixture
scores are held to within 2 ulp, and the counts and ids they decide
exactly.  The bloom gather-sums and their backward sum in one fixed order
in kernel and plain version alike, so they are held bit for bit, and the
backward to the same bits in two launches.  So is P1, the row-Adam update
(``ops/kernels/row_update.py``): its sums, products, quotients and square
roots are IEEE-rounded one by one in kernel and plain version alike.  A lazy
training step on the card is held to the same step on the CPU: torch sums
the gradients in another order there, so to rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions, SequenceInteractions
from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
from spotlight_tpu_torch.ops.kernels import (bloom, gather_sum, multihot,
                                             ranking, row_update, topk)
from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows
from spotlight_tpu_torch.sequence import ImplicitSequenceModel
from spotlight_tpu_torch.utils.convert import params_from_jax

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc: the CUDA kernels have no '
                    'CPU mode (run on the card: python3 chip_smoke.py)')
    return torch.device('cuda')


def _ulp_gap(a, b):
    """Largest distance in units in the last place between two float32
    tensors of finite values (0 when they are bit-equal)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(bits < 0, -(bits & 0x7fffffff), bits)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def _operands(seed, batch, num_items, dim, dyadic=False, copies=1,
              item_dtype=torch.float32, device='cuda', mixtures=None):
    rs = np.random.RandomState(seed)
    if dyadic:
        def draw(*shape):
            return (rs.randint(-8, 9, shape) / 8).astype(np.float32)
    else:
        def draw(*shape):
            return rs.randn(*shape).astype(np.float32)
    base = num_items // copies
    items = np.tile(draw(base, dim), (copies, 1))
    bias = np.tile(draw(base) / 8, copies)
    users = draw(batch, ranking.user_width(dim, mixtures))
    return (torch.from_numpy(users).to(device),
            torch.from_numpy(items).to(device=device, dtype=item_dtype),
            torch.from_numpy(bias).to(device))


@pytest.mark.parametrize('batch,num_items,dim,width,dtype,dyadic', [
    (100, 5000, 64, 9, torch.float32, False),
    (70, 1000, 32, 130, torch.float32, False),     # two target chunks
    (65, 777, 48, 4, torch.bfloat16, False),       # ragged everywhere
    (1, 64, 64, 1, torch.float32, False),
    (130, 4000, 16, 6, torch.float32, True),       # 200 copies of each row
])
def test_rank_kernels_equal_plain_versions(cuda, batch, num_items, dim,
                                           width, dtype, dyadic):
    users, items, bias = _operands(batch + width, batch, num_items, dim,
                                   dyadic=dyadic, copies=200 if dyadic else 1,
                                   item_dtype=dtype)
    ids = torch.randint(0, num_items, (batch, width),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    ts = ranking.matched_target_scores(users, items, bias, ids)
    assert torch.equal(ts, ranking.matched_target_scores_plain(
        users, items, bias, ids))
    weights = ranking.rank_weights(users, items, bias, ts)
    assert torch.equal(weights, ranking.rank_weights_plain(users, items,
                                                           bias, ts))
    assert bool((weights >= 0.5).all())   # every target tied itself


@pytest.mark.parametrize('k', [1, 10, 34, 134, 256, 300])
@pytest.mark.parametrize('dyadic', [False, True])
def test_topk_kernel_equals_plain_version(cuda, k, dyadic):
    users, items, bias = _operands(k, 70, 5000, 64, dyadic=dyadic,
                                   copies=100 if dyadic else 1)
    got = topk.streaming_topk(users, items, bias, k)
    want = topk.streaming_topk_plain(users, items, bias, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize('k', [7, 130, 600])
def test_topk_kernel_on_an_ascending_catalogue(cuda, k):
    """Scores rise with the id, so every tile beats the whole running
    list: the candidate buffer fills and merges on every tile."""
    num_items = 600
    items = (torch.arange(num_items, dtype=torch.float32) / 64)[:, None]
    items = items.repeat(1, 4).to(cuda)
    users = torch.full((33, 4), 0.25, device=cuda)
    bias = torch.zeros(num_items, device=cuda)
    scores, ids = topk.streaming_topk(users, items, bias, k)
    want = torch.arange(num_items - 1, num_items - 1 - k, -1,
                        dtype=torch.int32, device=cuda)
    assert torch.equal(ids, want.expand(33, k))
    assert torch.equal(scores, topk.streaming_topk_plain(users, items, bias,
                                                         k)[0])


def test_topk_kernel_bf16_and_negative_zero(cuda):
    users, items, bias = _operands(5, 40, 900, 32,
                                   item_dtype=torch.bfloat16)
    got = topk.streaming_topk(users, items, bias, 50)
    want = topk.streaming_topk_plain(users, items, bias, 50)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])

    # A one-term dot of -0.0 plus a -0.0 bias is -0.0: it ties +0.0 in the
    # order, and comes back with its sign.
    users = torch.tensor([[1.0], [-1.0]], device=cuda)
    items = torch.tensor([[0.0], [0.0], [1.0]], device=cuda)
    bias = torch.tensor([-0.0, 0.0, -0.0], device=cuda)
    scores, ids = topk.streaming_topk(users, items, bias, 3)
    want_scores, want_ids = topk.streaming_topk_plain(users, items, bias, 3)
    assert ids.tolist() == want_ids.tolist() == [[2, 0, 1], [0, 1, 2]]
    assert torch.equal(torch.signbit(scores), torch.signbit(want_scores))
    # User 0: 1 + -0, 0 + -0... = +0; user 1: -0 + -0 = -0, -0 + 0 = +0.
    assert torch.signbit(scores).tolist() == [[False, False, False],
                                              [True, False, True]]


def test_each_launch_counts_once(cuda):
    users, items, bias = _operands(2, 64, 1000, 32)
    mix_users, _, _ = _operands(3, 64, 1000, 32, mixtures=2)
    ids = torch.zeros(64, 3, dtype=torch.int64, device=cuda)
    counters = (
        (ranking, 'RANK_WEIGHTS_LAUNCHES'),
        (ranking, 'MATCHED_SCORES_LAUNCHES'),
        (topk, 'STREAMING_TOPK_LAUNCHES'),
        (ranking, 'MIXTURE_RANK_WEIGHTS_LAUNCHES'),
        (ranking, 'CANDIDATE_SCORES_LAUNCHES'),
        (topk, 'MIXTURE_STREAMING_TOPK_LAUNCHES'))
    before = [getattr(module, name) for module, name in counters]
    ts = ranking.matched_target_scores(users, items, bias, ids)
    ranking.rank_weights(users, items, bias, ts)
    topk.streaming_topk(users, items, bias, 20)
    topk.streaming_topk(users, items, bias, topk.SINGLE_LAUNCH_K + 1)
    ts = ranking.matched_candidate_scores(mix_users, items, bias, ids, 2)
    ranking.rank_weights(mix_users, items, bias, ts, 2)
    topk.streaming_topk(mix_users, items, bias, 20, 2)
    after = [getattr(module, name) for module, name in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 3, 1, 1, 1]


@pytest.mark.parametrize('batch,num_items,dim,mixtures,width,dtype', [
    (100, 5000, 64, 4, 1, torch.float32),
    (70, 1000, 32, 2, 40, torch.float32),        # two target chunks
    (33, 777, 16, 8, 3, torch.float32),          # ragged, widest mixture
    (65, 900, 8, 3, 5, torch.bfloat16),
])
def test_mixture_rank_kernels_equal_plain_versions(cuda, batch, num_items,
                                                   dim, mixtures, width,
                                                   dtype):
    users, items, bias = _operands(batch + width, batch, num_items, dim,
                                   item_dtype=dtype, mixtures=mixtures)
    users = users / dim ** .5
    ids = torch.randint(0, num_items, (batch, width),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    ts = ranking.matched_candidate_scores(users, items, bias, ids, mixtures)
    ts_plain = ranking.matched_candidate_scores_plain(users, items, bias,
                                                      ids, mixtures)
    assert _ulp_gap(ts, ts_plain) <= 2
    weights = ranking.rank_weights(users, items, bias, ts, mixtures)
    assert torch.equal(weights, ranking.rank_weights_plain(
        users, items, bias, ts_plain, mixtures))
    assert bool((weights >= 0.5).all())   # every target tied itself
    catalogue = ranking.plain_mixture_scores(users, items, bias, mixtures)
    assert _ulp_gap(ts_plain, torch.gather(catalogue.T, 1, ids)) == 0


@pytest.mark.parametrize('k', [1, 10, 64, 256, 300])
@pytest.mark.parametrize('mixtures', [2, 4])
def test_mixture_topk_kernel_equals_plain_version(cuda, k, mixtures):
    users, items, bias = _operands(k + mixtures, 70, 5000, 64,
                                   mixtures=mixtures)
    users = users / 8
    got = topk.streaming_topk(users, items, bias, k, mixtures)
    want = topk.streaming_topk_plain(users, items, bias, k, mixtures)
    assert torch.equal(got[1], want[1]) and _ulp_gap(got[0], want[0]) <= 2


def test_mixture_duplicated_row_ties_exactly(cuda):
    """Item 6 is a copy of item 5, the target of every user: the kernels
    see the two scores as an exact tie, so every rank is k + 0.5."""
    users, items, bias = _operands(9, 300, 20000, 64, mixtures=4)
    users = users / 8
    items[6], bias[6] = items[5], bias[5]
    ids = torch.full((300, 1), 5, dtype=torch.int64, device=cuda)
    ts = ranking.matched_candidate_scores(users, items, bias, ids, 4)
    ranks = ranking.rank_weights(users, items, bias, ts, 4) + 0.5
    assert bool((ranks % 1 == 0.5).all())


def test_mixture_sequence_metrics_on_the_card_equal_the_cpu(cuda):
    rs = np.random.RandomState(3)
    num_items, dim = 500, 16
    sequences = rs.randint(1, num_items, (64, 12))
    sequences[:5, :4] = 0
    test = SequenceInteractions(sequences, num_items=num_items)
    models = []
    for device in ('cuda', 'cpu'):
        model = ImplicitSequenceModel(representation='mixture',
                                      embedding_dim=dim,
                                      random_state=np.random.RandomState(0),
                                      device=device)
        model._initialize(test)
        models.append(model)
    on_card, on_cpu = models
    state = {name: value.cpu() for name, value in
             on_card._net.state_dict().items()}
    on_cpu._load_params(state)
    for exclude in (False, True):
        np.testing.assert_allclose(
            evaluation.sequence_mrr_score(on_card, test,
                                          exclude_preceding=exclude),
            evaluation.sequence_mrr_score(on_cpu, test,
                                          exclude_preceding=exclude),
            rtol=1e-6, atol=0)
        for got, want in zip(
                evaluation.sequence_precision_recall_score(
                    on_card, test, k=3, exclude_preceding=exclude),
                evaluation.sequence_precision_recall_score(
                    on_cpu, test, k=3, exclude_preceding=exclude)):
            np.testing.assert_array_equal(got, want)


def test_cuda_operands_the_kernels_cannot_take_raise(cuda):
    """A CUDA tensor launches the kernel or raises: nothing falls back."""
    users, items, bias = _operands(3, 8, 200, 16)
    ts = torch.zeros(8, 2, device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        ranking.rank_weights(users, items.T.contiguous().T, bias, ts)
    wide_users, wide_items, wide_bias = _operands(4, 8, 200, 2048)
    with pytest.raises(ValueError, match='shared memory'):
        ranking.rank_weights(wide_users, wide_items, wide_bias, ts)
    with pytest.raises(ValueError, match='shared memory'):
        topk.streaming_topk(wide_users, wide_items, wide_bias, 10)
    with pytest.raises(ValueError, match='several devices'):
        topk.streaming_topk(users.cpu(), items, bias, 10)


def _models(num_users=300, num_items=3000, dim=32):
    rs = np.random.RandomState(0)
    tree = {name: {'weight': (rs.randint(-64, 65, (rows, dim + 1))
                              / 1024).astype(np.float32)}
            for name, rows in (('user_embeddings', num_users),
                               ('item_embeddings', num_items))}
    train = Interactions(rs.randint(0, num_users, 6000),
                         rs.randint(0, num_items, 6000),
                         num_users=num_users, num_items=num_items)
    test = Interactions(rs.randint(0, num_users, 900),
                        rs.randint(0, num_items, 900),
                        num_users=num_users, num_items=num_items)
    models = []
    for device in ('cuda', 'cpu'):
        model = ImplicitFactorizationModel(embedding_dim=dim, device=device)
        model._initialize(train)
        model._load_params(params_from_jax(model._net, tree))
        models.append(model)
    return models, train, test


def test_metrics_on_the_card_equal_the_cpu(cuda):
    (on_card, on_cpu), train, test = _models()
    for kwargs in ({}, {'train': train}):
        np.testing.assert_allclose(
            evaluation.mrr_score(on_card, test, batch_size=100, **kwargs),
            evaluation.mrr_score(on_cpu, test, batch_size=100, **kwargs),
            rtol=1e-6, atol=0)
        for got, want in zip(
                evaluation.precision_recall_score(on_card, test, k=[1, 10],
                                                  **kwargs),
                evaluation.precision_recall_score(on_cpu, test, k=[1, 10],
                                                  **kwargs)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(on_card.predict(5), on_cpu.predict(5),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize('batch,num_items,dim,width,dtype,mixtures', [
    (100, 5000, 64, 9, torch.float32, None),
    (70, 1000, 32, 70, torch.float32, None),      # three target chunks
    (65, 777, 48, 4, torch.bfloat16, None),       # ragged everywhere
    (50, 3000, 32, 4, torch.float32, 4),
    (33, 777, 16, 40, torch.float32, 8),          # two chunks, widest mixture
])
def test_rank_counts_kernel_equals_plain_version(cuda, batch, num_items, dim,
                                                 width, dtype, mixtures):
    """K5's counts exactly, with target ids below 0 and at or past N among
    them (they exclude no row), and target scores both matched (a self tie
    by score, excluded by id) and drawn at random."""
    users, items, bias = _operands(batch + width, batch, num_items, dim,
                                   item_dtype=dtype, mixtures=mixtures)
    if mixtures:
        users = users / dim ** .5
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(-3, num_items + 3, (batch, width),
                        generator=gen).to(cuda)
    safe = ids.clamp(0, num_items - 1)
    if mixtures:
        ts = ranking.matched_candidate_scores(users, items, bias, safe,
                                              mixtures)
    else:
        ts = ranking.matched_target_scores(users, items, bias, safe)
    ts[:, ::2] = torch.randn(batch, (width + 1) // 2, generator=gen).to(cuda)
    greater, equal = ranking.rank_counts(users, items, bias, ts, ids,
                                         mixtures)
    want = ranking.rank_counts_plain(users, items, bias, ts, ids, mixtures)
    assert torch.equal(greater, want[0]) and torch.equal(equal, want[1])
    assert greater.dtype == equal.dtype == torch.float32


def test_rank_counts_ids_outside_the_catalogue_exclude_nothing(cuda):
    """Target ids are compared, never gathered or clamped: -1, N, 2^31 - 1
    and -2^40 leave all N rows in the counts, while a real id leaves out
    exactly its own row."""
    users, items, bias = _operands(1, 8, 500, 16)
    ts = ranking.matched_target_scores(
        users, items, bias, torch.full((8, 1), 7, device=cuda)).repeat(1, 5)
    ids = torch.tensor([[-1, 500, 2 ** 31 - 1, -2 ** 40, 7]],
                       device=cuda).repeat(8, 1)
    greater, equal = ranking.rank_counts(users, items, bias, ts, ids)
    scores = ranking.plain_scores(users, items, bias).T
    above = (scores > ts[:, :1]).sum(dim=1).float()
    same = (scores == ts[:, :1]).sum(dim=1).float()
    assert torch.equal(greater, above[:, None].expand(8, 5))
    assert torch.equal(equal[:, :4], same[:, None].expand(8, 4))
    assert torch.equal(equal[:, 4], same - 1)


def test_reciprocal_ranks_streaming_equals_the_rank_weight_path(cuda):
    """The K1 identity: with matched target scores, K5's counts give the
    rank weights' ranks, so both MRR paths agree bit for bit, ties made by
    a duplicated row included."""
    users, items, bias = _operands(4, 300, 4000, 32)
    items[9], bias[9] = items[3], bias[3]
    targets = torch.randint(0, 4000, (300, 3),
                            generator=torch.Generator().manual_seed(5)).to(
                                cuda)
    targets[:, 0] = 3
    mask = torch.ones_like(targets, dtype=torch.bool)
    mask[::3, 2] = False
    got = ranking.reciprocal_ranks_streaming(users, items, bias, targets,
                                             mask)
    want = evaluation._streaming_ranks_device(users, items, bias, targets,
                                              mask, None)
    assert torch.equal(got, want)


def _bloom_operands(seed, batch, num_rows, dim, hashes, dtype, skew=False):
    rs = np.random.RandomState(seed)
    table = torch.from_numpy(rs.randn(num_rows, dim).astype(np.float32))
    rows = rs.randint(0, num_rows, (batch, hashes))
    rows[0, :2] = 3                           # a duplicated hash
    if skew:
        rows[: batch // 2] = 0                # row 0 takes every padding id
        rows[1::7, -1] = 1
    cotangent = rs.randn(batch, dim).astype(np.float32)
    return (table.to(device='cuda', dtype=dtype),
            torch.from_numpy(rows).to('cuda'),
            torch.from_numpy(cotangent).to(device='cuda', dtype=dtype))


def _bits(x):
    """The raw bits of a float32 or bfloat16 tensor: -0.0 and +0.0 apart."""
    return x.detach().view(torch.int16 if x.dtype == torch.bfloat16
                           else torch.int32)


def _lookup(entry, table, rows):
    name, mask = entry
    if name == 'bloom':
        return bloom.bloom_gather_sum(table, rows)
    return multihot.multihot_gather_sum(table, rows, mask)


def _plain_lookup(entry, table, rows, cotangent):
    """(forward, backward) of the plain versions."""
    name, mask = entry
    rows = rows.to(torch.int32)
    if name == 'bloom':
        return (bloom.bloom_gather_sum_plain(table, rows),
                bloom.bloom_gather_sum_backward_plain(cotangent, rows,
                                                      table.shape[0]))
    return (multihot.multihot_gather_sum_plain(table, rows, mask),
            multihot.multihot_gather_sum_backward_plain(
                cotangent, rows, table.shape[0], mask, table.dtype))


ENTRIES = [('bloom', False), ('multihot', False), ('multihot', True)]


@pytest.mark.parametrize('entry', ENTRIES)
@pytest.mark.parametrize('batch,num_rows,dim,hashes,dtype,skew', [
    (513, 1000, 64, 4, torch.float32, False),
    (300, 64, 128, 24, torch.float32, True),      # every seed, skewed rows
    (77, 40, 30, 2, torch.float32, False),        # no 16-byte vectors
    (129, 300, 64, 4, torch.bfloat16, False),
    (40, 50, 12, 3, torch.bfloat16, True),
    (64, 30, 8, 1, torch.float32, False),         # a single hash
])
def test_gather_sum_kernels_equal_plain_versions(cuda, entry, batch,
                                                 num_rows, dim, hashes, dtype,
                                                 skew):
    """K6 and K7f forward, K6's backward and K7b, bit for bit, and the
    backward in the same bits in two launches."""
    table, rows, cotangent = _bloom_operands(batch + dim, batch, num_rows,
                                             dim, hashes, dtype, skew)
    table.requires_grad_(True)
    out = _lookup(entry, table, rows)
    first, = torch.autograd.grad(out, table, cotangent, retain_graph=True)
    again, = torch.autograd.grad(out, table, cotangent)
    plain_out, plain_grad = _plain_lookup(entry, table.detach(), rows,
                                          cotangent)
    assert out.dtype == first.dtype == dtype
    assert torch.equal(_bits(out), _bits(plain_out))
    assert torch.equal(_bits(first), _bits(again))
    assert torch.equal(_bits(first), _bits(plain_grad))
    if entry == ('multihot', True):
        assert not bool(first[0].any())


def test_gather_sum_rows_out_of_range_raise(cuda):
    table, rows, _ = _bloom_operands(0, 8, 20, 16, 4, torch.float32)
    for bad in (-1, 20):
        rows[3, 1] = bad
        with pytest.raises(ValueError, match='rows must lie in'):
            bloom.bloom_gather_sum(table, rows)
        with pytest.raises(ValueError, match='rows must lie in'):
            multihot.multihot_gather_sum(table, rows, True)
    with pytest.raises(ValueError, match='several devices'):
        bloom.bloom_gather_sum(table, rows.cpu())


def test_each_new_launch_counts_once(cuda):
    users, items, bias = _operands(2, 64, 1000, 32)
    mix_users, _, _ = _operands(3, 64, 1000, 32, mixtures=2)
    ids = torch.zeros(64, 3, dtype=torch.int64, device=cuda)
    ts = torch.zeros(64, 3, device=cuda)
    table, rows, cotangent = _bloom_operands(1, 50, 100, 16, 4,
                                             torch.float32)
    table.requires_grad_(True)
    counters = (
        (ranking, 'RANK_COUNTS_LAUNCHES'),
        (ranking, 'MIXTURE_RANK_COUNTS_LAUNCHES'),
        (bloom, 'BLOOM_GATHER_LAUNCHES'),
        (bloom, 'BLOOM_GATHER_BACKWARD_LAUNCHES'),
        (multihot, 'MULTIHOT_LAUNCHES'),
        (multihot, 'MULTIHOT_BACKWARD_LAUNCHES'))
    before = [getattr(module, name) for module, name in counters]
    ranking.rank_counts(users, items, bias, ts, ids)
    ranking.rank_counts(mix_users, items, bias, ts, ids, 2)
    torch.autograd.grad(bloom.bloom_gather_sum(table, rows), table,
                        cotangent)
    torch.autograd.grad(multihot.multihot_gather_sum(table, rows), table,
                        cotangent)
    after = [getattr(module, name) for module, name in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 1, 1]
    assert gather_sum.check_operands(table, rows).dtype == torch.int32


def _row_operands(seed, num_rows, width, n, dtype, device):
    """Occurrence ids with repeats (row 3 ten times, the sentinel row count
    three times), a table, warm moments and gradient rows, on ``device``."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, num_rows, n)
    ids[:10] = 3
    ids[-3:] = num_rows
    param = torch.from_numpy(rs.randn(num_rows, width).astype(np.float32))
    mu = torch.from_numpy((0.01 * rs.randn(num_rows, width)).astype(
        np.float32))
    nu = torch.from_numpy((1e-4 * rs.rand(num_rows, width)).astype(
        np.float32))
    grads = torch.from_numpy((0.1 * rs.randn(n, width)).astype(np.float32))
    grads[10:12] = -0.0
    return (torch.from_numpy(ids).to(device), param.to(device, dtype),
            mu.to(device), nu.to(device), grads.to(device))


@pytest.mark.parametrize('num_rows,width,n,dtype,l2,t', [
    (1000, 65, 4096, torch.float32, 1e-6, 7),
    (1000, 65, 4096, torch.bfloat16, 1e-6, 7),
    (5000, 128, 24576, torch.float32, 0.0, 5),
    (300, 33, 5000, torch.float32, 0.0, 1),        # deep segments
    (70, 1, 40, torch.bfloat16, 1e-3, 1000),
])
def test_row_adam_kernel_equals_plain_version(cuda, num_rows, width, n,
                                              dtype, l2, t):
    ids, param, mu, nu, grads = _row_operands(n + width, num_rows, width, n,
                                              dtype, cuda)
    segments = row_update.prepare_segments(ids)
    scalars = row_update.adam_scalars(t, 1e-2, l2)
    results = []
    for _ in range(2):
        p, m, v = param.clone(), mu.clone(), nu.clone()
        row_update.row_adam(p, m, v, grads, segments, scalars)
        results.append((p, m, v))
    p, m, v = param.clone(), mu.clone(), nu.clone()
    row_update.row_adam_plain(p, m, v, grads, segments, scalars)
    torch.cuda.synchronize()
    for got in results:
        for a, b in zip(got, (p, m, v)):
            assert torch.equal(_bits(a), _bits(b))
    assert not torch.equal(results[0][0], param)
    # The sentinel row count updates nothing; untouched rows stay.
    untouched = torch.ones(num_rows, dtype=torch.bool, device=cuda)
    untouched[ids[ids < num_rows]] = False
    assert torch.equal(results[0][1][untouched], mu[untouched])


def test_row_adam_kernel_matches_the_cpu(cuda):
    """The whole of ``sparse_adam_rows`` on the card against the CPU: both
    run the same IEEE-rounded arithmetic, so bit for bit."""
    cpu = _row_operands(9, 400, 65, 2000, torch.float32, 'cpu')
    card = [x.to(cuda) for x in cpu]
    sparse_adam_rows(*cpu[:4], cpu[4], 3, 1e-2, 1e-6)
    sparse_adam_rows(*card[:4], card[4], 3, 1e-2, 1e-6)
    for a, b in zip(cpu[1:4], card[1:4]):
        assert torch.equal(_bits(a), _bits(b.cpu()))


def test_row_adam_launch_counts_once(cuda):
    ids, param, mu, nu, grads = _row_operands(1, 50, 8, 64, torch.float32,
                                              cuda)
    before = row_update.ROW_ADAM_LAUNCHES
    sparse_adam_rows(ids, param, mu, nu, grads, 1, 1e-2)
    assert row_update.ROW_ADAM_LAUNCHES == before + 1
    row_update.row_adam_plain(param, mu, nu, grads,
                              row_update.prepare_segments(ids),
                              row_update.adam_scalars(2, 1e-2))
    assert row_update.ROW_ADAM_LAUNCHES == before + 1


def _lazy_model(device, loss, negative_sampling):
    model = ImplicitFactorizationModel(
        loss=loss, embedding_dim=16, batch_size=256, sparse=True, l2=1e-6,
        negative_sampling=negative_sampling,
        random_state=np.random.RandomState(4), device=device)
    rs = np.random.RandomState(2)
    data = Interactions(rs.randint(0, 200, 1000), rs.randint(0, 150, 1000),
                        num_users=200, num_items=150)
    model._initialize(data)
    return model, data


@pytest.mark.parametrize('loss,negative_sampling', [
    ('bpr', 'uniform'), ('adaptive_hinge', 'uniform'),
    ('pointwise', 'in_batch')])
def test_lazy_epoch_on_the_card_matches_the_cpu(cuda, loss,
                                                negative_sampling):
    """The same seed gives the same draws on both devices (the generator is
    on the CPU); an epoch of four steps on the card, every row update
    through P1, stays within rtol 1e-5 of the CPU's."""
    launches = row_update.ROW_ADAM_LAUNCHES
    results = []
    for device in ('cpu', cuda):
        model, data = _lazy_model(device, loss, negative_sampling)
        model._n_iter = 1
        model.fit(data)
        results.append(model)
    assert row_update.ROW_ADAM_LAUNCHES == launches + 2 * 4
    assert results[1]._opt_state['t'] == results[0]._opt_state['t'] == 4
    np.testing.assert_allclose(results[1]._last_epoch_loss,
                               results[0]._last_epoch_loss, rtol=1e-5)
    # Adam normalises each gradient: where one is a difference of near-equal
    # terms, the summation order moves its step by up to ~1e-6 (as between
    # the port and JAX on the CPU), and four steps add up.
    for name, value in results[0]._net.state_dict().items():
        torch.testing.assert_close(results[1]._net.state_dict()[name].cpu(),
                                   value, rtol=1e-5, atol=1e-5)
    for moment in ('mu', 'nu'):
        for name, value in results[0]._opt_state[moment].items():
            torch.testing.assert_close(
                results[1]._opt_state[moment][name].cpu(), value,
                rtol=1e-5, atol=1e-7)


def test_dense_fit_on_the_card_matches_the_cpu(cuda):
    results = []
    for device in ('cpu', cuda):
        model = ImplicitFactorizationModel(
            loss='hinge', embedding_dim=16, n_iter=2, batch_size=256,
            random_state=np.random.RandomState(4), device=device)
        rs = np.random.RandomState(2)
        model.fit(Interactions(rs.randint(0, 200, 1000),
                               rs.randint(0, 150, 1000), num_users=200,
                               num_items=150))
        results.append(model)
    assert not results[1]._lazy
    for name, value in results[0]._net.state_dict().items():
        torch.testing.assert_close(results[1]._net.state_dict()[name].cpu(),
                                   value, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('sparse', [True, False], ids=['lazy', 'dense'])
def test_training_steps_never_synchronise(cuda, sparse):
    """A step reads nothing back to the host: the epoch's loss is read one
    epoch late, and the number of distinct rows stays on the device.  Run
    with CUDA's synchronisation check set to raise; the epoch's draws (one
    copy in) come before it."""
    from spotlight_tpu_torch.utils import training

    model, data = _lazy_model(cuda, 'adaptive_hinge', 'uniform')
    if not sparse:
        model = ImplicitFactorizationModel(
            loss='adaptive_hinge', embedding_dim=16, batch_size=256,
            random_state=np.random.RandomState(4), device=cuda)
        model._initialize(data)
    placed, n_valid, num_batches = model._epoch_data(data)
    perm, negatives = training.epoch_draws(
        model._generator, num_batches * 256,
        (num_batches, model._num_step_negatives, 256), 150, cuda)
    step = model._step_fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        loss = training.run_epoch(step, placed, n_valid, num_batches, 256,
                                  perm, negatives)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert np.isfinite(float(loss))


@pytest.mark.parametrize('table', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('sparse', [True, False], ids=['lazy', 'dense'])
@pytest.mark.parametrize('negative_sampling', ['uniform', 'in_batch'])
@pytest.mark.parametrize('loss', ['pointwise', 'bpr', 'hinge',
                                  'adaptive_hinge'])
def test_fit_trains_on_the_card(cuda, loss, negative_sampling, sparse,
                                table):
    """``fit`` on the card, with the default device, for every loss,
    sampling, engine and table dtype: the loss is finite and every table
    moves, in its own dtype."""
    from spotlight_tpu_torch.factorization import BilinearNet

    rs = np.random.RandomState(6)
    data = Interactions(rs.randint(0, 200, 1500), rs.randint(0, 150, 1500),
                        num_users=200, num_items=150)
    net = BilinearNet(200, 150, 16, table_dtype=table,
                      generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    model = ImplicitFactorizationModel(
        loss=loss, n_iter=2, batch_size=512, sparse=sparse,
        negative_sampling=negative_sampling, representation=net,
        random_state=np.random.RandomState(1))
    launches = row_update.ROW_ADAM_LAUNCHES
    assert model.fit(data) is model
    assert model._device.type == 'cuda' and model._lazy == sparse
    assert row_update.ROW_ADAM_LAUNCHES == launches + (12 if sparse else 0)
    assert np.isfinite(model._last_epoch_loss)
    for name, value in model._net.state_dict().items():
        assert value.dtype == table and value.is_cuda
        assert not torch.equal(value.cpu(), before[name])
