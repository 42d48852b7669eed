"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc``: a CUDA kernel has no CPU
mode, so without a card each test skips.  The file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Kernel and plain version share one score arithmetic (the exact-tie contract
of ``csrc/common.cuh``), so every comparison of dot scores, counts and ids is
exact.  Mixture scores also go through ``expf``: the kernels' and
``torch.exp``'s come from the CUDA math library and agree bit for bit, so
K4's and the top-k kernel's mixture scores are held bit for bit too.  The
bloom gather-sums and their backward sum in one fixed order in kernel and
plain version alike, so they are held bit for bit, and the
backward to the same bits in two launches.  So is P1, the row-Adam update
(``ops/kernels/row_update.py``): its sums, products, quotients and square
roots are IEEE-rounded one by one in kernel and plain version alike.  A lazy
training step on the card is held to the same step on the CPU: torch sums
the gradients in another order there, so to rtol 1e-5.  The LayerNorm
kernel (``ops/kernels/layer_norm.py``) sums a row as a warp's butterfly,
another order than its plain version's and ``F.layer_norm``'s, so it is held
to both within a stated tolerance.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions, SequenceInteractions
from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
from spotlight_tpu_torch.ops.kernels import (_build, bloom, gather_sum,
                                             layer_norm, multihot, ranking,
                                             row_update, topk)
from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows
from spotlight_tpu_torch.sequence import ImplicitSequenceModel, MixtureLSTMNet
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


# The dot rank kernel's edges: item tiles of 128, dimension slabs of 32,
# blocks of 64 users, 4 targets held in registers (a narrow launch), 128
# sorted targets a wide launch up to D = 383, fewer above, D <= 768.
RANK_EDGES = [
    (65, 129, 33, 4, torch.float32, False),        # T at the register count
    (130, 1000, 48, 5, torch.bfloat16, False),     # one past: a wide launch
    (64, 1000, 33, 128, torch.float32, False),     # the widest launch
    (3, 129, 65, 129, torch.float32, False),       # two launches
    (40, 700, 8, 9, torch.float32, False),         # one slab a tile, wide
    (66, 2000, 40, 2, torch.bfloat16, True),       # dyadic ties, bf16
    (129, 1000, 17, 17, torch.float32, True),      # dyadic ties, wide
    (3, 300, 400, 70, torch.float32, False),       # 64 targets a launch
    (2, 300, 768, 9, torch.float32, False),        # the widest embedding
]


@pytest.mark.parametrize('batch,num_items,dim,width,dtype,dyadic', [
    (100, 5000, 64, 9, torch.float32, False),
    (70, 1000, 32, 130, torch.float32, False),     # two target chunks
    (65, 777, 48, 4, torch.bfloat16, False),       # ragged everywhere
    (1, 64, 64, 1, torch.float32, False),
    (130, 4000, 16, 6, torch.float32, True),       # 200 copies of each row
] + RANK_EDGES)
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


@pytest.mark.parametrize('num_items', [127, 128, 129, 1000])
@pytest.mark.parametrize('dim', [1, 3, 4, 5, 64])
def test_topk_kernel_tile_edges(cuda, num_items, dim):
    """Ragged item tiles (128 items), dimension slabs (32) and user blocks
    (64 users at lists of 16-64 keys, 32 at 128-256), at every list width,
    a bf16 table among them, and a resumed fetch."""
    for batch, dtype in ((1, torch.float32), (63, torch.float32),
                         (65, torch.bfloat16), (200, torch.float32)):
        users, items, bias = _operands(num_items + dim + batch, batch,
                                       num_items, dim, item_dtype=dtype)
        for k in (1, 16, 17, 64, 65, 256):
            if k > num_items:
                continue
            got = topk.streaming_topk(users, items, bias, k)
            want = topk.streaming_topk_plain(users, items, bias, k)
            assert torch.equal(got[1], want[1]), (batch, k)
            assert torch.equal(got[0], want[0]), (batch, k)
        # Resume strictly after each user's 17th key.
        resume_score, resume_id = want[0][:, 16], want[1][:, 16]
        k = min(65, num_items - 17)
        got = topk._topk_call(users, items, bias, k, None,
                              resume_score.contiguous(),
                              resume_id.contiguous())
        want = topk.streaming_topk_plain(users, items, bias, k, None,
                                         resume_score, resume_id)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize('k', [1, 34, 143, 256])
def test_topk_kernel_on_a_descending_catalogue(cuda, k):
    """Scores fall with the id, so each split's first tile holds its best
    items: the warm start fills the lists at once and no later key
    passes the threshold."""
    num_items = 1000
    items = ((num_items - torch.arange(num_items, dtype=torch.float32))
             / 64)[:, None].repeat(1, 4).to(cuda)
    users = torch.full((70, 4), 0.25, device=cuda)
    bias = torch.zeros(num_items, device=cuda)
    scores, ids = topk.streaming_topk(users, items, bias, k)
    want = torch.arange(k, dtype=torch.int32, device=cuda)
    assert torch.equal(ids, want.expand(70, k))
    assert torch.equal(scores, topk.streaming_topk_plain(users, items, bias,
                                                         k)[0])


@pytest.mark.parametrize('k', [1, 34, 256, 300])
def test_topk_kernel_on_an_all_equal_catalogue(cuda, k):
    """Every key ties at the threshold score, so the id alone orders them."""
    num_items = 1000
    users, _, _ = _operands(k, 70, num_items, 8)
    items = torch.ones(num_items, 8, device=cuda)
    bias = torch.full((num_items,), 0.5, device=cuda)
    scores, ids = topk.streaming_topk(users, items, bias, k)
    want = torch.arange(k, dtype=torch.int32, device=cuda)
    assert torch.equal(ids, want.expand(70, k))
    assert torch.equal(scores, topk.streaming_topk_plain(users, items, bias,
                                                         k)[0])


def test_topk_kernel_repeats_its_bits(cuda):
    users, items, bias = _operands(11, 200, 5000, 64)
    first = topk.streaming_topk(users, items, bias, 34)
    second = topk.streaming_topk(users, items, bias, 34)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1],
                                                            second[1])


@pytest.mark.parametrize('k, widest', [(10, 261), (34, 261), (143, 525),
                                       (256, 525)])
def test_topk_kernel_widest_embedding(cuda, k, widest):
    """Dot stage 1 holds its users' vectors in shared memory beside the
    keys: the widest width that fits runs exact, one more raises."""
    users, items, bias = _operands(k, 70, 300, widest)
    got = topk.streaming_topk(users, items, bias, k)
    want = topk.streaming_topk_plain(users, items, bias, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    users, items, bias = _operands(k, 70, 300, widest + 1)
    with pytest.raises(ValueError, match='shared memory'):
        topk.streaming_topk(users, items, bias, k)


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


@pytest.mark.parametrize('mixtures', [None, 4])
def test_ragged_rank_weights_equal_plain_versions(cuda, mixtures):
    """Rows of Zipf-like target counts, most at 4 or fewer and a few past
    128 and 256, NaN after each row's real targets: given the counts, the
    kernel runs only on the (rows, chunk) pairs that hold a target
    (``rank_launches``), and the weights equal the plain version's bit for
    bit, ``rank_weights``' without widths on the same rows (every chunk)
    and the chunk loop's over the same rows without pads, with 0 on every
    pad."""
    batch, num_items, dim, widest = 300, 20_000, 64, 300
    users, items, bias = _operands(17, batch, num_items, dim,
                                   mixtures=mixtures)
    if mixtures:
        users = users / dim ** .5
    rs = np.random.RandomState(5)
    widths = np.minimum(widest, 1 + np.floor(rs.pareto(1.1, batch)))
    widths = widths.astype(np.int64)
    widths[:3] = (widest, 257, 129)
    rs.shuffle(widths)
    ids = torch.from_numpy(rs.randint(0, num_items, (batch, widest))).to(cuda)
    pads = (torch.arange(widest, device=cuda)[None, :]
            >= torch.as_tensor(widths, device=cuda)[:, None])
    if mixtures:
        full = ranking.matched_candidate_scores(users, items, bias, ids,
                                                mixtures)
    else:
        full = ranking.matched_target_scores(users, items, bias, ids)
    ts = full.masked_fill(pads, float('nan'))

    names = ('RANK_WEIGHTS_ROW_PASSES',
             'MIXTURE_RANK_WEIGHTS_LAUNCHES' if mixtures
             else 'RANK_WEIGHTS_LAUNCHES')
    before = [getattr(ranking, name) for name in names]
    weights = ranking.rank_weights(users, items, bias, ts, mixtures,
                                   widths)
    moved = [getattr(ranking, name) - b for name, b in zip(names, before)]
    assert torch.equal(weights, ranking.rank_weights_plain(
        users, items, bias, ts, mixtures))
    assert torch.equal(weights, ranking.rank_weights(users, items, bias, ts,
                                                     mixtures))
    assert bool((weights[pads] == 0).all())
    unpadded = ranking.rank_weights(users, items, bias, full, mixtures)
    assert torch.equal(weights[~pads], unpadded[~pads])
    assert bool((weights[~pads] >= 0.5).all())   # every target tied itself

    lib = _build.load('ranking')
    chunk = lib.spotlight_rank_max_targets(dim, mixtures or 0)
    assert chunk == (32 if mixtures else 128)
    plan = ranking.rank_launches(
        np.sort(widths)[::-1].copy(), widest, chunk,
        ranking.range_widths(chunk, mixtures or 0),
        lib.spotlight_rank_block_users(mixtures or 0))
    row_passes = sum(end - first for first, end, _, _ in plan)
    assert moved == [row_passes, len(plan)]
    assert row_passes < 0.5 * batch * -(-widest // chunk)


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
    assert _same_bits(ts, ts_plain)
    weights = ranking.rank_weights(users, items, bias, ts, mixtures)
    assert torch.equal(weights, ranking.rank_weights_plain(
        users, items, bias, ts_plain, mixtures))
    assert bool((weights >= 0.5).all())   # every target tied itself
    catalogue = ranking.plain_mixture_scores(users, items, bias, mixtures)
    assert _ulp_gap(ts_plain, torch.gather(catalogue.T, 1, ids)) == 0


def _mixture_rank_operands(seed, batch, num_items, dim, mixtures, dtype):
    """Mixture operands with exact ties and signed zeros among the scores:
    item 6 copies item 5, every seventh item has bias 0, and the first
    users have all-zero tastes (their scores against those items are
    +-0.0)."""
    users, items, bias = _operands(seed, batch, num_items, dim,
                                   item_dtype=dtype, mixtures=mixtures)
    users = users / dim ** .5
    items[6], bias[6] = items[5], bias[5]
    bias[::7] = 0.0
    users[:3, :mixtures * dim] = 0.0
    return users, items, bias


def _check_mixture_rank(users, items, bias, mixtures, width, seed):
    """K1 and K5 with mixture scoring against their plain versions on the
    same target scores, exactly: K1 on K4's target scores (each target
    ties itself), K5 with target ids in and outside [0, N) and target
    scores matched, drawn at random, -0.0 and +0.0."""
    batch, num_items = users.shape[0], items.shape[0]
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, num_items, (batch, width), generator=gen).to('cuda')
    ids[:, 0] = 5
    ts = ranking.matched_candidate_scores(users, items, bias, ids, mixtures)
    weights = ranking.rank_weights(users, items, bias, ts, mixtures)
    assert torch.equal(weights, ranking.rank_weights_plain(
        users, items, bias, ts, mixtures))
    assert bool((weights >= 0.5).all())   # every target tied itself
    # Item 5's duplicate, item 6, ties it: item 5's weight counts it.
    assert bool((weights[:, 0] >= 1.0).all())

    tids = torch.randint(-3, num_items + 3, (batch, width),
                         generator=gen).to('cuda')
    ts = ranking.matched_candidate_scores(
        users, items, bias, tids.clamp(0, num_items - 1), mixtures)
    ts[:, 1::2] = torch.randn(batch, width // 2, generator=gen).to('cuda')
    ts[::2, -1] = -0.0
    ts[1::2, -1] = 0.0
    greater, equal = ranking.rank_counts(users, items, bias, ts, tids,
                                         mixtures)
    want = ranking.rank_counts_plain(users, items, bias, ts, tids, mixtures)
    assert torch.equal(greater, want[0]) and torch.equal(equal, want[1])


@pytest.mark.parametrize('dim', [1, 33, 64])
@pytest.mark.parametrize('mixtures', [1, 2, 3, 4, 8])
def test_mixture_rank_pass_equals_plain_versions(cuda, mixtures, dim):
    """K1 and K5 with mixture scoring (the register-tiled rank pass) for
    every padding of M (1 and 2 in 4 columns a user, 3 and 4 in 8, 8 in
    16), at T = 1 and 4 (targets in registers), 5 and 32 (sorted targets)
    and 33 (two launches), bf16 items at odd widths, over catalogues that
    end inside a 128-item tile."""
    dtype = torch.bfloat16 if dim == 33 else torch.float32
    users, items, bias = _mixture_rank_operands(
        mixtures * 10 + dim, 37, 1000 + dim, dim, mixtures, dtype)
    for width in (1, 4, 5, 32, 33):
        _check_mixture_rank(users, items, bias, mixtures, width, width)


@pytest.mark.parametrize('mixtures,widest', [(4, 387), (8, 193)])
def test_mixture_rank_pass_widest_embedding(cuda, mixtures, widest):
    """16 resident users of 2M columns fill a block's shared memory at
    D = 387 (M <= 4) and 193 (M <= 8); a launch takes fewer targets there
    (the sorted targets no longer fit), and one dimension more raises."""
    users, items, bias = _mixture_rank_operands(
        widest, 20, 300, widest + 1, mixtures, torch.float32)
    ts = torch.zeros(20, 5, device=cuda)
    ids = torch.zeros(20, 5, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match='shared memory'):
        ranking.rank_weights(users, items, bias, ts, mixtures)
    with pytest.raises(ValueError, match='shared memory'):
        ranking.rank_counts(users, items, bias, ts, ids, mixtures)
    users = users.reshape(20, 2 * mixtures, widest + 1)[:, :, :widest]
    users = users.reshape(20, -1).contiguous()
    items = items[:, :widest].contiguous()
    _check_mixture_rank(users, items, bias, mixtures, 5, 11)


@pytest.mark.parametrize('k', [1, 10, 64, 256, 300])
@pytest.mark.parametrize('mixtures', [2, 4])
def test_mixture_topk_kernel_equals_plain_version(cuda, k, mixtures):
    users, items, bias = _operands(k + mixtures, 70, 5000, 64,
                                   mixtures=mixtures)
    users = users / 8
    got = topk.streaming_topk(users, items, bias, k, mixtures)
    want = topk.streaming_topk_plain(users, items, bias, k, mixtures)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def _assert_same_topk(got, want, what):
    assert torch.equal(got[1], want[1]), what
    assert torch.equal(got[0].view(torch.int32),
                       want[0].view(torch.int32)), what   # signs of zeros


@pytest.mark.parametrize('dim', [16, 64, 100])
@pytest.mark.parametrize('mixtures', [1, 2, 3, 4, 8])
def test_mixture_topk_stage1_equals_plain_version(cuda, mixtures, dim):
    """K2 with mixture scoring (stage 1 on the rank pass's register tile)
    bit for bit: every padding of M (2, 4 or 8 columns a component), one
    slab, a ragged second and a ragged fourth, lists of 16 to 256 keys and
    300 in two rounds, float32 and bf16 tables, catalogues that end inside
    a 128-item tile, user blocks that end inside 16 users; scores with exact
    ties and signed zeros (_mixture_rank_operands)."""
    num_items = 1000 + dim + mixtures
    for dtype in (torch.float32, torch.bfloat16):
        users, items, bias = _mixture_rank_operands(
            mixtures * 100 + dim, 37, num_items, dim, mixtures, dtype)
        for k in (1, 10, 59, 143, 256, 300):
            _assert_same_topk(
                topk.streaming_topk(users, items, bias, k, mixtures),
                topk.streaming_topk_plain(users, items, bias, k, mixtures),
                (dtype, k))


def test_mixture_topk_kernel_on_an_all_equal_catalogue(cuda):
    """Every mixture score ties, so the id alone orders the keys, through
    warm starts, merges and a resumed round."""
    users, _, _ = _operands(3, 40, 700, 8, mixtures=4)
    items = torch.ones(700, 8, device=cuda)
    bias = torch.full((700,), 0.5, device=cuda)
    for k in (1, 34, 256, 300):
        scores, ids = topk.streaming_topk(users, items, bias, k, 4)
        want = torch.arange(k, dtype=torch.int32, device=cuda)
        assert torch.equal(ids, want.expand(40, k))
        assert torch.equal(scores, topk.streaming_topk_plain(
            users, items, bias, k, 4)[0])


def test_mixture_topk_kernel_resumes_and_repeats_its_bits(cuda):
    """A fetch that resumes strictly after each user's 17th key, and the
    same fetch twice in the same bits."""
    users, items, bias = _mixture_rank_operands(8, 50, 2000, 32, 4,
                                                torch.float32)
    first = topk.streaming_topk(users, items, bias, 40, 4)
    _assert_same_topk(first, topk.streaming_topk(users, items, bias, 40, 4),
                      'repeat')
    resume_score = first[0][:, 16].contiguous()
    resume_id = first[1][:, 16].contiguous()
    _assert_same_topk(
        topk._topk_call(users, items, bias, 65, 4, resume_score, resume_id),
        topk.streaming_topk_plain(users, items, bias, 65, 4, resume_score,
                                  resume_id), 'resume')


@pytest.mark.parametrize('k,mixtures,widest', [
    (10, 2, 647), (64, 4, 323), (34, 8, 161),     # lists of 16-64 keys
    (143, 2, 519), (256, 4, 259), (65, 8, 129),   # lists of 128-256 keys
])
def test_mixture_topk_kernel_widest_embedding(cuda, k, mixtures, widest):
    """16 mixture users of 2 MP columns beside 256-key rows (512 past 64
    keys) fill a block's shared memory at these widths: the widest runs
    exact, one more raises in the wrapper and is refused by the route
    query."""
    users, items, bias = _mixture_rank_operands(
        widest, 20, 300, widest + 1, mixtures, torch.float32)
    assert topk.streams(k, widest, mixtures, cuda)
    assert not topk.streams(k, widest + 1, mixtures, cuda)
    with pytest.raises(ValueError, match='shared memory'):
        topk.streaming_topk(users, items, bias, k, mixtures)
    users = users.reshape(20, 2 * mixtures, widest + 1)[:, :, :widest]
    users = users.reshape(20, -1).contiguous()
    items = items[:, :widest].contiguous()
    _assert_same_topk(topk.streaming_topk(users, items, bias, k, mixtures),
                      topk.streaming_topk_plain(users, items, bias, k,
                                                mixtures), 'widest')


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


def test_eval_rows_are_built_on_the_card(cuda):
    """A call of the MF ranking cell's profile, small: 2,048 users drawn as
    ``benchmark.data.call_rows`` draws them from the cell's activity profile
    (at least 10 items a user, at most 5,000, 47.5 on average), cut to
    100,000 users and 20,000 items, with a 20% test split.  In one batch, as
    the cell's, and in three of different widths, the padded rows that
    ``_batches`` builds on the card from the real ids equal the CSR's rows,
    padded with -1 to the batch's widest, bit for bit, and building them
    waits on nothing (``set_sync_debug_mode('error')``).  The whole call's
    batch is sent up in under 2% of its padded matrices' bytes."""
    from benchmark.data import activity_counts, call_rows

    num_users, num_items = 100000, 20000
    activity = activity_counts(num_users, 4750000, 10, 5000, 1.0)
    rs = np.random.RandomState(0)
    held_out = rs.binomial(activity, 0.2)
    population = np.flatnonzero(held_out)
    users = call_rows(population, held_out[population], 2048, 1, 3)[0]

    def pairs(counts):
        # Repeated draws of a user's item are pairs the CSR merges.
        return Interactions(np.repeat(users, counts),
                            rs.randint(0, num_items, int(counts.sum())),
                            num_users=num_users, num_items=num_items)

    def padded(csr, part):
        width = max(int(np.diff(csr.indptr)[part].max()), 1)
        out = np.full((len(part), width), -1, np.int64)
        for row, user in enumerate(part):
            ids = csr.indices[csr.indptr[user]:csr.indptr[user + 1]]
            out[row, :len(ids)] = ids
        return torch.from_numpy(out)

    test = pairs(held_out[users])
    train = pairs(activity[users] - held_out[users])
    for given in (None, train):
        rows = evaluation._eval_rows(test, given)
        test_csr = test.tocsr()
        for batch_size, batches in ((2048, 1), (700, 3)):
            host = []
            for start in range(0, len(rows[0]), batch_size):
                part = rows[0][start:start + batch_size]
                host.append((part, padded(test_csr, part),
                             None if given is None
                             else padded(given.tocsr(), part),
                             np.diff(test_csr.indptr)[part]))
            list(evaluation._batches(*rows, batch_size, cuda))   # warm
            torch.cuda.synchronize()
            sent = evaluation.ROW_UPLOAD_BYTES
            torch.cuda.set_sync_debug_mode('error')
            try:
                on_card = list(evaluation._batches(*rows, batch_size, cuda))
            finally:
                torch.cuda.set_sync_debug_mode('default')
            sent = evaluation.ROW_UPLOAD_BYTES - sent
            assert len(on_card) == len(host) == batches
            padded_bytes = 0
            for got, want in zip(on_card, host):
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[4], want[3])
                for got_rows, want_rows in zip(got[1:4:2], want[1:3]):
                    if want_rows is None:
                        assert got_rows is None
                        continue
                    assert got_rows.device.type == 'cuda'
                    assert got_rows.dtype == want_rows.dtype == torch.int64
                    assert torch.equal(got_rows.cpu(), want_rows)
                    padded_bytes += want_rows.numel() * 8
            if batches == 1:
                assert 0 < sent < 0.02 * padded_bytes, (sent, padded_bytes)


def _routed(metric, model, test, **kwargs):
    """(streamed result, its route count, streaming=False's result)."""
    before = evaluation.MATERIALIZE_ROUTES
    got = metric(model, test, **kwargs)
    routes = evaluation.MATERIALIZE_ROUTES - before
    return got, routes, metric(model, test, streaming=False, **kwargs)


def _assert_metric(got, want):
    if isinstance(got, tuple):
        for got_part, want_part in zip(got, want):
            np.testing.assert_array_equal(got_part, want_part)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize('dim,routes', [(262, (0, 1)), (526, (0, 1)),
                                        (769, (1, 1))])
def test_metrics_past_the_kernels_widths_route_to_materialize(cuda, dim,
                                                              routes):
    """A BilinearNet wider than the kernels take: the rank kernel takes
    D <= 768, the top-10 fetch's stage 1 D <= 261.  A metric the kernels
    refuse runs on the materialize path, counted once; every metric equals
    streaming=False's (the dyadic weights score exactly in any order)."""
    (model, _), train, test = _models(dim=dim)
    mrr = _routed(evaluation.mrr_score, model, test, train=train)
    pr = _routed(evaluation.precision_recall_score, model, test, k=10)
    assert (mrr[1], pr[1]) == routes
    for got, _, want in (mrr, pr):
        _assert_metric(got, want)


def _sequence_model(dim, mixtures, num_items=500):
    """An untrained mixture model of M tastes on the card, and 64 test
    sequences."""
    rs = np.random.RandomState(dim + mixtures)
    sequences = rs.randint(1, num_items, (64, 12))
    sequences[:5, :4] = 0
    test = SequenceInteractions(sequences, num_items=num_items)
    net = MixtureLSTMNet(num_items, dim, num_mixtures=mixtures,
                         generator=torch.Generator().manual_seed(0))
    model = ImplicitSequenceModel(representation=net, embedding_dim=dim,
                                  device='cuda')
    model._initialize(test)
    return model, test


@pytest.mark.parametrize('dim,mixtures,routes', [
    (324, 4, (0, 1)),     # one past stage 1's M=4 width at a top-3 fetch
    (16, 9, (1, 1)), (16, 12, (1, 1)),     # more tastes than the kernels
    (16, 8, (0, 0)),
])
def test_sequence_metrics_route_past_the_kernels(cuda, dim, mixtures,
                                                 routes):
    model, test = _sequence_model(dim, mixtures)
    for exclude in (False, True):
        mrr = _routed(evaluation.sequence_mrr_score, model, test,
                      exclude_preceding=exclude)
        pr = _routed(evaluation.sequence_precision_recall_score, model,
                     test, k=3, exclude_preceding=exclude)
        assert (mrr[1], pr[1]) == routes
        for got, _, want in (mrr, pr):
            _assert_metric(got, want)


@pytest.mark.parametrize('batch,num_items,dim,width,dtype,mixtures', [
    (100, 5000, 64, 9, torch.float32, None),
    (70, 1000, 32, 70, torch.float32, None),
    (65, 777, 48, 4, torch.bfloat16, None),       # ragged everywhere
    (50, 3000, 32, 4, torch.float32, 4),
    (33, 777, 16, 40, torch.float32, 8),          # two chunks, widest mixture
] + [(batch, num_items, dim, width, dtype, None)
     for batch, num_items, dim, width, dtype, _ in RANK_EDGES])
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


@pytest.mark.parametrize('width', [1, 4, 5, 129])
def test_rank_counts_kernel_dyadic_ties(cuda, width):
    """On a catalogue of 50 copies of 40 dyadic rows every score ties 49
    others besides its own row, which K5 leaves out by id wherever it lies
    among the splits."""
    users, items, bias = _operands(width, 100, 2000, 24, dyadic=True,
                                   copies=50)
    ids = torch.randint(0, 2000, (100, width),
                        generator=torch.Generator().manual_seed(6)).to(cuda)
    ts = ranking.matched_target_scores(users, items, bias, ids)
    greater, equal = ranking.rank_counts(users, items, bias, ts, ids)
    want = ranking.rank_counts_plain(users, items, bias, ts, ids)
    assert torch.equal(greater, want[0]) and torch.equal(equal, want[1])
    assert bool((equal >= 49).all())


def test_rank_kernels_widest_embedding(cuda):
    """Dot scoring takes D <= 768 (the users, two item slabs and the counts
    of 4 targets in one block's shared memory); one wider raises."""
    users, items, bias = _operands(7, 3, 200, 769)
    ids = torch.zeros(3, 2, dtype=torch.int64, device=cuda)
    ts = ranking.matched_target_scores(users, items, bias, ids)
    with pytest.raises(ValueError, match='shared memory'):
        ranking.rank_weights(users, items, bias, ts)
    with pytest.raises(ValueError, match='shared memory'):
        ranking.rank_counts(users, items, bias, ts, ids)
    users = users[:, :768].contiguous()
    items = items[:, :768].contiguous()
    ts = ranking.matched_target_scores(users, items, bias, ids)
    weights = ranking.rank_weights(users, items, bias, ts)
    assert torch.equal(weights, ranking.rank_weights_plain(users, items, bias,
                                                           ts))
    greater, equal = ranking.rank_counts(users, items, bias, ts, ids)
    assert torch.equal(weights, greater + 0.5 * (equal + 1.0))


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
    want = evaluation._streaming_ranks(evaluation._device_scorer(4000),
                                       (users, items, bias, None), targets,
                                       mask)
    assert torch.equal(got, want)


def _matched(users, items, bias, ids, mixtures, plain=False):
    """K1c (``mixtures`` None) or K4, or their plain versions."""
    if mixtures is None:
        fn = (ranking.matched_target_scores_plain if plain
              else ranking.matched_target_scores)
        return fn(users, items, bias, ids)
    fn = (ranking.matched_candidate_scores_plain if plain
          else ranking.matched_candidate_scores)
    return fn(users, items, bias, ids, mixtures)


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _raw_ids(seed, batch, width, num_items, device, dtype):
    """Ids in [-3, N + 3), with the int32 extremes at two corners: the
    kernel clamps each into [0, N)."""
    ids = torch.randint(-3, num_items + 3, (batch, width),
                        generator=torch.Generator().manual_seed(seed))
    ids[0, 0] = -2 ** 31
    ids[-1, -1] = 2 ** 31 - 1
    return ids.to(device=device, dtype=dtype)


# The matched-pair kernel's edges, (B, T, D): a batch that no block's users
# divide, T of 1, 4, 49 and 130 (a user's targets in two chunks wherever a
# block holds fewer than 130 pairs), D of 1 (rows read an element a lane),
# 63 and 65 (no 16-byte rows; 65 in two slabs) and 64.
MATCHED_SHAPES = [(37, 1, 64), (100, 4, 63), (33, 49, 65), (5, 130, 1),
                  (130, 3, 64), (3, 130, 64)]


@pytest.mark.parametrize('ids_dtype', [torch.int32, torch.int64])
@pytest.mark.parametrize('item_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('mixtures', [None, 1, 2, 3, 4, 8])
def test_matched_kernel_equals_plain_version(cuda, mixtures, item_dtype,
                                             ids_dtype):
    """K1c and K4, one kernel, bit for bit against their plain versions on
    the clamped ids, for dots and M = 1, 2, 3, 4 and 8, float32 and bf16
    items, int32 and int64 ids."""
    num_items = 500
    for batch, width, dim in MATCHED_SHAPES:
        users, items, bias = _operands(batch + width + dim, batch,
                                       num_items, dim, item_dtype=item_dtype,
                                       mixtures=mixtures)
        if mixtures:
            users = users / dim ** .5
        ids = _raw_ids(width, batch, width, num_items, cuda, ids_dtype)
        got = _matched(users, items, bias, ids, mixtures)
        want = _matched(users, items, bias,
                        ids.long().clamp(0, num_items - 1), mixtures,
                        plain=True)
        assert got.shape == (batch, width)
        assert _same_bits(got, want), (batch, width, dim)


@pytest.mark.parametrize('mixtures', [None, 2, 4, 8])
def test_matched_kernel_widest_embedding(cuda, mixtures):
    """The kernel walks D in slabs, so it takes the widest embedding the
    rank pass streams (``ranking.streams``), bit for bit."""
    widest = max(dim for dim in range(1, 1025)
                 if ranking.streams(dim, mixtures, cuda))
    users, items, bias = _operands(widest, 70, 300, widest,
                                   mixtures=mixtures)
    users = users / widest ** .5
    ids = _raw_ids(1, 70, 5, 300, cuda, torch.int64)
    got = _matched(users, items, bias, ids, mixtures)
    want = _matched(users, items, bias, ids.clamp(0, 299), mixtures,
                    plain=True)
    assert _same_bits(got, want)


@pytest.mark.parametrize('mixtures', [None, 4])
def test_matched_targets_tie_themselves(cuda, mixtures):
    """Each matched score is its pair's catalogue score bit for bit, so
    every target ties itself in the rank pass (weight >= 0.5)."""
    users, items, bias = _operands(11, 130, 3000, 64, mixtures=mixtures)
    users = users / 8
    ids = _raw_ids(2, 130, 49, 3000, cuda, torch.int64)
    ts = _matched(users, items, bias, ids, mixtures)
    catalogue = ranking.plain_scores(users, items, bias, mixtures).T
    assert _same_bits(ts, torch.gather(catalogue, 1, ids.clamp(0, 2999)))
    weights = ranking.rank_weights(users, items, bias, ts, mixtures)
    assert bool((weights >= 0.5).all())


def _matched_device_work(mixtures, ids_dtype):
    """Run in a fresh process (a long run's profiler record can drop
    events): one K1c or K4 call under ``set_sync_debug_mode('error')``,
    then the device activities of another."""
    users, items, bias = _operands(9, 2048, 5000, 64, mixtures=mixtures)
    ids = _raw_ids(3, 2048, 4, 5000, 'cuda', ids_dtype)

    def call():
        return _matched(users, items, bias, ids, mixtures)

    call()                                                  # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    return _device_kernels(call)


@pytest.mark.parametrize('ids_dtype', [torch.int32, torch.int64])
@pytest.mark.parametrize('mixtures', [None, 4])
def test_matched_scores_are_one_launch(cuda, mixtures, ids_dtype):
    """A K1c or K4 call on the card is one device kernel (no clamp, no
    cast, no copy) and reads nothing back."""
    import multiprocessing

    with multiprocessing.get_context('spawn').Pool(1) as pool:
        names = pool.apply(_matched_device_work, (mixtures, ids_dtype))
    assert len(names) == 1 and 'matched_kernel' in names[0], names


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
@pytest.mark.parametrize('rows_dtype', [torch.int64, torch.int32])
def test_gather_sum_kernels_equal_plain_versions(cuda, entry, batch,
                                                 num_rows, dim, hashes, dtype,
                                                 skew, rows_dtype):
    """K6 and K7f forward, K6's backward and K7b, bit for bit, and the
    backward in the same bits in two launches, with int64 and int32
    rows."""
    table, rows, cotangent = _bloom_operands(batch + dim, batch, num_rows,
                                             dim, hashes, dtype, skew)
    rows = rows.to(rows_dtype)
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


_OUT_OF_RANGE = """
import sys
import torch
sys.path.insert(0, {root!r})
from spotlight_tpu_torch.ops.kernels import bloom, multihot
table = torch.ones(20, 16, device='cuda')
rows = torch.zeros(8, 4, dtype=torch.{dtype}, device='cuda')
rows[3, 1] = {bad}
out = {call}
torch.cuda.synchronize()
print('RESULT', float(out.sum()))
"""


@pytest.mark.parametrize('bad,dtype,call', [
    (-1, 'int64', 'bloom.bloom_gather_sum(table, rows)'),
    (20, 'int32', 'multihot.multihot_gather_sum(table, rows, True)'),
])
def test_gather_sum_rows_out_of_range_raise(cuda, bad, dtype, call):
    """A row outside [0, C) on the card stops the launch with a device-side
    error (the kernel checks every row it reads, as ``embedding_bag``
    does): the process fails at its next synchronisation and returns no
    result.  It runs in a child process, since the error poisons the CUDA
    context."""
    import pathlib
    import subprocess
    import sys

    root = str(pathlib.Path(__file__).resolve().parents[1])
    script = _OUT_OF_RANGE.format(root=root, dtype=dtype, bad=bad, call=call)
    done = subprocess.run([sys.executable, '-c', script], capture_output=True,
                          text=True, timeout=600)
    assert done.returncode != 0
    assert 'RESULT' not in done.stdout
    table, rows, _ = _bloom_operands(0, 8, 20, 16, 4, torch.float32)
    with pytest.raises(ValueError, match='several devices'):
        bloom.bloom_gather_sum(table, rows.cpu())


def test_gather_sum_forward_never_synchronises(cuda):
    """Both forward entry points, int32 and int64 rows, under CUDA's
    synchronisation check set to raise: the range check is the kernel's,
    nothing is read back and the rows are not cast."""
    table, rows, _ = _bloom_operands(5, 300, 1000, 64, 4, torch.float32)
    bloom.bloom_gather_sum(table, rows)             # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        outs = [fn(table, r) for r in (rows, rows.to(torch.int32))
                for fn in (bloom.bloom_gather_sum,
                           lambda t, r: multihot.multihot_gather_sum(
                               t, r, True))]
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert torch.equal(_bits(outs[0]), _bits(outs[2]))
    assert torch.equal(_bits(outs[1]), _bits(outs[3]))


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
    # The rows reach the kernel in their own dtype (no cast launch); other
    # integer dtypes as int32.
    assert rows.dtype == torch.int64
    for dtype, want in ((torch.int64, torch.int64), (torch.int32, torch.int32),
                        (torch.int16, torch.int32)):
        assert gather_sum.check_operands(table, rows.to(dtype)).dtype == want


def _scatter_operands(seed, batch, num_rows, dim, hashes, dtype, rows_dtype,
                      fill=None):
    """A cotangent (B, D) and rows (B, k) with a duplicated hash and some
    row-0 contributions; every row ``fill`` when given."""
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, num_rows, (batch, hashes))
    if fill is not None:
        rows[:] = fill
    elif rows.size:
        rows[0, :2] = min(3, num_rows - 1)
        rows[1::5, 0] = 0
    grad = rs.randn(batch, dim).astype(np.float32)
    grad[2::7] = -0.0
    return (torch.from_numpy(grad).to(device='cuda', dtype=dtype),
            torch.from_numpy(rows).to(device='cuda', dtype=rows_dtype))


def _check_scatter(grad, rows, num_rows, mask, acc_table):
    """The backward kernel against its plain version bit for bit, and in
    the same bits in two launches."""
    acc_dtype = grad.dtype if acc_table else torch.float32
    first = gather_sum.scatter_rows_cuda(grad, rows, num_rows, mask,
                                         acc_table, grad.dtype)
    again = gather_sum.scatter_rows_cuda(grad, rows, num_rows, mask,
                                         acc_table, grad.dtype)
    want = gather_sum.scatter_rows_plain(grad, rows, num_rows, mask,
                                         acc_dtype, grad.dtype)
    assert first.shape == (num_rows, grad.shape[1])
    assert first.dtype == grad.dtype
    assert torch.equal(_bits(first), _bits(want))
    assert torch.equal(_bits(first), _bits(again))
    if mask and num_rows:
        assert not bool(_bits(first[0]).any())
    return first


@pytest.mark.parametrize('acc_table', [False, True])
@pytest.mark.parametrize('mask', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('rows_dtype', [torch.int64, torch.int32])
def test_scatter_rows_kernel_equals_plain_version(cuda, rows_dtype, dtype,
                                                  mask, acc_table):
    """The gather-sum backward (K6's and K7b) from one stable sort and one
    launch, in every instantiation: rows int32 and int64, float32 and
    bfloat16, row 0 masked or not, the sum in float32 or in the table's
    dtype."""
    grad, rows = _scatter_operands(7, 700, 1500, 64, 4, dtype, rows_dtype)
    _check_scatter(grad, rows, 1500, mask, acc_table)


@pytest.mark.parametrize('case', [
    dict(batch=300, num_rows=200, dim=64, hashes=4, fill=5),   # one row
    dict(batch=300, num_rows=200, dim=64, hashes=4, fill=0),   # all row 0
    dict(batch=64, num_rows=1, dim=32, hashes=3, fill=None),   # C = 1
    dict(batch=500, num_rows=300, dim=64, hashes=1, fill=None),  # k = 1
    dict(batch=90, num_rows=70, dim=30, hashes=4, fill=None),  # no vectors
    dict(batch=90, num_rows=70, dim=12, hashes=4, fill=None,
         dtype=torch.bfloat16),                                # bf16, D=12
    dict(batch=40, num_rows=100000, dim=8, hashes=2, fill=None),  # sparse
], ids=['one-row', 'row-zero', 'C1', 'k1', 'D30', 'bf16-D12', 'sparse'])
@pytest.mark.parametrize('mask', [False, True])
def test_scatter_rows_kernel_edges(cuda, case, mask):
    case = dict(case)
    dtype = case.pop('dtype', torch.float32)
    grad, rows = _scatter_operands(8, case['batch'], case['num_rows'],
                                   case['dim'], case['hashes'], dtype,
                                   torch.int64, case['fill'])
    got = _check_scatter(grad, rows, case['num_rows'], mask, False)
    if case['fill'] == 0 and mask:
        assert not bool(_bits(got).any())


def test_scatter_rows_kernel_on_one_row_taking_every_contribution(cuda):
    """A skewed bloom row: all B * k = 32,768 contributions land on row 7,
    walked in ascending flat index by the threads of one row."""
    grad, rows = _scatter_operands(9, 8192, 4096, 64, 4, torch.float32,
                                   torch.int64, fill=7)
    for acc_table in (False, True):
        got = _check_scatter(grad, rows, 4096, False, acc_table)
        assert bool(_bits(got[7]).any())
        assert not bool(_bits(got[:7]).any())


@pytest.mark.parametrize('batch,hashes', [(0, 4), (5, 0), (0, 0)])
def test_scatter_rows_kernel_without_contributions(cuda, batch, hashes):
    """B = 0 or k = 0: a zero table gradient."""
    grad = torch.randn(batch, 16, device=cuda)
    rows = torch.zeros(batch, hashes, dtype=torch.int64, device=cuda)
    for mask in (False, True):
        got = gather_sum.scatter_rows_cuda(grad, rows, 9, mask, False,
                                           torch.float32)
        assert got.shape == (9, 16) and not bool(_bits(got).any())


@pytest.mark.parametrize('rows_dtype', [torch.int64, torch.int32])
def test_scatter_rows_is_one_sort_and_one_launch(cuda, rows_dtype):
    """A backward call on the card is the stable sort's device work (int64
    rows cast to int32 keys first) and one scatter launch, nothing else, and
    reads nothing back."""
    table, rows, cotangent = _bloom_operands(3, 8192, 65536, 64, 4,
                                             torch.float32)
    rows = rows.to(rows_dtype)
    grad = cotangent.contiguous()
    gather_sum.scatter_rows_cuda(grad, rows, 65536, True, False,
                                 torch.float32)                 # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        gather_sum.scatter_rows_cuda(grad, rows, 65536, True, False,
                                     torch.float32)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    sort = _device_kernels(lambda: gather_sum.sort_rows(rows))
    call = _device_kernels(lambda: gather_sum.scatter_rows_cuda(
        grad, rows, 65536, True, False, torch.float32))
    assert len(call) == len(sort) + 1
    assert sum('scatter_rows_kernel' in name for name in call) == 1


def _row_operands(seed, num_rows, width, n, dtype, device, deep=0):
    """Occurrence ids with repeats (row 3 ten times, the sentinel row count
    three times, a negative id once, row 0 at ``deep`` scattered
    positions), a table, warm moments and gradient rows, on ``device``."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, num_rows, n)
    ids[:10] = 3
    ids[-3:] = num_rows
    ids[-4] = -2
    ids[rs.choice(n - 4, deep, replace=False)] = 0
    param = torch.from_numpy(rs.randn(num_rows, width).astype(np.float32))
    mu = torch.from_numpy((0.01 * rs.randn(num_rows, width)).astype(
        np.float32))
    nu = torch.from_numpy((1e-4 * rs.rand(num_rows, width)).astype(
        np.float32))
    grads = torch.from_numpy((0.1 * rs.randn(n, width)).astype(np.float32))
    grads[10:12] = -0.0
    return (torch.from_numpy(ids).to(device), param.to(device, dtype),
            mu.to(device), nu.to(device), grads.to(device))


@pytest.mark.parametrize('ids_dtype', [torch.int64, torch.int32])
@pytest.mark.parametrize('num_rows,width,n,dtype,l2,t,deep', [
    (1000, 65, 4096, torch.float32, 1e-6, 7, 0),
    (1000, 65, 4096, torch.bfloat16, 1e-6, 7, 0),
    (5000, 128, 24576, torch.float32, 0.0, 5, 0),
    (300, 33, 5000, torch.float32, 0.0, 1, 0),     # deep segments
    (70, 1, 40, torch.bfloat16, 1e-3, 1000, 0),
    (2000, 65, 8192, torch.float32, 1e-6, 60, 2000),   # a padded step
    (500, 64, 3000, torch.bfloat16, 0.0, 3, 2000),
    # The sequence lazy engine's item call: B=256 x T=50 positives and as
    # many negatives over 20,000 items, a padded batch's ids past the table.
    (20000, 65, 25600, torch.float32, 0.0, 60, 0),
    (20000, 65, 25600, torch.bfloat16, 1e-6, 79, 0),
])
def test_row_adam_kernel_equals_plain_version(cuda, num_rows, width, n,
                                              dtype, l2, t, deep, ids_dtype):
    """P1 from one stable sort on the card, bit for bit against its plain
    version, in two launches: int64 and int32 ids, ties kept in occurrence
    order (the card's sort against the CPU's), a 2,000-occurrence row-0
    segment, the sentinel row count and a negative id."""
    ids, param, mu, nu, grads = _row_operands(n + width, num_rows, width, n,
                                              dtype, cuda, deep)
    ids = ids.to(ids_dtype)
    sorted_ids, order = row_update.sort_occurrences(ids)
    cpu_sorted, cpu_order = torch.sort(ids.cpu(), stable=True)
    assert sorted_ids.dtype == ids_dtype
    assert torch.equal(sorted_ids.cpu(), cpu_sorted)
    assert torch.equal(order.cpu(), cpu_order)
    scalars = row_update.adam_scalars(t, 1e-2, l2)
    results = []
    for _ in range(2):
        p, m, v = param.clone(), mu.clone(), nu.clone()
        row_update.row_adam(p, m, v, grads, sorted_ids, order, scalars)
        results.append((p, m, v))
    p, m, v = param.clone(), mu.clone(), nu.clone()
    row_update.row_adam_plain(p, m, v, grads, sorted_ids, order, scalars)
    torch.cuda.synchronize()
    for got in results:
        for a, b in zip(got, (p, m, v)):
            assert torch.equal(_bits(a), _bits(b))
    assert not torch.equal(results[0][0], param)
    # The sentinel row count and the negative id update nothing; untouched
    # rows stay.
    untouched = torch.ones(num_rows, dtype=torch.bool, device=cuda)
    named = ids[(ids >= 0) & (ids < num_rows)]
    untouched[named.long()] = False
    assert torch.equal(results[0][1][untouched], mu[untouched])


def test_row_adam_kernel_matches_the_cpu(cuda):
    """The whole of ``sparse_adam_rows`` on the card against the CPU: both
    run the same IEEE-rounded arithmetic, so bit for bit."""
    cpu = _row_operands(9, 400, 65, 2000, torch.float32, 'cpu', deep=300)
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
                              *row_update.sort_occurrences(ids),
                              row_update.adam_scalars(2, 1e-2))
    assert row_update.ROW_ADAM_LAUNCHES == before + 1


def _device_kernels(fn):
    """Names of the device activities (kernels, copies, fills) of one call
    of ``fn``, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [event.name for event in prof.events()
            if event.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.parametrize('ids_dtype', [torch.int64, torch.int32])
def test_sparse_adam_rows_is_one_sort_and_one_launch(cuda, ids_dtype):
    """A ``sparse_adam_rows`` call on the card is the stable sort's device
    work and one P1 launch, nothing else, and reads nothing back."""
    ids, param, mu, nu, grads = _row_operands(2, 5000, 65, 16384,
                                              torch.float32, cuda)
    ids = ids.to(ids_dtype)
    sparse_adam_rows(ids, param, mu, nu, grads, 1, 1e-2)      # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        sparse_adam_rows(ids, param, mu, nu, grads, 2, 1e-2)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    sort = _device_kernels(lambda: row_update.sort_occurrences(ids))
    call = _device_kernels(
        lambda: sparse_adam_rows(ids, param, mu, nu, grads, 3, 1e-2))
    assert len(call) == len(sort) + 1
    assert sum('row_adam_kernel' in name for name in call) == 1


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


# -- explicit MF and sequence training ------------------------------------------

def _explicit_model(device, sparse, loss='regression'):
    from spotlight_tpu_torch.factorization import ExplicitFactorizationModel

    rs = np.random.RandomState(2)
    data = Interactions(rs.randint(0, 200, 1000), rs.randint(0, 150, 1000),
                        ratings=rs.randint(1, 6, 1000).astype(np.float32),
                        num_users=200, num_items=150)
    if loss == 'logistic':
        data.ratings = np.where(data.ratings > 3, 1.0, -1.0).astype(
            np.float32)
    model = ExplicitFactorizationModel(
        loss=loss, embedding_dim=16, batch_size=256, sparse=sparse, l2=1e-6,
        random_state=np.random.RandomState(4), device=device)
    model._initialize(data)
    return model, data


def _captured_row_updates(engine=None):
    """Wrap a lazy engine's ``sparse_adam_rows`` (``engine``, the module;
    the factorization engine's by default): each call's operands are
    cloned before they update.  Returns (captured list, undo)."""
    from spotlight_tpu_torch.factorization import lazy

    lazy = engine or lazy
    original = lazy.sparse_adam_rows
    captured = []

    def wrapper(ids, param, mu, nu, grad_rows, t, lr, l2=0.0):
        captured.append(dict(ids=ids.clone(), param=param.clone(),
                             mu=mu.clone(), nu=nu.clone(),
                             grads=grad_rows.clone(), t=t, lr=lr, l2=l2))
        return original(ids, param, mu, nu, grad_rows, t, lr, l2)

    lazy.sparse_adam_rows = wrapper

    def undo():
        lazy.sparse_adam_rows = original

    return captured, undo


def _first_batch(model, data, device, negatives_shape=None):
    from spotlight_tpu_torch.utils import training

    placed, n_valid, num_batches = model._epoch_data(data)
    batch_size = model._batch_size
    perm, negatives = training.epoch_draws(
        model._generator, num_batches * batch_size, negatives_shape,
        model._num_items, device)
    return placed, n_valid, perm, negatives


def _run_one_step(model, placed, n_valid, perm, negatives):
    """One step of the model's engine on the first batch of ``perm``, with
    CUDA's synchronisation check set to raise on the card."""
    from spotlight_tpu_torch.utils import training

    step = model._step_fn()
    on_card = model._device.type == 'cuda'
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
    try:
        loss = training.run_epoch(step, placed, n_valid, 1,
                                  model._batch_size,
                                  perm[:model._batch_size],
                                  None if negatives is None
                                  else negatives[:1])
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode('default')
    return float(loss)


def test_explicit_lazy_step_on_the_card_matches_the_cpu(cuda):
    """One explicit lazy step: the same draws on both devices (the
    generator is on the CPU), the card's step under the synchronisation
    check; its occurrence gradients within rtol 1e-5 of the CPU's (torch
    sums them in another order there), its two P1 calls bit-equal to the
    plain version on the card's own gradients, two launches."""
    steps = {}
    for device in ('cpu', cuda):
        model, data = _explicit_model(device, True)
        placed, n_valid, perm, _ = _first_batch(model, data, device)
        captured, undo = _captured_row_updates()
        launches = row_update.ROW_ADAM_LAUNCHES
        try:
            loss = _run_one_step(model, placed, n_valid, perm, None)
        finally:
            undo()
        steps[str(device)] = (loss, captured,
                              row_update.ROW_ADAM_LAUNCHES - launches)
    cpu_loss, cpu_calls, _ = steps['cpu']
    card_loss, card_calls, card_launches = steps[str(cuda)]
    assert card_launches == 2 and len(card_calls) == len(cpu_calls) == 2
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    for cpu, card in zip(cpu_calls, card_calls):
        assert torch.equal(cpu['ids'], card['ids'].cpu())
        assert card['ids'].numel() == 256
        scale = float(cpu['grads'].abs().max())
        torch.testing.assert_close(card['grads'].cpu(), cpu['grads'],
                                   rtol=1e-5, atol=1e-7 * scale)
        pair = row_update.sort_occurrences(card['ids'])
        scalars = row_update.adam_scalars(card['t'], card['lr'], card['l2'])
        grads = card['grads'].reshape(card['ids'].numel(), -1)
        tables = []
        for fn in (row_update.row_adam, row_update.row_adam_plain):
            out = (card['param'].clone(), card['mu'].clone(),
                   card['nu'].clone())
            fn(*out, grads, *pair, scalars)
            tables.append(out)
        for a, b in zip(*tables):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _trainable_sequence_model(device, representation,
                               negative_sampling='uniform', loss='bpr'):
    rs = np.random.RandomState(3)
    sequences = rs.randint(1, 300, (600, 12))
    sequences[:40, :5] = 0
    data = SequenceInteractions(sequences, num_items=300)
    model = ImplicitSequenceModel(
        loss=loss, representation=representation, embedding_dim=16,
        batch_size=128, l2=1e-6, negative_sampling=negative_sampling,
        random_state=np.random.RandomState(5), device=device)
    model._initialize(data)
    return model, data


def _sequence_grads(model, placed, n_valid, perm, negatives):
    """The loss and parameter gradients of the first batch."""
    from spotlight_tpu_torch.utils import training

    batched = training.shuffle_and_batch(perm, placed, n_valid,
                                         len(perm) // model._batch_size,
                                         model._batch_size)
    batch = {name: value[0] for name, value in batched.items()}
    params = dict(model._net.named_parameters())
    elems, mask = model._elems_fn()(batch, None if negatives is None
                                    else negatives[0])
    loss = training.masked_mean(elems, mask)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {name: g.cpu()
                                  for name, g in zip(params, grads)}


#: The card's float32 LSTM and mixture gradients against the CPU's: the
#: same function summed in other orders (matmuls, reductions, the embedding
#: backward), without TF32.
SEQUENCE_GRAD_RTOL = 1e-4


@pytest.mark.parametrize('representation, negative_sampling', [
    ('lstm', 'uniform'), ('mixture', 'uniform'), ('mixture', 'in_batch')])
def test_sequence_step_on_the_card_matches_the_cpu(cuda, representation,
                                                   negative_sampling):
    """One LSTM or mixture step from the same parameters and draws on both
    devices: the loss within rtol 1e-5 and every gradient within
    ``SEQUENCE_GRAD_RTOL`` of its largest element; then the whole step on
    the card under the synchronisation check."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == 'highest'
    results = {}
    for device in ('cpu', cuda):
        model, data = _trainable_sequence_model(
            device, representation, negative_sampling)
        shape = (None if negative_sampling == 'in_batch'
                 else (len(data.sequences) // 128 + 1, 128, 12))
        placed, n_valid, perm, negatives = _first_batch(model, data, device,
                                                        shape)
        results[str(device)] = _sequence_grads(model, placed, n_valid, perm,
                                                negatives)
        if device is cuda:
            loss = _run_one_step(model, placed, n_valid, perm, negatives)
            assert np.isfinite(loss) and model._opt_state['count'] == 1
    cpu_loss, cpu_grads = results['cpu']
    card_loss, card_grads = results[str(cuda)]
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    for name, want in cpu_grads.items():
        scale = float(want.abs().max())
        torch.testing.assert_close(card_grads[name], want, rtol=0,
                                   atol=SEQUENCE_GRAD_RTOL * scale,
                                   msg=name)


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'lazy'])
@pytest.mark.parametrize('loss', ['regression', 'poisson', 'logistic'])
def test_explicit_fit_trains_on_the_card(cuda, loss, sparse):
    """``fit`` with the default device: the loss is finite, both tables
    move, the lazy engine launches P1 twice a step, and the predictions
    are rates (poisson) or probabilities (logistic)."""
    from spotlight_tpu_torch.evaluation import rmse_score
    from spotlight_tpu_torch.factorization import ExplicitFactorizationModel

    _, data = _explicit_model('cpu', sparse, loss)
    model = ExplicitFactorizationModel(
        loss=loss, embedding_dim=16, n_iter=2, batch_size=256,
        sparse=sparse, random_state=np.random.RandomState(1))
    launches = row_update.ROW_ADAM_LAUNCHES
    assert model.fit(data) is model
    assert model._device.type == 'cuda' and model._lazy == sparse
    assert row_update.ROW_ADAM_LAUNCHES == launches + (16 if sparse else 0)
    assert np.isfinite(model._last_epoch_loss)
    predictions = model.predict(data.user_ids, data.item_ids)
    assert predictions.shape == (1000,) and np.isfinite(predictions).all()
    if loss == 'poisson':
        assert (predictions > 0).all()
    if loss == 'logistic':
        assert ((predictions >= 0) & (predictions <= 1)).all()
    assert np.isfinite(rmse_score(model, data))


@pytest.mark.parametrize('table', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('negative_sampling', ['uniform', 'in_batch'])
@pytest.mark.parametrize('representation', ['lstm', 'mixture'])
def test_sequence_fit_trains_on_the_card(cuda, representation,
                                         negative_sampling, table):
    """``fit`` with the default device: the loss is finite, every parameter
    moves in its own dtype, and the trained model serves through the
    streaming kernels."""
    from spotlight_tpu_torch.sequence import LSTMNet

    _, data = _trainable_sequence_model('cpu', 'lstm')
    kind = LSTMNet if representation == 'lstm' else MixtureLSTMNet
    net = kind(300, 16, table_dtype=table,
               generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    model = ImplicitSequenceModel(
        loss='adaptive_hinge', representation=net, n_iter=2, batch_size=128,
        negative_sampling=negative_sampling,
        random_state=np.random.RandomState(1))
    assert model.fit(data) is model
    assert model._device.type == 'cuda'
    assert model._opt_state['count'] == 10
    assert np.isfinite(model._last_epoch_loss)
    for name, value in model._net.state_dict().items():
        assert value.is_cuda and not torch.equal(value.cpu(), before[name])
    assert model._net.item_embeddings.weight.dtype == table
    assert not model._net.item_embeddings.weight[0].any()
    routes = evaluation.MATERIALIZE_ROUTES
    mrr = evaluation.sequence_mrr_score(model, data)
    assert evaluation.MATERIALIZE_ROUTES == routes
    assert ((mrr > 0) & (mrr <= 1)).all()


def _pool_cnn_nets(kind, device, dim=64, num_items=3000,
                   table=torch.float32):
    """A CPU network and its copy on ``device``."""
    import copy

    from spotlight_tpu_torch.sequence import CNNNet, PoolNet

    generator = torch.Generator().manual_seed(11)
    if kind == 'pooling':
        net = PoolNet(num_items, dim, table_dtype=table, generator=generator)
    else:
        net = CNNNet(num_items, dim, kernel_width=3, dilation=(1, 2, 4),
                     num_layers=3, table_dtype=table, generator=generator)
    with torch.no_grad():
        net.item_embeddings.weight[1:, dim] = 0.1 * torch.randn(
            num_items - 1, generator=generator).to(table)
    return net, copy.deepcopy(net).to(device)


def _pool_cnn_outputs(net, sequences):
    with torch.no_grad():
        steps, final = net.user_representation(sequences)
        return (steps, final, net.score(steps, sequences),
                net.score_catalog(final))


@pytest.mark.parametrize('table', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', ['pooling', 'cnn'])
def test_pool_and_cnn_on_the_card_match_the_cpu(cuda, kind, table):
    """``PoolNet`` and a three-layer dilated ``CNNNet`` at D=64: per-step
    and final representations, step and catalogue scores on the card
    within rtol 1e-5 of the largest element of the CPU's."""
    cpu_net, card_net = _pool_cnn_nets(kind, cuda, table=table)
    sequences = torch.from_numpy(
        np.random.RandomState(1).randint(0, 3000, (64, 50)))
    sequences[:8, :20] = 0
    for got, want in zip(_pool_cnn_outputs(card_net, sequences.to(cuda)),
                         _pool_cnn_outputs(cpu_net, sequences)):
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_cnn_takes_no_tf32_path(cuda):
    """cuDNN's TF32 switch is left at its default (on): the CNN, one
    float32 product a tap, still equals the CPU within 1e-5 of the largest
    element, where TF32's 10-bit mantissa would miss by about 1e-3."""
    assert torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    cpu_net, card_net = _pool_cnn_nets('cnn', cuda, dim=128)
    sequences = torch.from_numpy(
        np.random.RandomState(2).randint(1, 3000, (128, 50)))
    got = _pool_cnn_outputs(card_net, sequences.to(cuda))[0].cpu()
    want = _pool_cnn_outputs(cpu_net, sequences)[0]
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap < 1e-5, gap


def _lazy_sequence_model(device, representation, negative_sampling):
    rs = np.random.RandomState(3)
    sequences = rs.randint(1, 300, (600, 12))
    sequences[:40, :5] = 0
    data = SequenceInteractions(sequences, num_items=300)
    model = ImplicitSequenceModel(
        loss='bpr', representation=representation, embedding_dim=16,
        batch_size=128, l2=1e-6, sparse=True,
        negative_sampling=negative_sampling,
        random_state=np.random.RandomState(5), device=device)
    model._initialize(data)
    return model, data


@pytest.mark.parametrize('representation, negative_sampling', [
    ('pooling', 'uniform'), ('cnn', 'in_batch'), ('lstm', 'uniform')])
def test_sequence_lazy_step_on_the_card_matches_the_cpu(
        cuda, representation, negative_sampling):
    """One step of the row-sparse sequence engine from the same parameters
    and draws on both devices, the card's under the synchronisation check:
    the loss within rtol 1e-5, the item rows' gradients and the tower's
    first moments (a tenth of its gradients) within
    ``SEQUENCE_GRAD_RTOL`` of their largest element; one P1 launch,
    bit-equal to the plain version on the card's own gradients; the padding
    row stays zero."""
    from spotlight_tpu_torch.sequence import lazy as sequence_lazy

    steps = {}
    for device in ('cpu', cuda):
        model, data = _lazy_sequence_model(device, representation,
                                           negative_sampling)
        shape = (None if negative_sampling == 'in_batch'
                 else (len(data.sequences) // 128 + 1, 128, 12))
        placed, n_valid, perm, negatives = _first_batch(model, data, device,
                                                        shape)
        captured, undo = _captured_row_updates(sequence_lazy)
        launches = row_update.ROW_ADAM_LAUNCHES
        try:
            loss = _run_one_step(model, placed, n_valid, perm, negatives)
        finally:
            undo()
        assert model._lazy and model._opt_state['t'] == 1
        assert not model._net.item_embeddings.weight[0].any()
        tower = {name: value.cpu() for name, value in
                 model._opt_state['tower']['mu'].items()}
        steps[str(device)] = (loss, captured, tower,
                              row_update.ROW_ADAM_LAUNCHES - launches)
    cpu_loss, (cpu,), cpu_tower, _ = steps['cpu']
    card_loss, (card,), card_tower, card_launches = steps[str(cuda)]
    assert card_launches == 1
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    assert torch.equal(cpu['ids'], card['ids'].cpu())
    assert set(card_tower) == set(cpu_tower)
    for name, got, want in [('item rows', card['grads'].cpu(),
                             cpu['grads'])] + [
            (name, card_tower[name], want)
            for name, want in cpu_tower.items()]:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=SEQUENCE_GRAD_RTOL * scale, msg=name)
    pair = row_update.sort_occurrences(card['ids'])
    scalars = row_update.adam_scalars(card['t'], card['lr'], card['l2'])
    tables = []
    for fn in (row_update.row_adam, row_update.row_adam_plain):
        out = (card['param'].clone(), card['mu'].clone(), card['nu'].clone())
        fn(*out, card['grads'], *pair, scalars)
        tables.append(out)
    for a, b in zip(*tables):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize('representation, sparse', [('pooling', True),
                                                    ('cnn', False)])
def test_serialization_roundtrip_on_the_card(cuda, representation, sparse):
    """A model fitted on the card (the default device) comes back on the
    card with the same metric, bit for bit, and resumes: ``t`` (or the
    dense Adam's count) continues, and a further fit of both ends in the
    same parameters."""
    import io

    from spotlight_tpu_torch.utils import serialization

    _, data = _lazy_sequence_model('cpu', representation, 'uniform')
    model = ImplicitSequenceModel(
        loss='bpr', representation=representation, embedding_dim=16,
        batch_size=128, n_iter=2, sparse=sparse,
        random_state=np.random.RandomState(5)).fit(data)
    buffer = io.BytesIO()
    serialization.save(model, buffer)
    buffer.seek(0)
    loaded = serialization.load(buffer)
    assert loaded._device.type == 'cuda' and loaded._lazy == sparse
    assert all(value.is_cuda for value in loaded._net.state_dict().values())
    np.testing.assert_array_equal(evaluation.sequence_mrr_score(loaded, data),
                                  evaluation.sequence_mrr_score(model, data))
    key = 't' if sparse else 'count'
    steps = loaded._opt_state[key]
    model.fit(data)
    loaded.fit(data)
    assert loaded._opt_state[key] == model._opt_state[key] == 2 * steps
    for name, value in model._net.state_dict().items():
        assert torch.equal(value, loaded._net.state_dict()[name]), name


def test_a_card_saved_model_needs_a_card_to_load(cuda, tmp_path):
    """Loading a model saved from the card raises where no card is seen
    (``CUDA_VISIBLE_DEVICES`` empty): nothing moves to the CPU on its
    own."""
    import os
    import pathlib
    import subprocess
    import sys

    from spotlight_tpu_torch.utils import serialization

    _, data = _lazy_sequence_model('cpu', 'pooling', 'uniform')
    model = ImplicitSequenceModel(
        loss='bpr', embedding_dim=16, batch_size=128, n_iter=1,
        random_state=np.random.RandomState(5)).fit(data)
    path = tmp_path / 'model.pkl'
    serialization.save(model, str(path))
    assert serialization.load(str(path))._device.type == 'cuda'
    code = ('import sys; from spotlight_tpu_torch.utils import '
            'serialization; serialization.load(sys.argv[1])')
    result = subprocess.run(
        [sys.executable, '-c', code, str(path)],
        cwd=pathlib.Path(__file__).resolve().parents[1],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''), capture_output=True,
        text=True, timeout=300)
    assert result.returncode != 0
    assert 'CUDA' in result.stderr, result.stderr[-2000:]


# -- the utilities and the ML-1M sweep ----------------------------------------

def test_entry_runs_on_the_card(cuda):
    """``entry()`` defaults to the card and agrees with the CPU's forward
    on the same parameters to rtol 1e-5 (another summation order)."""
    from spotlight_tpu_torch.entry import entry

    fn, (net, sequences) = entry()
    assert sequences.is_cuda and all(p.is_cuda for p in net.parameters())
    cpu_fn, (cpu_net, cpu_sequences) = entry(device='cpu')
    cpu_net.load_state_dict({name: value.cpu() for name, value
                             in net.state_dict().items()})
    with torch.no_grad():
        predictions, catalog = fn(net, sequences)
        want = cpu_fn(cpu_net, cpu_sequences)
    assert predictions.shape == (128, 64) and catalog.shape == (128, 2048)
    for got, expected in zip((predictions, catalog), want):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.cpu().numpy(), expected.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_trace_records_cuda_kernels_in_a_fresh_process(cuda, tmp_path):
    """``utils.profiling.trace`` on the card writes a Chrome trace holding
    the card's kernels; run in a fresh process, since ``torch.profiler``
    loses device events after several sessions in one."""
    import json
    import pathlib
    import subprocess
    import sys

    script = (
        'import sys, torch\n'
        'from spotlight_tpu_torch.utils import profiling\n'
        'x = torch.randn(512, 512, device="cuda")\n'
        'with profiling.trace(sys.argv[1], device="cuda") as traced:\n'
        '    for _ in range(3):\n'
        '        x = torch.tanh(x @ x)\n'
        'print(sum(e.count for e in traced.profiler.key_averages()\n'
        '          if getattr(e, "self_device_time_total", 0) > 0\n'
        '          and not e.key.startswith("aten::")))\n')
    result = subprocess.run(
        [sys.executable, '-c', script, str(tmp_path)],
        cwd=pathlib.Path(__file__).resolve().parents[1], capture_output=True,
        text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-2000:]
    assert int(result.stdout.strip().splitlines()[-1]) >= 6
    events = json.loads((tmp_path / 'trace.json').read_text())
    kernels = [event for event in events['traceEvents']
               if event.get('cat') == 'kernel']
    assert len(kernels) >= 6


def test_throughput_meter_waits_for_the_card(cuda):
    """On the card a step's time includes its device work: a product
    enqueued in the step counts, though the host returns at once."""
    from spotlight_tpu_torch.utils.profiling import ThroughputMeter

    x = torch.randn(4096, 4096, device='cuda')
    meter = ThroughputMeter(warmup_steps=1, device='cuda')
    for _ in range(3):
        with meter.step(1):
            for _ in range(20):
                x = torch.tanh(x @ x)
    assert meter.measured_steps == 2
    # 20 products of 1.4e11 operations at most 67e12 a second: > 40 ms.
    assert meter.examples_per_second() < 1 / 0.04


def test_native_walk_builds_on_the_card_machine(cuda):
    from spotlight_tpu_torch import native
    from spotlight_tpu_torch.data import synthetic

    assert native.load() is not None
    assert native.library_path().parent.name == 'native'
    rs = np.random.RandomState(3)
    cumulative = np.cumsum(synthetic._build_transition_matrix(50, 0.1, rs),
                           axis=1)
    rvs, state = rs.rand(500), rs.randint(50, size=2).astype(np.int64)
    got = native.markov_walk(cumulative, rvs, state)
    window, want = state.copy(), []
    for rv in rvs:
        new = min(49, int(np.searchsorted(cumulative[window].mean(axis=0),
                                          rv)))
        window[:-1], window[-1] = window[1:], new
        want.append(new)
    np.testing.assert_array_equal(got, want)


def test_ml1m_cnn_gate_one_seed(cuda):
    """One seed of ``chip_smoke.py`` phase 14's CNN gate: the committed
    best CNN configuration, fitted on the card at full width, reaches 0.9
    of the log's test MRR."""
    import chip_smoke
    from spotlight_tpu_torch.data import fixtures

    train, _, test = chip_smoke.ml1m_sequences(
        chip_smoke.ml1m_interactions_from_columns(
            fixtures.generate_movielens_1m_like()))
    h, best = chip_smoke.sweep_configurations()['cnn']
    model = chip_smoke.sweep_model(torch, 'cnn', h, train.num_items, 0)
    model.fit(train)
    mrr = float(evaluation.sequence_mrr_score(model, test).mean())
    assert mrr >= chip_smoke.SWEEP_GATES['cnn'] * best['test_mrr'], mrr


# -- sharded evaluation: mesh ranks on the card --------------------------------

def _mesh_dyadic(rs, shape):
    return (rs.randint(-4, 5, shape) / 8).astype(np.float32)


def _mesh_model_cases():
    """A factorization case (dyadic tables: exact ties) and a mixture
    sequence case (the port's seeded initialisation, seeded item biases)
    over 203 items, as ``tests/test_torch_mesh_metrics.py`` builds them."""
    from tests import torch_mesh_worker

    rs = np.random.RandomState(11)
    num_users, num_items, dim = 64, 203, 16
    mf = {'num_users': num_users, 'num_items': num_items, 'dim': dim,
          'k': 5, 'test': (np.repeat(np.arange(num_users), 3),
                           rs.randint(0, num_items, 3 * num_users)),
          'train': (np.concatenate([np.full(40, 5),
                                    rs.randint(0, num_users, 600)]),
                    np.concatenate([rs.choice(num_items, 40, replace=False),
                                    rs.randint(0, num_items, 600)]))}
    bare = ImplicitFactorizationModel(embedding_dim=dim, device='cpu')
    bare._initialize(torch_mesh_worker.interactions(mf, 'train',
                                                    Interactions))
    mf['state'] = {name: _mesh_dyadic(rs, tuple(value.shape))
                   for name, value in bare._net.state_dict().items()}
    sequences = rs.randint(1, num_items, (64, 10)).astype(np.int32)
    seq = {'num_items': num_items, 'dim': dim, 'mixtures': 2, 'k': 3,
           'sequences': sequences}
    bare = ImplicitSequenceModel(
        representation=MixtureLSTMNet(num_items, dim, num_mixtures=2),
        embedding_dim=dim, random_state=np.random.RandomState(13),
        device='cpu')
    bare._initialize(SequenceInteractions(sequences, num_items=num_items))
    seq['state'] = {name: value.numpy().copy()
                    for name, value in bare._net.state_dict().items()}
    table = seq['state']['item_embeddings.weight']
    table[1:, dim] = 0.1 * rs.randn(num_items - 1)
    return mf, seq


def test_mesh_metrics_of_four_gloo_ranks_on_one_card(cuda, tmp_path):
    """Phase 15 (a) of ``chip_smoke.py`` at a small size: four gloo ranks
    share the card, at data=1 x model=4 and data=2 x model=2; every metric
    of the mesh models equals the single-device call on the card bit for
    bit, no call takes the materialize route, and the rank kernels
    launched in the ranks."""
    from spotlight_tpu_torch.ops.kernels import _build
    from tests import torch_mesh_worker

    _build.build()
    mf, seq = _mesh_model_cases()
    ranks = torch_mesh_worker.run_ranks(
        {'layouts': ((1, 4), (2, 2)), 'models': {'mf': mf,
                                                 'sequence': seq}},
        tmp_path, devices=['cuda:0'] * 4, timeout=600)
    want = torch_mesh_worker.metrics(
        torch_mesh_worker.factorization_model(mf, device='cuda'), mf,
        torch_mesh_worker.sequence_model(seq, device='cuda'), seq)
    for results in ranks:
        for layout in ((1, 4), (2, 2)):
            assert results[layout]['materialize_routes'] == 0
            assert results[layout]['device'] == 'cuda:0'
            torch_mesh_worker.assert_same(results[layout]['metrics'], want)


def test_sharded_functions_on_a_one_rank_nccl_group(cuda, tmp_path):
    """Phase 15 (b) at a small size: the four sharded functions under a
    one-rank NCCL group equal the single-device kernels on the card
    exactly (scores bit for bit), streaming and not."""
    from spotlight_tpu_torch.ops.kernels import _build
    from tests import torch_mesh_worker

    _build.build()
    rs = np.random.RandomState(12)
    num_items, dim, mixtures, k = 1000, 32, 2, 7
    case = {'users': _mesh_dyadic(rs, (96, dim)),
            'mix_users': _mesh_dyadic(rs, (96, 2 * mixtures * dim)),
            'items': _mesh_dyadic(rs, (num_items, dim)),
            'bias': _mesh_dyadic(rs, (num_items,)) / 8,
            'target_ids': rs.randint(0, num_items, (96, 3)),
            'candidates': rs.randint(0, num_items, (96, 5)),
            'k': k, 'mixtures': mixtures}
    on = {name: torch.as_tensor(value, device=cuda)
          for name, value in case.items() if isinstance(value, np.ndarray)}
    for name, users, mixture in (('dot', on['users'], None),
                                 ('mixture', on['mix_users'], mixtures)):
        case['target_scores_' + name] = _matched(
            users, on['items'], on['bias'], on['target_ids'],
            mixture).cpu().numpy()
    [rank] = torch_mesh_worker.run_ranks(
        {'layouts': ((1, 1),), 'functions': case}, tmp_path, world=1,
        backend='nccl', devices=['cuda:0'], timeout=600)
    got = rank[(1, 1)]
    for name, users, mixture in (('dot', on['users'], None),
                                 ('mixture', on['mix_users'], mixtures)):
        args = (on['items'], on['bias'])
        ts = torch.as_tensor(case['target_scores_' + name], device=cuda)
        want_topk = tuple(t.cpu().numpy() for t in topk.streaming_topk(
            users, *args, k, mixture))
        want_counts = tuple(t.cpu().numpy() for t in ranking.rank_counts(
            users, *args, ts, on['target_ids'], mixture))
        for streaming in (True, False):
            torch_mesh_worker.assert_same(got['topk', name, streaming],
                                          want_topk)
            torch_mesh_worker.assert_same(got['counts', name, streaming],
                                          want_counts)
        torch_mesh_worker.assert_same(
            got['weights', name],
            ranking.rank_weights(users, *args, ts, mixture).cpu().numpy())
        torch_mesh_worker.assert_same(
            got['scores', name],
            _matched(users, *args, on['candidates'], mixture).cpu().numpy())


# -- mesh training: mesh ranks on the card ---------------------------------------

def _mesh_step_case(steps):
    """The implicit-MF step case of ``tests/test_torch_mesh_training.py``,
    its state drawn by the port, run ``steps`` times on one batch."""
    from spotlight_tpu_torch.factorization.representations import (
        BilinearNet)

    rs = np.random.RandomState(11)
    users, items, dim, batch = 40, 103, 8, 32
    net = BilinearNet(users, items, dim,
                      generator=torch.Generator().manual_seed(2))
    return {'loss': 'bpr', 'dim': dim, 'batch': batch, 'lr': 1e-2,
            'l2': 1e-6, 'num_users': users, 'num_items': items,
            'pairs': (rs.randint(0, users, batch),
                      rs.randint(0, items, batch)),
            'negatives': rs.randint(0, items, batch),
            'negative_weight': np.ones(batch, np.float32), 'steps': steps,
            'state': {name: value.detach().numpy()
                      for name, value in net.state_dict().items()}}


def test_mesh_training_steps_of_four_gloo_ranks_on_one_card(cuda, tmp_path):
    """Phase 16 (a) of ``chip_smoke.py`` at a small size: four gloo ranks
    share the card at data=2 x model=2 and take 2 steps under each
    exchange; every rank's blocks of tables and moments equal the blocks
    of one device's 2 steps on the card (parameters atol 1e-6, moments
    1e-6 of the largest, as ``tests/test_torch_mesh_training.py`` holds
    them on the CPU)."""
    from tests import torch_mesh_worker

    case = _mesh_step_case(steps=2)
    ranks = torch_mesh_worker.run_ranks(
        {'layouts': ((2, 2),), 'training': {'step': case}}, tmp_path,
        devices=['cuda:0'] * 4, timeout=600)
    want = torch_mesh_worker.one_step(
        torch_mesh_worker.implicit_model(case, None, device='cuda'), case,
        None, 'psum')
    for rank, results in enumerate(ranks):
        for exchange in torch_mesh_worker.EXCHANGES:
            torch_mesh_worker.assert_step_close(
                results[(2, 2)]['step', exchange], want, (2, 2), rank)


def test_mesh_training_step_on_a_one_rank_nccl_group(cuda, tmp_path):
    """Phase 16 (b) at a small size: a step under each exchange on the
    mesh of a one-rank NCCL group (whose axes of one rank send nothing)
    equals one device's on the card bit for bit."""
    from tests import torch_mesh_worker

    case = _mesh_step_case(steps=1)
    [rank] = torch_mesh_worker.run_ranks(
        {'layouts': ((1, 1),), 'training': {'step': case}}, tmp_path,
        world=1, backend='nccl', devices=['cuda:0'], timeout=600)
    want = torch_mesh_worker.one_step(
        torch_mesh_worker.implicit_model(case, None, device='cuda'), case,
        None, 'psum')
    for exchange in torch_mesh_worker.EXCHANGES:
        loss, params, moments = rank[(1, 1)]['step', exchange]
        assert loss == want[0]
        torch_mesh_worker.assert_same(params, want[1])
        torch_mesh_worker.assert_same(moments, want[2])


#: SASRec at its published ML-1M widths (``benchmark/configs/sasrec_ml1m.json``).
SASREC_ITEMS, SASREC_DIM, SASREC_BLOCKS, SASREC_WINDOW = 3417, 50, 2, 200
#: The port against the plain reference on the card, both float32 with TF32
#: off: the same sums in other orders (cuBLAS's blocking against the
#: reference's products, fused LayerNorm and softmax against their
#: written-out forms), a few float32 roundings through two blocks on
#: representations of order 1.  The reference's TF32 control lies past 10x
#: this (asserted below), so the tolerance tells the precisions apart.
SASREC_REPR_ATOL = 2e-5
#: A training step's gradients against the reference's autograd, by
#: parameter, as a share of the reference gradient's largest element
#: (float64) or of its norm (float32).  In float64 both sides follow the
#: same function, the port's gathered rows rounded to float32 as they are
#: stored, so the gradients agree to that rounding.  In float32 a ReLU
#: input within a rounding of 0 takes either side in two computations
#: (the card runs showed one such unit in 256 x 200 x 50 x 2), and a
#: flipped unit moves every gradient upstream of it by its whole
#: contribution: a few parts in a thousand of a gradient's norm on
#: 256 histories, which 2e-2 holds with room.
SASREC_GRAD_TOL = {torch.float64: 1e-6, torch.float32: 2e-2}


def _sasrec_case(device, histories=256, dtype=torch.float32):
    """A seeded ``SelfAttentionNet`` at the published widths (every
    parameter moved off its initialisation) in ``dtype``, dropout 0, and
    ``histories`` ragged left-padded histories of 200 items (lengths 1 to
    200, two of padding only)."""
    from spotlight_tpu_torch.sequence import SelfAttentionNet

    generator = torch.Generator().manual_seed(24)
    net = SelfAttentionNet(SASREC_ITEMS, SASREC_DIM,
                           num_blocks=SASREC_BLOCKS,
                           max_sequence_length=SASREC_WINDOW, dropout=0.0,
                           generator=generator)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=generator))
        net.item_embeddings.weight[0] = 0.0
    rs = np.random.RandomState(24)
    rows = rs.randint(1, SASREC_ITEMS, (histories, SASREC_WINDOW))
    lengths = rs.randint(1, SASREC_WINDOW + 1, histories)
    lengths[:2] = 0
    rows[np.arange(SASREC_WINDOW)[None, :]
         < (SASREC_WINDOW - lengths)[:, None]] = 0
    return (net.to(device=device, dtype=dtype),
            torch.as_tensor(rows, device=device))


def test_sasrec_forward_on_the_card_matches_the_reference(cuda):
    """The published widths, 256 histories: ``per_step``, ``final`` and the
    catalogue scores on the card against ``benchmark/reference/sasrec.py``
    on the card, both with TF32 off; the reference's TF32 control is
    further off than 10x the tolerance."""
    from benchmark.reference import sasrec

    assert not torch.backends.cuda.matmul.allow_tf32
    net, rows = _sasrec_case(cuda)
    prefixes = rows[:, :-1]
    weights = {n: p.detach() for n, p in net.named_parameters()}
    with torch.no_grad():
        per_step, final = net.eval().user_representation(prefixes)
        scores = net.score_catalog(final)
    want = sasrec.representations(weights, prefixes, SASREC_BLOCKS)
    control = sasrec.representations(weights, prefixes, SASREC_BLOCKS,
                                     'tf32')
    gaps = [float((per_step - want[:, :-1]).abs().max()),
            float((final - want[:, -1]).abs().max()),
            float((control - want).abs().max())]
    print('sasrec forward gaps (per_step, final, tf32 control):', gaps)
    assert max(gaps[:2]) <= SASREC_REPR_ATOL, gaps
    assert gaps[2] > 10 * SASREC_REPR_ATOL, gaps
    want_scores = sasrec.catalogue_scores(weights, want[:, -1])
    torch.testing.assert_close(scores, want_scores, rtol=0,
                               atol=SASREC_REPR_ATOL * 10)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32],
                         ids=['float64', 'float32'])
def test_sasrec_step_on_the_card_matches_the_reference(cuda, dtype):
    """One dense training step of the estimator on the card, 256 histories
    in one batch: its loss and every gradient against the reference's
    autograd on the card, from the same draws and weights, in ``dtype``
    (``SASREC_GRAD_TOL``)."""
    from benchmark.reference import sasrec
    from spotlight_tpu_torch.utils.training import epoch_draws
    from tests.test_torch_self_attention import Recorder

    net, rows = _sasrec_case(cuda, dtype=dtype)
    weights = {n: p.detach().clone().requires_grad_()
               for n, p in net.named_parameters()}
    recorder = Recorder()
    model = ImplicitSequenceModel(
        loss='bpr', representation=net, n_iter=1, batch_size=len(rows),
        optimizer_func=lambda: recorder, device=cuda,
        random_state=np.random.RandomState(5))
    generator = torch.Generator()
    generator.set_state(model._generator.get_state())
    perm, negatives = epoch_draws(generator, len(rows),
                                  (1, len(rows), SASREC_WINDOW),
                                  SASREC_ITEMS, cuda)
    model.fit(SequenceInteractions(rows.cpu().numpy(),
                                   num_items=SASREC_ITEMS))
    loss = sasrec.bpr_loss(weights, rows[perm], negatives[0],
                           torch.ones(len(rows), dtype=torch.bool,
                                      device=cuda), SASREC_BLOCKS)
    np.testing.assert_allclose(model._last_epoch_loss, loss.item(),
                               rtol=1e-5)
    names = list(weights)
    want = dict(zip(names, torch.autograd.grad(loss, list(weights.values()),
                                               allow_unused=True)))
    got, = recorder.grads
    gaps = {}
    for name in names:
        if want[name] is None:
            assert not got[name].any(), name
            continue
        diff = got[name] - want[name]
        gaps[name] = (float(diff.abs().max() / want[name].abs().max())
                      if dtype == torch.float64
                      else float(diff.norm() / want[name].norm()))
    print('sasrec step gradient gaps ({}):'.format(dtype),
          max(gaps.values()), max(gaps, key=gaps.get))
    assert max(gaps.values()) <= SASREC_GRAD_TOL[dtype], gaps


#: The LayerNorm kernel against its plain version and ``F.layer_norm`` on
#: the card, float32: the same function with the row's two sums in other
#: orders (a warp's butterfly against torch's reductions), on outputs of
#: order 1 (standard-normal rows, a gain near 1): a few float32 roundings,
#: about 1e-6; a wrong mean, variance, gain or offset is off by 1e-2 or
#: more.  The blocks' own tolerance against the reference is the same
#: 2e-05 (``SASREC_REPR_ATOL``).
LAYER_NORM_ATOL = 2e-5


def _layer_norm_operands(shape, dtype=torch.float32, seed=27):
    """Standard-normal rows of ``shape`` on the card, every fifth leading
    row zero (a padding step) and every seventh a dyadic constant (0.75:
    its sum and mean are exact, so ``x - mean`` is 0), a gain near 1 and an
    offset near 0.  Returns ``(x, weight, bias, constant)``, the last the
    mask of zero and constant rows."""
    generator = torch.Generator(device='cuda').manual_seed(seed)
    dim = shape[-1]
    x = torch.randn(shape, generator=generator, device='cuda', dtype=dtype)
    rows = x.view(-1, dim)
    rows[::5] = 0.0
    rows[3::7] = 0.75
    constant = torch.zeros(rows.shape[0], dtype=torch.bool, device='cuda')
    constant[::5] = True
    constant[3::7] = True
    weight = 1 + 0.1 * torch.randn(dim, generator=generator, device='cuda',
                                   dtype=dtype)
    bias = 0.1 * torch.randn(dim, generator=generator, device='cuda',
                             dtype=dtype)
    return x, weight, bias, constant.view(shape[:-1])


@pytest.mark.parametrize('eps', [1e-8, 1e-5])
@pytest.mark.parametrize('shape', [(2048, 200, 50), (4096, 1), (4096, 7),
                                   (4096, 32), (4096, 50), (4096, 64),
                                   (4096, 100), (3000, 1024)],
                         ids=lambda shape: 'x'.join(map(str, shape)))
def test_layer_norm_kernel_matches_plain_and_functional(cuda, shape, eps):
    """One launch under ``no_grad`` (``y`` alone) and one through autograd
    (``y``, the mean and rstd): against the plain version and
    ``F.layer_norm`` within ``LAYER_NORM_ATOL``; zero and dyadic constant
    rows give the offset exactly, in the kernel and the plain version (its
    quotients by D exact, as the kernel's; at D=7 a product with 1/7 would
    miss a row of 0.75's mean, and rsqrt(eps) scales that to 7e-04)."""
    x, weight, bias, constant = _layer_norm_operands(shape)
    dim = shape[-1]
    before = layer_norm.LAYER_NORM_LAUNCHES
    with torch.no_grad():
        y = layer_norm.layer_norm(x, weight, bias, eps)
    assert layer_norm.LAYER_NORM_LAUNCHES == before + 1
    plain, mean, rstd = layer_norm.layer_norm_plain(x, weight, bias, eps)
    library = F.layer_norm(x, (dim,), weight, bias, eps)
    for want in (plain, library):
        torch.testing.assert_close(y, want, rtol=0, atol=LAYER_NORM_ATOL)
    for got in (y, plain):
        assert torch.equal(got[constant], bias.expand_as(got[constant]))
    y_grad, mean_k, rstd_k = layer_norm._forward(x, weight, bias, eps,
                                                 stats=True)
    assert torch.equal(y_grad, y)
    torch.testing.assert_close(mean_k, mean, rtol=0, atol=1e-6)
    torch.testing.assert_close(rstd_k, rstd, rtol=1e-5, atol=0)


def test_layer_norm_kernel_float64_and_gradients(cuda):
    """float64 through the kernel against ``F.layer_norm`` to float64
    rounding; float32 gradients of the input, gain and offset through the
    kernel's forward and the plain backward against ``F.layer_norm``'s
    autograd, as a share of each gradient's largest element."""
    x, weight, bias, _ = _layer_norm_operands((64, 200, 50), torch.float64)
    with torch.no_grad():
        y = layer_norm.layer_norm(x, weight, bias, 1e-8)
    torch.testing.assert_close(y, F.layer_norm(x, (50,), weight, bias, 1e-8),
                               rtol=0, atol=1e-12)
    x, weight, bias, _ = _layer_norm_operands((256, 200, 50))
    for t in (x, weight, bias):
        t.requires_grad_()
    before = layer_norm.LAYER_NORM_LAUNCHES
    y = layer_norm.layer_norm(x, weight, bias, 1e-8)
    assert layer_norm.LAYER_NORM_LAUNCHES == before + 1
    want_y = F.layer_norm(x, (50,), weight, bias, 1e-8)
    torch.testing.assert_close(y, want_y, rtol=0, atol=LAYER_NORM_ATOL)
    cotangent = torch.randn_like(y)
    got = torch.autograd.grad(y, (x, weight, bias), cotangent)
    want = torch.autograd.grad(want_y, (x, weight, bias), cotangent)
    for name, g, w in zip(('x', 'weight', 'bias'), got, want):
        gap = float((g - w).abs().max() / w.abs().max())
        assert gap <= LAYER_NORM_ATOL, (name, gap)


def test_layer_norm_kernel_refuses_wide_rows_and_other_dtypes(cuda):
    x, weight, bias, _ = _layer_norm_operands((8, 1025))
    with pytest.raises(ValueError, match='at most 1024'):
        layer_norm.layer_norm(x, weight, bias, 1e-8)
    x, weight, bias, _ = _layer_norm_operands((8, 50))
    with pytest.raises(ValueError, match='float32 or float64'):
        layer_norm.layer_norm(
            *(t.to(torch.bfloat16) for t in (x, weight, bias)), 1e-8)


def test_sasrec_forward_launches_five_layer_norms(cuda):
    """Two blocks: two LayerNorms each and the final one, all through the
    kernel."""
    net, rows = _sasrec_case(cuda, histories=16)
    before = layer_norm.LAYER_NORM_LAUNCHES
    with torch.no_grad():
        net.eval().user_representation(rows[:, :-1])
    assert layer_norm.LAYER_NORM_LAUNCHES == before + 2 * SASREC_BLOCKS + 1
