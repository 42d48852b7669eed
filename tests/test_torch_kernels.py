"""The port's evaluation kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode.  Both get the same numpy inputs.  Rank
weights are half-integer counts and must match exactly; top-k ids must
match exactly, tie order included.  Scores are compared to 1e-6 relative:
the two packages sum the D products in different orders (an MXU-style dot
against the port's fixed sequential order), except on dyadic catalogues,
whose scores are exact in any order and so must be equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.ops.kernels import ranking as jax_ranking
from spotlight_tpu.ops.kernels import topk as jax_topk
from spotlight_tpu_torch.ops.kernels import _build, ranking, topk


def _jax_rank_weights(users, items, bias, ids):
    args = (jnp.asarray(users), jnp.asarray(items), jnp.asarray(bias))
    ts = jax_ranking.matched_target_scores(*args, jnp.asarray(ids))
    weights = jax_ranking.rank_weights(*args, ts, tile_items=256,
                                       interpret=True)
    return np.asarray(weights), np.asarray(ts)


def _port_rank_weights(users, items, bias, ids, item_dtype=torch.float32):
    args = (torch.from_numpy(users), torch.from_numpy(items).to(item_dtype),
            torch.from_numpy(bias))
    ts = ranking.matched_target_scores(*args, torch.from_numpy(ids))
    return ranking.rank_weights(*args, ts).numpy(), ts.numpy()


def _gaussian(rs, batch, dim, num_items):
    users = rs.randn(batch, dim).astype(np.float32)
    items = rs.randn(num_items, dim).astype(np.float32)
    bias = rs.randn(num_items).astype(np.float32)
    return users, items, bias


def _dyadic(rs, shape, denominator=8):
    """Entries k / denominator with |k| <= denominator: products and sums of
    a few of them are exact in float32, whatever the order."""
    return (rs.randint(-denominator, denominator + 1, shape)
            / denominator).astype(np.float32)


def _dyadic_catalogue(rs, batch, dim, num_base, copies):
    """Tie-heavy catalogue: ``num_base`` dyadic rows repeated ``copies``
    times, so every score appears ``copies`` times."""
    users = _dyadic(rs, (batch, dim))
    items = np.tile(_dyadic(rs, (num_base, dim)), (copies, 1))
    bias = np.tile(_dyadic(rs, num_base, 64), copies)
    return users, items, bias


def test_rank_weights_matches_jax_gaussian():
    rs = np.random.RandomState(7)
    users, items, bias = _gaussian(rs, 8, 16, 700)
    items[9], bias[9] = items[3], bias[3]   # a duplicate row forces a tie
    ids = rs.randint(0, 700, (8, 5)).astype(np.int32)
    ids[:, 0] = 3

    want, want_ts = _jax_rank_weights(users, items, bias, ids)
    got, got_ts = _port_rank_weights(users, items, bias, ids)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_ts, want_ts, rtol=1e-6, atol=1e-6)
    # The duplicate of each user's first target ties it: 0.5 (self) + 0.5.
    assert np.all(got[:, 0] == np.floor(got[:, 0]))


def test_rank_weights_matches_jax_dyadic_ties():
    rs = np.random.RandomState(3)
    users, items, bias = _dyadic_catalogue(rs, 8, 16, 8, 80)
    ids = rs.randint(0, len(items), (8, 6)).astype(np.int32)

    want, want_ts = _jax_rank_weights(users, items, bias, ids)
    got, got_ts = _port_rank_weights(users, items, bias, ids)
    np.testing.assert_array_equal(got_ts, want_ts)
    np.testing.assert_array_equal(got, want)
    # Each target ties its 80 copies: the tie bucket was exercised.
    assert np.all(got % 1 == 0)


def test_rank_weights_padding_rows_never_count():
    rs = np.random.RandomState(11)
    users, items, _ = _gaussian(rs, 4, 8, 130)
    bias = np.full(130, -1e30, np.float32)   # every score is very low
    ids = np.zeros((4, 1), np.int32)

    got, _ = _port_rank_weights(users, items, bias, ids)
    want, _ = _jax_rank_weights(users, items, bias, ids)
    scores = users @ items.T + bias[None]
    expected = ((scores > scores[:, :1]).sum(axis=1)
                + 0.5 * (scores == scores[:, :1]).sum(axis=1))
    np.testing.assert_array_equal(got[:, 0], expected)
    np.testing.assert_array_equal(got, want)


@functools.lru_cache(maxsize=None)
def _wide_targets():
    """Inputs and JAX weights of a 129-wide target block."""
    rs = np.random.RandomState(13)
    users, items, bias = _gaussian(rs, 8, 16, 600)
    ids = rs.randint(0, 600, (8, 129)).astype(np.int32)
    return users, items, bias, ids, _jax_rank_weights(users, items, bias,
                                                      ids)[0]


@pytest.mark.parametrize('num_targets', [1, 3, 5, 9, 13, 129])
def test_rank_weights_target_widths(num_targets):
    """Widths that are not multiples of 8, on both sides of the CUDA
    kernel's 4 targets in registers and 128 a launch: each target's weight
    depends on its own column only, so the port's narrower calls equal the
    leading columns of one 129-wide JAX call."""
    users, items, bias, ids, want = _wide_targets()
    got, _ = _port_rank_weights(users, items, bias,
                                np.ascontiguousarray(ids[:, :num_targets]))
    assert got.shape == (8, num_targets)
    np.testing.assert_array_equal(got, want[:, :num_targets])


@pytest.mark.parametrize('num_targets', [1, 5, 129])
def test_rank_weights_tile_edges_match_jax(num_targets):
    """N = 129 and D = 33: one row past the CUDA kernel's 128-item tile and
    one dimension past its 32-dimension slab; a duplicated row ties."""
    rs = np.random.RandomState(num_targets)
    users, items, bias = _gaussian(rs, 5, 33, 129)
    items[128], bias[128] = items[0], bias[0]
    ids = rs.randint(0, 129, (5, num_targets)).astype(np.int32)
    ids[:, 0] = 128
    want, want_ts = _jax_rank_weights(users, items, bias, ids)
    got, got_ts = _port_rank_weights(users, items, bias, ids)
    np.testing.assert_array_equal(got, want)
    # 33 products of N(0, 1) operands summed in two orders: float32
    # rounding of partial sums up to ~10 (a few 1e-6 apart).
    np.testing.assert_allclose(got_ts, want_ts, rtol=1e-6, atol=1e-5)
    assert np.all(got[:, 0] % 1 == 0)    # row 128 ties row 0


def test_rank_weights_bf16_items():
    rs = np.random.RandomState(5)
    users, items, bias = _gaussian(rs, 8, 16, 500)
    items = torch.from_numpy(items).to(torch.bfloat16).float().numpy()
    ids = rs.randint(0, 500, (8, 4)).astype(np.int32)

    args = (jnp.asarray(users), jnp.asarray(items).astype(jnp.bfloat16),
            jnp.asarray(bias))
    ts = jax_ranking.matched_target_scores(*args, jnp.asarray(ids))
    want = np.asarray(jax_ranking.rank_weights(*args, ts, tile_items=256,
                                               interpret=True))
    got, _ = _port_rank_weights(users, items, bias, ids,
                                item_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got, want)
    # The bf16 upcast is exact: the float32 table of the same values
    # ranks identically.
    f32, _ = _port_rank_weights(users, items, bias, ids)
    np.testing.assert_array_equal(got, f32)


def test_matched_scores_tie_the_catalogue_pass():
    """The exact-tie contract on the CPU: a target's matched score equals
    its own catalogue score bit for bit, so every target ties itself."""
    rs = np.random.RandomState(2)
    users, items, bias = (torch.from_numpy(a)
                          for a in _gaussian(rs, 16, 32, 900))
    ids = torch.from_numpy(rs.randint(0, 900, (16, 7)))
    ts = ranking.matched_target_scores(users, items, bias, ids)
    catalogue = ranking.plain_scores(users, items, bias).T     # (B, N)
    assert torch.equal(ts, torch.gather(catalogue, 1, ids))
    weights = ranking.rank_weights(users, items, bias, ts)
    assert bool((weights >= 0.5).all())


def _out_of_range_ids(rs, batch, width, num_items):
    """Ids in [-5, N + 5), with -1, the int32 extremes and N among them."""
    ids = rs.randint(-5, num_items + 5, (batch, width))
    ids[0, :4] = [-1, -2 ** 31, num_items, 2 ** 31 - 1]
    return ids


@pytest.mark.parametrize('item_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ids_dtype', [torch.int32, torch.int64])
def test_matched_target_scores_clamp_ids_as_jax_clips_them(ids_dtype,
                                                           item_dtype):
    """K1c against the JAX function on ids outside [0, N): the port clamps
    them (on the card inside the kernel) as the JAX callers clip them
    before the call, and int32 and int64 ids give the same bits.  Dyadic
    operands score exactly in any order, so the two packages agree
    exactly."""
    rs = np.random.RandomState(8)
    num_items = 300
    users, items, bias = _dyadic_catalogue(rs, 9, 24, num_items, 1)
    ids = _out_of_range_ids(rs, 9, 13, num_items)
    want = jax_ranking.matched_target_scores(
        jnp.asarray(users), jnp.asarray(items).astype(
            jnp.bfloat16 if item_dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(bias), jnp.clip(jnp.asarray(ids), 0, num_items - 1))
    args = (torch.from_numpy(users), torch.from_numpy(items).to(item_dtype),
            torch.from_numpy(bias))
    got = ranking.matched_target_scores(*args,
                                        torch.from_numpy(ids).to(ids_dtype))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    other = torch.int64 if ids_dtype == torch.int32 else torch.int32
    again = ranking.matched_target_scores(*args,
                                          torch.from_numpy(ids).to(other))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize('batch,num_targets,pair_slots', [
    (2048, 4, 256), (2048, 24, 256), (2048, 1, 32), (2048, 49, 32),
    (2048, 49, 256), (2048, 1, 16), (37, 130, 256), (5, 300, 16),
    (1, 1, 256), (100_000, 1, 256), (3, 130, 32)])
def test_matched_launch_shape_covers_every_pair(batch, num_targets,
                                                pair_slots):
    """The matched-pair grid: each block at most ``pair_slots`` pairs, a
    user's targets in equal chunks that leave none empty, and about one
    wave of 132 blocks where the batch has the pairs for it."""
    users, chunk = ranking.matched_launch_shape(batch, num_targets,
                                                pair_slots, 132)
    assert users >= 1 and 1 <= chunk and users * chunk <= pair_slots
    chunks = -(-num_targets // chunk)
    assert (chunks - 1) * chunk < num_targets <= chunks * chunk
    blocks = -(-batch // users) * chunks
    assert blocks <= 132 + chunks or users * chunk * 2 > pair_slots
    if (batch, num_targets, pair_slots) == (2048, 4, 256):
        assert (users, blocks) == (16, 128)      # K1c's targets: one wave


def _jax_topk(users, items, bias, k):
    scores, ids = jax_topk.streaming_topk(
        jnp.asarray(users), jnp.asarray(items), jnp.asarray(bias), k,
        tile_items=256, interpret=True)
    return np.asarray(scores), np.asarray(ids)


def _port_topk(users, items, bias, k):
    scores, ids = topk.streaming_topk(torch.from_numpy(users),
                                      torch.from_numpy(items),
                                      torch.from_numpy(bias), k)
    return scores.numpy(), ids.numpy()


@pytest.mark.parametrize('k,batch,dim,num_items', [
    pytest.param(10, 8, 16, 700, id='10'),
    pytest.param(200, 8, 16, 700, id='200'),
    pytest.param(700, 8, 16, 700, id='700'),
    # The CUDA kernel's tile edges (128-item tiles, 32-dimension slabs,
    # 64 or 32 users a block, lists of 16-256 keys): ragged N, D and B.
    pytest.param(1, 1, 1, 127, id='B1-D1-N127-k1'),
    pytest.param(17, 65, 3, 128, id='B65-D3-N128-k17'),
    pytest.param(65, 65, 5, 129, id='B65-D5-N129-k65'),
    pytest.param(16, 63, 5, 1000, id='B63-D5-N1000-k16'),
])
def test_streaming_topk_matches_jax(k, batch, dim, num_items):
    rs = np.random.RandomState(k + num_items)
    users, items, bias = _gaussian(rs, batch, dim, num_items)
    want_s, want_i = _jax_topk(users, items, bias, k)
    got_s, got_i = _port_topk(users, items, bias, k)
    assert got_i.shape == (batch, k) and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('k,batch,dim,num_base,copies', [
    pytest.param(5, 8, 16, 8, 80, id='5'),
    pytest.param(24, 8, 16, 8, 80, id='24'),
    pytest.param(150, 8, 16, 8, 80, id='150'),
    pytest.param(300, 8, 16, 8, 80, id='300'),
    # The CUDA kernel's tile edges, as in test_streaming_topk_matches_jax.
    pytest.param(1, 1, 1, 127, 1, id='B1-D1-N127-k1'),
    pytest.param(16, 65, 3, 43, 3, id='B65-D3-N129-k16'),
    pytest.param(17, 65, 5, 32, 4, id='B65-D5-N128-k17'),
])
def test_streaming_topk_dyadic_ties_exact(k, batch, dim, num_base, copies):
    """Every score appears ``copies`` times; the lower id comes first on
    ties."""
    rs = np.random.RandomState(7)
    users, items, bias = _dyadic_catalogue(rs, batch, dim, num_base, copies)
    want_s, want_i = _jax_topk(users, items, bias, k)
    got_s, got_i = _port_topk(users, items, bias, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)
    scores = users @ items.T + bias[None]
    order = np.argsort(-scores, axis=1, kind='stable')[:, :k]
    np.testing.assert_array_equal(got_i, order)


@pytest.mark.parametrize('k', [7, 130])
def test_streaming_topk_ascending_catalogue(k):
    """Scores rise with the item id for every user, so each new tile beats
    the whole running list: the adversarial order for a streaming top-k."""
    rs = np.random.RandomState(1)
    num_items, dim = 600, 4
    users = np.abs(_dyadic(rs, (8, dim))) + 0.125
    items = np.repeat((np.arange(num_items) / 64).astype(np.float32)[:, None],
                      dim, axis=1)
    bias = np.zeros(num_items, np.float32)
    want_s, want_i = _jax_topk(users, items, bias, k)
    got_s, got_i = _port_topk(users, items, bias, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(
        got_i, np.broadcast_to(np.arange(num_items - 1, num_items - 1 - k,
                                         -1), (8, k)))


def test_streaming_topk_k_beyond_catalogue_raises():
    rs = np.random.RandomState(0)
    users, items, bias = (torch.from_numpy(a) for a in _gaussian(rs, 2, 4, 9))
    with pytest.raises(ValueError, match='exceeds the catalog size'):
        topk.streaming_topk(users, items, bias, 10)
    with pytest.raises(ValueError, match='positive'):
        topk.streaming_topk(users, items, bias, 0)


def test_streaming_topk_rounds_equal_one_sort():
    """Fetches wider than one launch run in resume rounds; the rounds give
    exactly the one-sort answer, ties across round boundaries included."""
    rs = np.random.RandomState(4)
    users, items, bias = (torch.from_numpy(a)
                          for a in _dyadic_catalogue(rs, 4, 8, 16, 60))
    k = topk.SINGLE_LAUNCH_K + 300
    scores, ids = topk.streaming_topk(users, items, bias, k)
    want_s, want_i = topk.streaming_topk_plain(users, items, bias, k)
    assert torch.equal(ids, want_i) and torch.equal(scores, want_s)


def test_streaming_topk_negative_zero_reads_as_zero():
    """A score of -0.0 comes back as -0.0, as JAX's streaming_topk returns
    it: a one-term dot of -0.0 plus a -0.0 bias is -0.0 (user 1), of +0.0
    plus -0.0 it is +0.0 (user 0).  Equal scores keep the lower id first."""
    users = np.array([[1.0], [-1.0]], np.float32)
    items = np.array([[0.0], [0.0], [1.0], [0.0]], np.float32)
    bias = np.full(4, -0.0, np.float32)
    want_s, want_i = _jax_topk(users, items, bias, 4)
    got_s, got_i = _port_topk(users, items, bias, 4)
    np.testing.assert_array_equal(got_i, want_i)
    assert got_i.tolist() == [[2, 0, 1, 3], [0, 1, 3, 2]]
    np.testing.assert_array_equal(got_s, want_s)
    assert torch.equal(torch.signbit(torch.from_numpy(got_s)),
                       torch.signbit(torch.from_numpy(want_s)))
    assert torch.signbit(torch.from_numpy(got_s)).any()


@pytest.mark.parametrize('bad', ['users_dtype', 'width', 'bias_shape',
                                 'target_rows'])
def test_wrappers_reject_bad_operands(bad):
    users, items = torch.zeros(2, 4), torch.zeros(5, 4)
    bias, ts = torch.zeros(5), torch.zeros(2, 1)
    if bad == 'users_dtype':
        users = users.double()
    elif bad == 'width':
        items = torch.zeros(5, 3)
    elif bad == 'bias_shape':
        bias = torch.zeros(5, 1)
    else:
        ts = torch.zeros(3, 1)
    with pytest.raises(ValueError):
        ranking.rank_weights(users, items, bias, ts)


def test_wrappers_take_only_cpu_or_cuda_tensors():
    users = torch.zeros(2, 4, device='meta')
    items, bias = torch.zeros(5, 4, device='meta'), torch.zeros(5,
                                                                device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        topk.streaming_topk(users, items, bias, 2)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(_build.shutil, 'which', lambda name: None)
    monkeypatch.setattr(_build, '_cuda_home', lambda: None)
    with pytest.raises(RuntimeError, match='nvcc'):
        _build.build()


def test_library_name_follows_the_source(monkeypatch, tmp_path):
    """An edited source gets a new library name, so a stale build is never
    loaded."""
    before = _build.library_path('ranking')
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    for path in _build.CSRC.iterdir():
        (csrc / path.name).write_bytes(path.read_bytes())
    (csrc / 'ranking.cu').write_text(
        (csrc / 'ranking.cu').read_text() + '\n// edited\n')
    monkeypatch.setattr(_build, 'CSRC', csrc)
    assert _build.library_path('ranking').name != before.name
    assert _build.library_path('topk').parent == before.parent


def test_cpu_tensors_take_the_plain_versions_uncounted(monkeypatch):
    """On CPU tensors no kernel is built or launched, so no count moves."""
    monkeypatch.setattr(_build, 'load', lambda name: pytest.fail(
        'a CPU call reached the CUDA build'))
    before = (ranking.RANK_WEIGHTS_LAUNCHES, ranking.MATCHED_SCORES_LAUNCHES,
              topk.STREAMING_TOPK_LAUNCHES)
    rs = np.random.RandomState(6)
    users, items, bias = (torch.from_numpy(a) for a in _gaussian(rs, 3, 4, 50))
    ts = ranking.matched_target_scores(users, items, bias,
                                       torch.zeros(3, 2, dtype=torch.int64))
    ranking.rank_weights(users, items, bias, ts)
    topk.streaming_topk(users, items, bias, 5)
    assert before == (ranking.RANK_WEIGHTS_LAUNCHES,
                      ranking.MATCHED_SCORES_LAUNCHES,
                      topk.STREAMING_TOPK_LAUNCHES)
