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
    """Inputs and JAX weights of a 13-wide target block."""
    rs = np.random.RandomState(13)
    users, items, bias = _gaussian(rs, 8, 16, 600)
    ids = rs.randint(0, 600, (8, 13)).astype(np.int32)
    return users, items, bias, ids, _jax_rank_weights(users, items, bias,
                                                      ids)[0]


@pytest.mark.parametrize('num_targets', [1, 3, 9, 13])
def test_rank_weights_target_widths(num_targets):
    """Widths that are not multiples of 8: each target's weight depends on
    its own column only, so the port's narrower calls equal the leading
    columns of one 13-wide JAX call."""
    users, items, bias, ids, want = _wide_targets()
    got, _ = _port_rank_weights(users, items, bias,
                                np.ascontiguousarray(ids[:, :num_targets]))
    assert got.shape == (8, num_targets)
    np.testing.assert_array_equal(got, want[:, :num_targets])


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


@pytest.mark.parametrize('k', [10, 200, 700])
def test_streaming_topk_matches_jax(k):
    rs = np.random.RandomState(k)
    users, items, bias = _gaussian(rs, 8, 16, 700)
    want_s, want_i = _jax_topk(users, items, bias, k)
    got_s, got_i = _port_topk(users, items, bias, k)
    assert got_i.shape == (8, k) and got_i.dtype == np.int32
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('k', [5, 24, 150, 300])
def test_streaming_topk_dyadic_ties_exact(k):
    """Every score appears 80 times; the lower id comes first on ties."""
    rs = np.random.RandomState(7)
    users, items, bias = _dyadic_catalogue(rs, 8, 16, 8, 80)
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
    """-0.0 and +0.0 tie; the result carries +0.0 (the kernel's keys do)."""
    users = torch.tensor([[1.0], [-1.0]])
    items = torch.tensor([[0.0], [0.0], [1.0]])
    bias = torch.zeros(3)
    scores, ids = topk.streaming_topk(users, items, bias, 3)
    assert ids.tolist() == [[2, 0, 1], [0, 1, 2]]
    assert not torch.signbit(scores[scores == 0]).any()


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
