"""The port's rank counts (K5) and ``reciprocal_ranks_streaming`` against the
JAX package's.

On the CPU ``rank_counts`` runs its plain PyTorch version; the JAX
``rank_counts`` runs its Pallas kernel in interpret mode.  Both get the
same numpy inputs and the same ``target_scores`` array, and the counts must
be equal exactly: on dyadic catalogues every score is exact in any
summation order, and the target is excluded by id, so a 1-ulp difference in
its own score cannot move it.  Mixture scores go through ``exp`` and are
not dyadic; with N(0, 1) operands no other item lies within float32
rounding of a target, so those counts too must be equal.
``reciprocal_ranks_streaming`` agrees to rtol 1e-6 (half-integer ranks,
float32 means).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.ops.kernels import ranking as jax_ranking
from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.ops.kernels import ranking

from tests.test_torch_kernels import _dyadic, _dyadic_catalogue, _gaussian

TILE = 256


def _jax_counts(users, items, bias, ts, ids, mixtures=None):
    score_fn = (None if mixtures is None else
                jax_ranking.make_mixture_score_fn(mixtures, items.shape[1]))
    greater, equal = jax_ranking.rank_counts(
        jnp.asarray(users), jnp.asarray(items), jnp.asarray(bias),
        jnp.asarray(ts), jnp.asarray(ids), tile_items=TILE, interpret=True,
        score_fn=score_fn)
    return np.asarray(greater), np.asarray(equal)


def _port_counts(users, items, bias, ts, ids, mixtures=None):
    greater, equal = ranking.rank_counts(
        torch.from_numpy(users), torch.from_numpy(items),
        torch.from_numpy(bias), torch.from_numpy(ts), torch.from_numpy(ids),
        mixtures)
    assert greater.dtype == equal.dtype == torch.float32
    return greater.numpy(), equal.numpy()


def _assert_counts_match(users, items, bias, ts, ids, mixtures=None):
    got = _port_counts(users, items, bias, ts, ids, mixtures)
    want = _jax_counts(users, items, bias, ts, ids, mixtures)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    return got


def _catalogue_scores(users, items, bias):
    return (users.astype(np.float64) @ items.T.astype(np.float64)
            + bias).astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1])
def test_rank_counts_matches_jax_dyadic(seed):
    """Tie-heavy dyadic catalogue (every score 40 times); target scores are
    the targets' own catalogue scores, so they tie their copies."""
    rs = np.random.RandomState(seed)
    users, items, bias = _dyadic_catalogue(rs, 16, 8, 20, 40)
    ids = rs.randint(0, items.shape[0], (16, 6)).astype(np.int32)
    ts = np.take_along_axis(_catalogue_scores(users, items, bias), ids, 1)
    greater, equal = _assert_counts_match(users, items, bias, ts, ids)
    # Each target ties its 39 copies, not itself.
    assert np.all(equal >= 39)


def test_rank_counts_wide_targets_match_jax():
    """T = 300, past the kernel's 32-wide target chunk."""
    rs = np.random.RandomState(0)
    users, items, bias = _dyadic(rs, (4, 16)), _dyadic(rs, (700, 16)), \
        _dyadic(rs, 700, 64)
    ids = rs.randint(0, 700, (4, 300)).astype(np.int32)
    ts = np.take_along_axis(_catalogue_scores(users, items, bias), ids, 1)
    _assert_counts_match(users, items, bias, ts, ids)


@pytest.mark.parametrize('num_targets', [1, 5, 129])
def test_rank_counts_tile_edges_match_jax(num_targets):
    """N = 129 (43 dyadic rows three times) and D = 33: one row past the
    CUDA kernel's 128-item tile and one dimension past its 32-dimension
    slab, on both sides of its 4 targets in registers and 128 a launch;
    ids outside [0, N) among the targets."""
    rs = np.random.RandomState(num_targets)
    users, items, bias = _dyadic_catalogue(rs, 6, 33, 43, 3)
    ids = rs.randint(-2, 131, (6, num_targets)).astype(np.int32)
    scores = _catalogue_scores(users, items, bias)
    ts = np.take_along_axis(scores, np.clip(ids, 0, 128), 1)
    greater, equal = _assert_counts_match(users, items, bias, ts, ids)
    inside = (ids >= 0) & (ids < 129)
    # Each target ties its two copies, and itself unless excluded by id.
    np.testing.assert_array_equal(equal >= np.where(inside, 2, 3), True)


def test_rank_counts_ids_outside_the_catalogue_match_jax():
    """Ids below 0 and at or past N are compared, never clamped: they
    exclude no row, in both packages (per-shard callers pass shifted ids
    on purpose)."""
    rs = np.random.RandomState(4)
    users, items, bias = _dyadic(rs, (8, 8)), _dyadic(rs, (300, 8)), \
        _dyadic(rs, 300, 64)
    scores = _catalogue_scores(users, items, bias)
    ids = np.array([[-1, -300, 300, 301, 2 ** 31 - 1, 5]] * 8, np.int32)
    ts = np.repeat(scores[:, 5:6], 6, axis=1)
    greater, equal = _assert_counts_match(users, items, bias, ts, ids)
    np.testing.assert_array_equal(equal[:, :5],
                                  np.repeat(equal[:, 5:] + 1, 5, axis=1))
    np.testing.assert_array_equal(greater[:, :5],
                                  np.repeat(greater[:, 5:], 5, axis=1))


def test_rank_counts_duplicated_row_ties_in_both():
    rs = np.random.RandomState(7)
    users, items, bias = _dyadic(rs, (8, 16)), _dyadic(rs, (700, 16)), \
        _dyadic(rs, 700, 64)
    items[9], bias[9] = items[3], bias[3]
    ids = rs.randint(0, 700, (8, 5)).astype(np.int32)
    ids[:, 0] = 3
    ts = ranking.matched_target_scores(
        torch.from_numpy(users), torch.from_numpy(items),
        torch.from_numpy(bias), torch.from_numpy(ids)).numpy()
    greater, equal = _assert_counts_match(users, items, bias, ts, ids)
    # Item 9 ties target 3 in every row (other dyadic scores may too).
    assert np.all(equal[:, 0] >= 1)


def test_rank_weights_identity_with_matched_scores():
    """With matched target scores, K1's weights are K5's counts plus the
    self tie: ``weights == greater + 0.5 * (equal + 1)`` exactly, as the
    JAX package pins for its two kernels."""
    rs = np.random.RandomState(7)
    users, items, bias = _gaussian(rs, 8, 16, 700)
    items[9], bias[9] = items[3], bias[3]
    ids = rs.randint(0, 700, (8, 5)).astype(np.int32)
    ids[:, 0] = 3
    args = (torch.from_numpy(users), torch.from_numpy(items),
            torch.from_numpy(bias))
    ts = ranking.matched_target_scores(*args, torch.from_numpy(ids))
    weights = ranking.rank_weights(*args, ts)
    greater, equal = ranking.rank_counts(*args, ts, torch.from_numpy(ids))
    assert torch.equal(weights, greater + 0.5 * (equal + 1.0))
    assert bool((equal[:, 0] == 1).all())


@pytest.mark.parametrize('mixtures', [2, 4])
def test_mixture_rank_counts_match_jax(mixtures):
    rs = np.random.RandomState(mixtures)
    dim, num_items, batch = 8, 600, 12
    users = (rs.randn(batch, 2 * mixtures * dim) / dim ** .5).astype(
        np.float32)
    items = rs.randn(num_items, dim).astype(np.float32)
    bias = (0.1 * rs.randn(num_items)).astype(np.float32)
    ids = rs.randint(-2, num_items + 2, (batch, 5)).astype(np.int32)
    safe = np.clip(ids, 0, num_items - 1)
    ts = ranking.matched_candidate_scores(
        torch.from_numpy(users), torch.from_numpy(items),
        torch.from_numpy(bias), torch.from_numpy(safe), mixtures).numpy()
    _assert_counts_match(users, items, bias, ts, ids, mixtures)


def test_rank_counts_rejects_bad_operands():
    users, items, bias = (torch.zeros(2, 4), torch.zeros(10, 4),
                          torch.zeros(10))
    with pytest.raises(ValueError, match='target_ids'):
        ranking.rank_counts(users, items, bias, torch.zeros(2, 3),
                            torch.zeros(2, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match='target_ids'):
        ranking.rank_counts(users, items, bias, torch.zeros(2, 3),
                            torch.zeros(2, 3))
    with pytest.raises(ValueError, match='target_scores'):
        ranking.rank_counts(users, items, bias, torch.zeros(3, 3),
                            torch.zeros(3, 3, dtype=torch.int64))


@pytest.mark.parametrize('seed', [0, 1])
def test_reciprocal_ranks_streaming_matches_jax(seed):
    rs = np.random.RandomState(seed)
    users, items, bias = _gaussian(rs, 10, 8, 500)
    targets = rs.randint(0, 500, (10, 4)).astype(np.int32)
    mask = rs.rand(10, 4) < 0.7
    mask[0] = False                                  # a row with no targets
    targets[~mask] = -1
    got = ranking.reciprocal_ranks_streaming(
        torch.from_numpy(users), torch.from_numpy(items),
        torch.from_numpy(bias), torch.from_numpy(targets).long(),
        torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_ranking.reciprocal_ranks_streaming(
        jnp.asarray(users), jnp.asarray(items), jnp.asarray(bias),
        jnp.asarray(targets), jnp.asarray(mask), tile_items=TILE,
        interpret=True))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_reciprocal_ranks_streaming_equals_the_rank_weight_path():
    """Bit for bit the per-row values of the metrics' K1 path on the same
    operands (the identity above, through the reciprocal mean)."""
    rs = np.random.RandomState(3)
    users, items, bias = (torch.from_numpy(part) for part in
                          _gaussian(rs, 16, 8, 400))
    targets = torch.from_numpy(rs.randint(0, 400, (16, 3)))
    mask = torch.from_numpy(rs.rand(16, 3) < 0.8)
    assert torch.equal(
        ranking.reciprocal_ranks_streaming(users, items, bias, targets, mask),
        evaluation._streaming_ranks(evaluation._device_scorer(400),
                                    (users, items, bias, None), targets,
                                    mask))
