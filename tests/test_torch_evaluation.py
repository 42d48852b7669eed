"""The port's evaluation path against the JAX package's.

On a JAX model converted into the port (``params_from_jax``), the port's
``mrr_score`` and ``precision_recall_score`` must agree with the JAX
functions, with and without a train mask, at scalar and vector ``k``, on
the streaming path (the port's plain kernel versions on the CPU against the
JAX Pallas kernels in interpret mode) and on the materialize path.

MRR agrees to rtol 1e-6: ranks are half-integer counts, equal in both
packages, and the reciprocal means are float32 sums taken alike.
Precision and recall are ratios of hit counts and must be exactly equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu import evaluation as jax_eval
from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions
from spotlight_tpu_torch.ops.kernels import ranking

from tests.test_torch_factorization import fitted_pair, to_port

MRR_RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def _setup(fused=True):
    jax_model, port, train, test = fitted_pair(fused)
    return jax_model, port, train, test, to_port(train), to_port(test)


def _heavy(train, user, extra, seed=0):
    """``train`` plus ``extra`` more items for ``user`` (a heavy row that
    widens the top-k over-fetch)."""
    items = np.random.RandomState(seed).choice(train.num_items, extra,
                                               replace=False)
    return (np.concatenate([np.full(extra, user), train.user_ids]),
            np.concatenate([items, train.item_ids]))


@pytest.mark.parametrize('streaming', [True, False])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('fused', [True, False])
def test_mrr_matches_jax(streaming, masked, fused):
    jax_model, port, train, test, ptrain, ptest = _setup(fused)
    got = evaluation.mrr_score(port, ptest, train=ptrain if masked else None,
                               streaming=streaming)
    want = jax_eval.mrr_score(jax_model, test,
                              train=train if masked else None,
                              streaming=streaming)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)


@pytest.mark.parametrize('streaming', [True, False])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('k', [5, (1, 5, 10)])
def test_precision_recall_matches_jax(streaming, masked, k):
    jax_model, port, train, test, ptrain, ptest = _setup()
    k_arg = list(k) if isinstance(k, tuple) else k
    got = evaluation.precision_recall_score(
        port, ptest, train=ptrain if masked else None, k=k_arg,
        streaming=streaming)
    want = jax_eval.precision_recall_score(
        jax_model, test, train=train if masked else None, k=k_arg,
        streaming=streaming)
    for got_part, want_part in zip(got, want):
        assert got_part.shape == want_part.shape
        np.testing.assert_array_equal(got_part, want_part)


@pytest.mark.parametrize('streaming', [True, False])
def test_heavy_train_user_over_fetch_matches_jax(streaming):
    """A 60-item train row forces a fetch of k + 60 and, in small batches,
    widens only its own batch."""
    jax_model, port, train, test, _, ptest = _setup()
    users, items = _heavy(train, int(test.user_ids[0]), 60)
    heavy = Interactions(users, items, num_users=train.num_users,
                         num_items=train.num_items)
    from spotlight_tpu.data.interactions import Interactions as JaxInter
    jax_heavy = JaxInter(users, items, num_users=train.num_users,
                         num_items=train.num_items)
    got = evaluation.precision_recall_score(port, ptest, train=heavy, k=10,
                                            batch_size=16,
                                            streaming=streaming)
    want = jax_eval.precision_recall_score(jax_model, test, train=jax_heavy,
                                           k=10, batch_size=16,
                                           streaming=streaming)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    got = evaluation.mrr_score(port, ptest, train=heavy, batch_size=16,
                               streaming=streaming)
    want = jax_eval.mrr_score(jax_model, test, train=jax_heavy,
                              batch_size=16, streaming=streaming)
    np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)


@pytest.mark.parametrize('batch_size', [7, 50])
def test_streaming_equals_materialize_in_ragged_batches(batch_size):
    _, port, _, _, ptrain, ptest = _setup()
    for kwargs in ({}, {'train': ptrain}):
        np.testing.assert_allclose(
            evaluation.mrr_score(port, ptest, batch_size=batch_size,
                                 **kwargs),
            evaluation.mrr_score(port, ptest, streaming=False, **kwargs),
            rtol=MRR_RTOL, atol=0)
        for got, want in zip(
                evaluation.precision_recall_score(
                    port, ptest, k=[3, 8], batch_size=batch_size, **kwargs),
                evaluation.precision_recall_score(
                    port, ptest, k=[3, 8], streaming=False, **kwargs)):
            np.testing.assert_array_equal(got, want)


class _PredictOnly:
    """A model that only predicts: the metrics score it user by user."""

    def __init__(self, scores):
        self._scores = scores

    def predict(self, user_ids, item_ids=None):
        return self._scores[user_ids]


def test_predict_only_model_matches_jax():
    _, _, train, test, ptrain, ptest = _setup()
    rs = np.random.RandomState(3)
    # Scores on a coarse grid, so the catalogue holds many exact ties.
    scores = rs.randint(0, 6, (train.num_users, train.num_items)).astype(
        np.float32)
    model = _PredictOnly(scores)
    np.testing.assert_allclose(
        evaluation.mrr_score(model, ptest, train=ptrain),
        jax_eval.mrr_score(model, test, train=train), rtol=MRR_RTOL, atol=0)
    for got, want in zip(
            evaluation.precision_recall_score(model, ptest, train=ptrain,
                                              k=[1, 4]),
            jax_eval.precision_recall_score(model, test, train=train,
                                            k=[1, 4])):
        np.testing.assert_array_equal(got, want)


def test_k_beyond_catalogue_raises():
    _, port, _, _, _, ptest = _setup()
    with pytest.raises(ValueError, match='exceeds the catalog size'):
        evaluation.precision_recall_score(port, ptest, k=ptest.num_items + 1)


def test_kernel_failure_is_not_rerouted(monkeypatch):
    """The port has no fallback: a failing kernel fails the metric."""
    _, port, _, _, _, ptest = _setup()

    def broken(*args):
        raise RuntimeError('kernel launch failed')

    monkeypatch.setattr(evaluation, 'rank_weights', broken)
    monkeypatch.setattr(evaluation, 'streaming_topk', broken)
    with pytest.raises(RuntimeError, match='kernel launch failed'):
        evaluation.mrr_score(port, ptest)
    with pytest.raises(RuntimeError, match='kernel launch failed'):
        evaluation.precision_recall_score(port, ptest)
    assert not hasattr(evaluation, 'FALLBACK_COUNTS')


def test_padded_and_trimmed_rows_match_jax():
    _, _, train, _, ptrain, _ = _setup()
    users = np.array([0, 3, 5, 9, 40])
    got = evaluation._padded_rows(ptrain.tocsr(), users)
    want = jax_eval._padded_rows(train.tocsr(), users)
    np.testing.assert_array_equal(got, want)
    rows = np.full((3, 40), -1)
    rows[0, :11] = 1
    rows[2, :3] = 2
    assert evaluation._trim_batch_rows(rows).shape == (3, 11)
    np.testing.assert_array_equal(evaluation._trim_batch_rows(rows),
                                  jax_eval._trim_batch_rows(rows)[:, :11])
    assert evaluation._trim_batch_rows(None) is None
    assert [len(b) for b in evaluation._batched(np.arange(10), 4)] == [4, 4,
                                                                      2]


def test_train_correction_matches_jax():
    rs = np.random.RandomState(8)
    batch, num_items = 6, 40
    weights = rs.randint(1, 80, (batch, 3)).astype(np.float32) * 0.5
    targets = rs.randint(0, num_items, (batch, 3))
    target_scores = rs.randint(0, 4, (batch, 3)).astype(np.float32)
    train_rows = rs.randint(-1, num_items, (batch, 5))
    train_rows[:, 0] = targets[:, 0]          # some targets are masked
    train_scores = rs.randint(0, 4, (batch, 5)).astype(np.float32)
    args = (weights, num_items, targets, target_scores, train_rows >= 0,
            np.clip(train_rows, 0, num_items - 1), train_scores)
    got = evaluation._ranks_with_train_correction(
        *[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
          for a in args])
    want = jax_eval._ranks_with_train_correction(
        *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_score_helpers_match_jax():
    rs = np.random.RandomState(2)
    scores = rs.randint(0, 5, (4, 30)).astype(np.float32)
    mask = np.array([[1, 2, -1], [0, -1, -1], [29, 5, 6], [-1, -1, -1]])
    targets = np.array([[3, 1], [4, -1], [7, 8], [0, 2]])
    masked = evaluation._mask_scores(torch.from_numpy(scores),
                                     torch.from_numpy(mask))
    jax_masked = jax_eval._mask_scores(jnp.asarray(scores),
                                       jnp.asarray(mask))
    np.testing.assert_array_equal(masked.numpy(), np.asarray(jax_masked))
    np.testing.assert_array_equal(
        evaluation._reciprocal_ranks(masked, torch.from_numpy(targets),
                                     torch.from_numpy(targets >= 0)).numpy(),
        np.asarray(jax_eval._reciprocal_ranks(
            jax_masked, jnp.asarray(targets), jnp.asarray(targets >= 0))))
    for got, want in zip(
            evaluation._precision_recall_from_scores(
                masked, torch.from_numpy(targets),
                torch.from_numpy(targets >= 0), (1, 3, 10)),
            jax_eval._precision_recall_from_scores(
                jax_masked, jnp.asarray(targets), jnp.asarray(targets >= 0),
                (1, 3, 10))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compact_train_mask_matches_jax():
    top = np.array([[5, 3, 9, 1, 0], [2, 4, 6, 8, 7]])
    train = np.array([[3, 1, -1], [8, -1, -1]])
    got = evaluation._compact_train_mask(torch.from_numpy(top),
                                         torch.from_numpy(train), 3)
    want = jax_eval._compact_train_mask(jnp.asarray(top), jnp.asarray(train),
                                        3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_streaming_mrr_uses_the_bit_matched_target_scores(monkeypatch):
    """The streaming ranks take their target scores from
    matched_target_scores, whose values tie the catalogue pass exactly."""
    _, port, _, _, _, ptest = _setup()
    calls = []
    original = ranking.matched_target_scores

    def spy(*args):
        calls.append(args[3].shape)
        return original(*args)

    monkeypatch.setattr(evaluation, 'matched_target_scores', spy)
    evaluation.mrr_score(port, ptest)
    assert calls and all(len(shape) == 2 for shape in calls)


def test_empty_test_set_shapes():
    """No test interactions: empty results, one column per k."""
    _, port, _, _, _, ptest = _setup()
    empty = Interactions(np.array([], np.int64), np.array([], np.int64),
                         num_users=ptest.num_users, num_items=ptest.num_items)
    assert evaluation.mrr_score(port, empty).shape == (0,)
    precision, recall = evaluation.precision_recall_score(port, empty,
                                                          k=[1, 2, 3])
    assert precision.shape == recall.shape == (0, 3)
    assert evaluation.precision_recall_score(port, empty, k=2)[0].shape == (
        0,)
