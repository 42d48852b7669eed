"""Ranking evaluation metrics.

Counterpart of ``spotlight_tpu/evaluation.py`` for ``mrr_score`` and
``precision_recall_score``.  Users are processed in device batches:

- the streaming path (the default, on every device) never materialises the
  (batch, num_items) score matrix: MRR counts ranks with
  :func:`~spotlight_tpu_torch.ops.kernels.ranking.rank_weights` and
  precision@k takes an over-fetched top-k from
  :func:`~spotlight_tpu_torch.ops.kernels.topk.streaming_topk`.  On CUDA
  tensors they launch the hand-written kernels; on CPU tensors their plain
  PyTorch versions run;
- the materialize path (``streaming=False``) scores the batch against the
  catalogue with one matrix product, masks train items to -FLOAT_MAX and
  ranks by sorting, reproducing ``scipy.stats.rankdata``'s average ranks.

Unlike the JAX package, nothing here catches a kernel failure to recompute
on the materialize path: a failure raises.  Each metric reads its result
back to the host once, after the last batch.
"""

from __future__ import annotations

import numpy as np
import torch

from spotlight_tpu_torch.ops.kernels.ranking import (matched_target_scores,
                                                     rank_weights)
from spotlight_tpu_torch.ops.kernels.topk import streaming_topk

FLOAT_MAX = np.finfo(np.float32).max

#: Users per batch on the streaming path.  The JAX package derived its
#: width from the TPU's 16 MB of VMEM; here shared memory sets no cap: the
#: rank kernel keeps 64 users and the top-k kernel 32 users per block
#: resident, and a wider batch only adds blocks.  What the batch buys is
#: fewer catalogue passes: every batch streams the whole item table once
#: per kernel.  2048 users give the rank kernel 32 user blocks, which with
#: the catalogue splits fill the 132 SMs of an H100 four blocks deep, and
#: keep the top-k scratch (B x splits x KP 8-byte keys, at most 8192 keys a
#: user) at 128 MB.
STREAMING_BATCH = 2048
#: Users per batch on the materialize path, whose (B, N) score matrix and
#: its sort grow with the batch.
MATERIALIZE_BATCH = 256


def _padded_rows(csr_matrix, users, pad_value=-1):
    """Each user's column indices as a dense matrix padded with
    ``pad_value``, sized to the widest user."""
    users = np.asarray(users)
    indptr = csr_matrix.indptr
    starts = indptr[users]
    counts = indptr[users + 1] - starts
    width = max(int(counts.max()) if len(counts) else 0, 1)
    if csr_matrix.nnz == 0:
        return np.full((len(users), width), pad_value, dtype=np.int64)
    cols = np.arange(width)[None, :]
    valid = cols < counts[:, None]
    src = np.where(valid, starts[:, None] + cols, 0)
    return np.where(valid, csr_matrix.indices[src],
                    pad_value).astype(np.int64)


def _trim_batch_rows(rows, pad_value=-1):
    """Trim trailing all-pad columns to this batch's own widest row.

    ``_padded_rows`` sizes its output to the global widest user; without
    the trim every batch would pay the heaviest user's width in the rank
    kernel's target loop, the train correction and the top-k over-fetch.
    Valid entries are left-aligned, so trimming is a column slice.  (The
    JAX package rounds the width up to a power of two to bound its
    compiled shapes; eager PyTorch needs no such bucket, and the results
    do not depend on the width.)
    """
    if rows is None:
        return rows
    counts = (rows != pad_value).sum(axis=1)
    width = max(int(counts.max()) if len(counts) else 0, 1)
    return rows[:, :width]


def _batched(users_or_rows, batch_size):
    n = len(users_or_rows)
    for start in range(0, n, batch_size):
        yield users_or_rows[start:start + batch_size]


def _compact_train_mask(top_ids, train, k_max):
    """Drop train ids from an over-fetched top list, keeping rank order:
    the reference's demotion of train items to -FLOAT_MAX."""
    masked = (top_ids[:, :, None] == train[:, None, :]).any(dim=2)
    order = torch.argsort(masked.to(torch.int32), dim=1, stable=True)
    return torch.gather(top_ids, 1, order)[:, :k_max]


def _ranks_with_train_correction(weights, num_items, safe_targets,
                                 target_scores, valid_train, safe_train,
                                 train_scores):
    """Closed-form train-mask correction of streaming rank weights.

    A masked item contributes to no target's counts, so its comparison
    weight is subtracted; a target that is itself masked ranks behind every
    unmasked item, tied with the rest of the masked set:
    ``rank = (N - |M|) + (|M| + 1) / 2``.  Targets are compared with the
    train items in chunks, so the (B, T_chunk, Tr) broadcast stays bounded
    for heavy users.
    """
    chunk = 32
    tr_weight_parts, in_train_parts = [], []
    tr_scores = train_scores[:, None, :]
    for start in range(0, safe_targets.shape[1], chunk):
        tgt_ids = safe_targets[:, start:start + chunk, None]
        tgt = target_scores[:, start:start + chunk, None]
        same = safe_train[:, None, :] == tgt_ids
        countable = valid_train[:, None, :] & ~same
        tr_weight_parts.append(torch.where(
            countable & (tr_scores > tgt), 1.0,
            torch.where(countable & (tr_scores == tgt), 0.5, 0.0)).sum(dim=2))
        in_train_parts.append((valid_train[:, None, :] & same).any(dim=2))
    tr_weight = torch.cat(tr_weight_parts, dim=1)
    target_in_train = torch.cat(in_train_parts, dim=1)
    train_count = valid_train.sum(dim=1, keepdim=True)

    unmasked_ranks = weights - tr_weight + 0.5
    masked_ranks = (num_items - train_count) + (train_count + 1.0) * 0.5
    return torch.where(target_in_train, masked_ranks, unmasked_ranks)


def _mean_reciprocal(ranks, target_mask):
    rr = torch.where(target_mask, 1.0 / ranks, 0.0)
    denom = target_mask.sum(dim=1).clamp(min=1)
    return rr.sum(dim=1) / denom


def _streaming_ranks_device(reprs, item_matrix, item_bias, targets,
                            target_mask, train_rows):
    """Per-batch streaming MRR: matched target scores, the rank kernel,
    then the train correction, all on the batch's device."""
    num_items = item_matrix.shape[0]
    safe_targets = targets.clamp(0, num_items - 1)
    # The target scores bit-match the kernel's tile scores, so each
    # target's comparison with itself is an exact tie (weight 0.5).
    target_scores = matched_target_scores(reprs, item_matrix, item_bias,
                                          safe_targets)
    weights = rank_weights(reprs, item_matrix, item_bias, target_scores)

    if train_rows is not None:
        valid_train = train_rows >= 0
        safe_train = train_rows.clamp(0, num_items - 1)
        train_scores = matched_target_scores(reprs, item_matrix, item_bias,
                                             safe_train)
        ranks = _ranks_with_train_correction(
            weights, num_items, safe_targets, target_scores, valid_train,
            safe_train, train_scores)
    else:
        ranks = weights + 0.5
    return _mean_reciprocal(ranks, target_mask)


def _rank_factors(model, user_batch):
    factors_fn = getattr(model, '_rank_factors_users', None)
    return None if factors_fn is None else factors_fn(user_batch)


def _streaming_ranks(model, users, targets, target_mask, train_rows=None):
    """Per-user mean reciprocal ranks through the rank kernel, or None when
    the model exposes no dot-product factors."""
    factors = _rank_factors(model, users)
    if factors is None:
        return None
    reprs, item_matrix, item_bias = factors
    return _streaming_ranks_device(reprs, item_matrix, item_bias, targets,
                                   target_mask, train_rows)


def _mask_scores(scores, mask_indices):
    """Set ``scores[i, mask_indices[i, :]]`` to -FLOAT_MAX; -1 pads."""
    num_items = scores.shape[1]
    safe = torch.where(mask_indices < 0, num_items, mask_indices)
    padded = torch.cat([scores, torch.zeros_like(scores[:, :1])], dim=1)
    padded.scatter_(1, safe, float(-FLOAT_MAX))
    return padded[:, :num_items]


def _reciprocal_ranks(scores, targets, target_mask):
    """Mean reciprocal average-tie rank of the target items of each row."""
    num_items = scores.shape[1]
    sorted_scores = torch.sort(scores, dim=1).values
    target_scores = torch.gather(scores, 1, targets.clamp(0, num_items - 1))
    right = torch.searchsorted(sorted_scores, target_scores, right=True)
    left = torch.searchsorted(sorted_scores, target_scores)
    ranks = (num_items - right) + (right - left + 1) * 0.5
    return _mean_reciprocal(ranks, target_mask)


def _top_items(scores, k):
    """Top-k ids, ties by ascending id (a stable descending sort)."""
    return torch.sort(scores, dim=1, descending=True,
                      stable=True).indices[:, :k]


def _precision_recall_from_topk(top_ids, targets, target_mask, k_values):
    hits = ((top_ids[:, :, None] == targets[:, None, :])
            & target_mask[:, None, :]).any(dim=2).float()
    cum_hits = torch.cumsum(hits, dim=1)
    num_targets = target_mask.sum(dim=1).clamp(min=1)
    precision = torch.stack([cum_hits[:, k - 1] / k for k in k_values],
                            dim=1)
    recall = torch.stack([cum_hits[:, k - 1] / num_targets
                          for k in k_values], dim=1)
    return precision, recall


def _precision_recall_from_scores(scores, targets, target_mask, k_values):
    top_items = _top_items(scores, max(k_values))
    return _precision_recall_from_topk(top_items, targets, target_mask,
                                       k_values)


def _streaming_topk_device(reprs, item_matrix, item_bias, train_rows, k_max,
                           fetch):
    """Per-batch top-k through the top-k kernel, then train compaction."""
    _, top_ids = streaming_topk(reprs, item_matrix, item_bias, fetch)
    if train_rows is None:
        return top_ids
    return _compact_train_mask(top_ids, train_rows, k_max)


def _streaming_topk_hits(model, users, k_max, train_rows=None):
    """(B, k_max) top unmasked item ids, or None when the model exposes no
    dot-product factors.

    Train masking over-fetches: the kernel returns the top
    ``k_max + train width`` (a user has at most ``train width`` of their
    train items in any window), masked ids are compacted out and the first
    ``k_max`` survivors kept.
    """
    factors = _rank_factors(model, users)
    if factors is None:
        return None
    reprs, item_matrix, item_bias = factors
    num_items = item_matrix.shape[0]
    fetch = k_max if train_rows is None else k_max + train_rows.shape[1]
    # A fetch of the whole catalogue already holds every unmasked item.
    fetch = min(fetch, num_items)
    return _streaming_topk_device(reprs, item_matrix, item_bias, train_rows,
                                  k_max, fetch)


def _score_user_batch(model, user_batch, device):
    """(B, num_items) scores through the model's catalogue scorer, else
    through per-user ``predict``."""
    fn = getattr(model, '_score_catalog', None)
    if fn is not None:
        return fn(user_batch)
    return torch.as_tensor(
        np.stack([model.predict(int(u)) for u in user_batch]),
        dtype=torch.float32, device=device)


def _resolve_batch_size(batch_size, streaming, model):
    if batch_size is not None:
        return batch_size
    if streaming and getattr(model, '_rank_factors_users', None) is not None:
        return STREAMING_BATCH
    return MATERIALIZE_BATCH


def _model_device(model):
    return getattr(model, '_device', torch.device('cpu'))


def _eval_rows(test, train):
    """Users with test items, their padded test rows and train rows."""
    test_csr = test.tocsr()
    users = np.where(np.diff(test_csr.indptr) > 0)[0]
    targets = _padded_rows(test_csr, users)
    train_rows = (_padded_rows(train.tocsr(), users)
                  if train is not None else None)
    return users, targets, train_rows


def _batches(users, targets, train_rows, batch_size, device):
    """(user ids, targets, train rows) per batch; rows trimmed to the
    batch's own width and placed on ``device``."""
    train_batches = (_batched(train_rows, batch_size)
                     if train_rows is not None
                     else (None for _ in range(0, len(users), batch_size)))
    for u, t, tr in zip(_batched(users, batch_size),
                        _batched(targets, batch_size), train_batches):
        t = torch.as_tensor(_trim_batch_rows(t), device=device)
        if tr is not None:
            tr = torch.as_tensor(_trim_batch_rows(tr), device=device)
        yield u, t, tr


@torch.no_grad()
def mrr_score(model, test, train=None, batch_size=None, streaming=True):
    """Mean reciprocal rank: one score per user with test interactions,
    the mean reciprocal (average-tie) rank of that user's test items.

    Parameters
    ----------
    model : fitted recommender
    test : :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    train : Interactions, optional
        If supplied, train items are ranked below every other item and so
        do not affect the MRR.
    batch_size : int, optional
        Users per batch (default :data:`STREAMING_BATCH` when streaming,
        else :data:`MATERIALIZE_BATCH`).
    streaming : bool, optional
        Rank with the streaming kernels (default) or, if False, by sorting
        a materialised score matrix.

    Returns
    -------
    np.ndarray of shape (num_users_with_test_items,)
    """
    users, targets, train_rows = _eval_rows(test, train)
    batch_size = _resolve_batch_size(batch_size, streaming, model)
    device = _model_device(model)

    mrrs = []
    for u, t, tr in _batches(users, targets, train_rows, batch_size,
                             device):
        if streaming:
            rr = _streaming_ranks(model, u, t, t >= 0, train_rows=tr)
            if rr is not None:
                mrrs.append(rr)
                continue
            streaming = False  # the model exposes no factors
        scores = _score_user_batch(model, u, device)
        if tr is not None:
            scores = _mask_scores(scores, tr)
        mrrs.append(_reciprocal_ranks(scores, t, t >= 0))

    return torch.cat(mrrs).cpu().numpy() if mrrs else np.array([])


@torch.no_grad()
def precision_recall_score(model, test, train=None, k=10, batch_size=None,
                           streaming=True):
    """Precision@k and recall@k for every user with test interactions.

    Parameters
    ----------
    model : fitted recommender
    test : :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    train : Interactions, optional
        If supplied, train items are excluded from each user's top k.
    k : int or array of int
    batch_size : int, optional
        Users per batch (default :data:`STREAMING_BATCH` when streaming,
        else :data:`MATERIALIZE_BATCH`).
    streaming : bool, optional
        Take the top k with the streaming top-k kernel (default) or, if
        False, by sorting a materialised score matrix.

    Returns
    -------
    (precision, recall) : np.ndarrays of shape (num_users,) for scalar k,
        (num_users, len(k)) for array k.
    """
    scalar_k = np.isscalar(k)
    k_values = tuple(np.atleast_1d(k).astype(int).tolist())
    if max(k_values) > test.num_items:
        raise ValueError('k ({}) exceeds the catalog size ({})'
                         .format(max(k_values), test.num_items))

    users, targets, train_rows = _eval_rows(test, train)
    batch_size = _resolve_batch_size(batch_size, streaming, model)
    device = _model_device(model)

    precisions, recalls = [], []
    for u, t, tr in _batches(users, targets, train_rows, batch_size,
                             device):
        if streaming:
            top_ids = _streaming_topk_hits(model, u, max(k_values),
                                           train_rows=tr)
            if top_ids is not None:
                p, r = _precision_recall_from_topk(top_ids, t, t >= 0,
                                                   k_values)
                precisions.append(p)
                recalls.append(r)
                continue
            streaming = False  # the model exposes no factors
        scores = _score_user_batch(model, u, device)
        if tr is not None:
            scores = _mask_scores(scores, tr)
        p, r = _precision_recall_from_scores(scores, t, t >= 0, k_values)
        precisions.append(p)
        recalls.append(r)

    if precisions:
        precision, recall = torch.stack(
            [torch.cat(precisions), torch.cat(recalls)]).cpu().numpy()
    else:
        precision = recall = np.empty((0, len(k_values)))
    if scalar_k:
        return precision[:, 0], recall[:, 0]
    return precision, recall
