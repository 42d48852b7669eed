"""Full-catalogue evaluation over a row-sharded catalogue.

Counterpart of ``spotlight_tpu/parallel/evaluation.py``.  Each rank of the
``model`` axis scores the user batch against its own ``(N / S, D)`` block of
the catalogue, through the same kernels as one device (the block is a
contiguous slice, so every score keeps its bits: row sharding splits N,
never the D contraction), and only small results cross between ranks:

- :func:`sharded_topk`: each rank's top k (the top-k kernel K2), gathered
  over the model axis and merged on (score descending, id ascending), the
  tie order of ``lax.top_k`` on the whole catalogue;
- :func:`sharded_rank_counts`: each rank's greater and equal counts (K5),
  with the target ids shifted into the block's coordinates so that the
  self-exclusion fires on the owning rank only, summed over the model axis;
- :func:`sharded_rank_weights`: each rank's rank weights (K1), summed;
- :func:`sharded_candidate_scores`: each id scored on its owning rank by
  the matched-pair kernel (K1c, K4 for mixtures), the others -0.0 (the
  identity of the sum, so the score keeps its bits), summed.

The functions are SPMD: every rank calls them with the same arguments (the
whole ``(N, D)`` catalogue, N a multiple of the model axis' size) and gets
the same, replicated, result.  Their ``*_of_block`` forms take the rank's
own block instead, as a model trained on the mesh holds it, so that no
rank builds the whole catalogue.  Where the data axis divides the user batch,
each data rank takes its slice of the users and the results are gathered
over the data axis, as the JAX package shards the batch over ``'data'``.

Counts and weights travel as float32: they are integers and halves below
2^24, exact for catalogues of up to 16.7 million rows.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.kernels import ranking
from spotlight_tpu_torch.ops.kernels.ranking import (
    matched_candidate_scores, matched_target_scores, rank_counts,
    rank_weights)
from spotlight_tpu_torch.ops.kernels.topk import streaming_topk

#: The id of a padded entry of a rank's candidate list (beyond any row).
PAD_ID = 2 ** 30


def batch_scores(users, items, bias, mixture=None):
    """(B, N) scores of a user operand against item rows, dot (``mixture``
    None) or mixture-of-tastes scoring, in the kernels' order
    (``ranking.plain_scores``)."""
    return ranking.plain_scores(users, items, bias, mixture).T


def _block(mesh, axis, item_matrix, item_bias):
    """(local rows, this rank's rows of the catalogue, of its bias, the id
    of its first row): views, no copy.  The block the ``*_of_block``
    functions take."""
    shards = mesh.shape[axis]
    if item_matrix.shape[0] % shards:
        raise ValueError('the catalogue ({} rows) must divide over the {} '
                         '{} shards; pad it first'.format(
                             item_matrix.shape[0], shards, axis))
    local_rows = item_matrix.shape[0] // shards
    start = mesh.index(axis) * local_rows
    return (local_rows, item_matrix[start:start + local_rows],
            item_bias[start:start + local_rows], start)


def _data_slice(mesh, batch, data_axis):
    """The rows of a user batch this rank scores: its data slice when the
    data axis divides the batch, else the whole batch (None)."""
    size = mesh.shape.get(data_axis, 1)
    if size > 1 and batch % size == 0:
        rows = batch // size
        start = mesh.index(data_axis) * rows
        return slice(start, start + rows)
    return None


def _gathered(mesh, data_axis, rows, tensor):
    """The whole batch's result from each data rank's slice of it."""
    return tensor if rows is None else mesh.all_gather(tensor, data_axis)


def _local(tensor, rows):
    return tensor if rows is None else tensor[rows]


def sharded_topk(mesh, user_reprs, item_matrix, item_bias, k, axis='model',
                 data_axis='data', mixture=None, streaming=True):
    """Top-k items per user over a row-sharded catalogue.

    Parameters
    ----------
    mesh : :class:`~spotlight_tpu_torch.parallel.mesh.Mesh`
    user_reprs : (B, D) float32, or (B, 2 * M * D) for mixtures
    item_matrix : (N, D), N a multiple of the ``axis`` size
    item_bias : (N,)
    k : int
    mixture : int, optional
        M for mixture-of-tastes scoring; None scores dot products.
    streaming : bool
        Each rank's top k by the top-k kernel (the default), or by sorting
        its block's scores (``batch_scores``).

    Returns
    -------
    (scores, ids) : (B, k) float32 and (B, k) int32, the best k over the
        whole catalogue, score descending, ties by ascending id.
    """
    return topk_of_block(mesh, user_reprs,
                         _block(mesh, axis, item_matrix, item_bias), k,
                         axis, data_axis, mixture, streaming)


def topk_of_block(mesh, user_reprs, block, k, axis='model', data_axis='data',
                  mixture=None, streaming=True):
    """:func:`sharded_topk` on this rank's ``block`` of the padded
    catalogue, ``(local rows, items, bias, first id)``."""
    local_rows, items, bias, first = block
    rows = _data_slice(mesh, user_reprs.shape[0], data_axis)
    users = _local(user_reprs, rows)
    # A rank can hold fewer than k rows; its list is padded so that every
    # rank gives the merge exactly k entries.
    local_k = min(k, local_rows)
    if streaming:
        scores, ids = streaming_topk(users, items, bias, local_k, mixture)
    else:
        top = torch.sort(batch_scores(users, items, bias, mixture), dim=1,
                         descending=True, stable=True)
        scores = top.values[:, :local_k]
        ids = top.indices[:, :local_k].to(torch.int32)
    ids = ids + first
    if local_k < k:
        pad = (users.shape[0], k - local_k)
        scores = torch.cat([scores, scores.new_full(pad, float('-inf'))],
                           dim=1)
        ids = torch.cat([ids, ids.new_full(pad, PAD_ID)], dim=1)

    # (S, B_d, k) candidates, merged per user over S * k entries.
    cand_scores = mesh.all_gather(scores[None], axis)
    cand_ids = mesh.all_gather(ids[None], axis)
    cand_scores = cand_scores.permute(1, 0, 2).reshape(users.shape[0], -1)
    cand_ids = cand_ids.permute(1, 0, 2).reshape(users.shape[0], -1)
    # Sort by (-score, id), lax.top_k's tie order: by id first, then a
    # stable sort by score (-0.0 and +0.0 tie, as in the kernel).
    by_id = torch.argsort(cand_ids, dim=1, stable=True)
    cand_scores = torch.gather(cand_scores, 1, by_id)
    cand_ids = torch.gather(cand_ids, 1, by_id)
    order = torch.sort(cand_scores, dim=1, descending=True,
                       stable=True).indices[:, :k]
    scores = torch.gather(cand_scores, 1, order)
    ids = torch.gather(cand_ids, 1, order)
    return (_gathered(mesh, data_axis, rows, scores),
            _gathered(mesh, data_axis, rows, ids))


def sharded_rank_counts(mesh, user_reprs, item_matrix, item_bias,
                        target_scores, target_ids, axis='model',
                        mixture=None, streaming=True):
    """Comparison counts (greater, equal) of target scores against a
    row-sharded catalogue, the target item itself left out.

    Each rank counts over its block, the target ids shifted into the
    block's coordinates, so that a target is left out on its owning rank
    and nowhere else; a sum over the model axis merges.  Combine as
    ``rank = greater + equal / 2 + 1``.  ``streaming=True`` (the default)
    counts with the rank-count kernel K5, False by comparing the block's
    scores (``batch_scores``) in chunks of 16 targets.

    Returns
    -------
    (greater, equal) : (B, T) float32, replicated.
    """
    local_rows, items, bias, first = _block(mesh, axis, item_matrix,
                                            item_bias)
    local_ids = target_ids - first
    if streaming:
        greater, equal = rank_counts(user_reprs, items, bias, target_scores,
                                     local_ids, mixture)
    else:
        scores = batch_scores(user_reprs, items, bias, mixture)   # (B, N/S)
        cols = torch.arange(local_rows, device=scores.device)
        greater_parts, equal_parts = [], []
        # Chunks of targets bound the (B, T, N/S) comparison.
        for start in range(0, target_scores.shape[1], 16):
            ts = target_scores[:, start:start + 16, None]
            other = cols[None, None, :] != local_ids[:, start:start + 16,
                                                     None]
            greater_parts.append((other & (scores[:, None, :] > ts))
                                 .sum(dim=2).float())
            equal_parts.append((other & (scores[:, None, :] == ts))
                               .sum(dim=2).float())
        greater = torch.cat(greater_parts, dim=1)
        equal = torch.cat(equal_parts, dim=1)
    return mesh.all_reduce(greater, axis), mesh.all_reduce(equal, axis)


def sharded_rank_weights(mesh, user_reprs, item_matrix, item_bias,
                         target_scores, axis='model', data_axis='data',
                         mixture=None):
    """Self-inclusive rank weights over a row-sharded catalogue.

    The mesh form of ``ranking.rank_weights`` (K1): each rank's weights
    over its block, then one sum over the model axis.  ``target_scores``
    must be matched (:func:`sharded_candidate_scores`): the owning rank's
    catalogue score of a target ties it exactly, giving the target's 0.5
    self-weight.

    Returns
    -------
    (B, T) float32 weights, replicated; ``rank = weights + 0.5``.
    """
    return rank_weights_of_block(
        mesh, user_reprs, _block(mesh, axis, item_matrix, item_bias),
        target_scores, axis, data_axis, mixture)


def rank_weights_of_block(mesh, user_reprs, block, target_scores,
                          axis='model', data_axis='data', mixture=None):
    """:func:`sharded_rank_weights` on this rank's ``block`` of the padded
    catalogue, ``(local rows, items, bias, first id)``."""
    _, items, bias, _ = block
    rows = _data_slice(mesh, user_reprs.shape[0], data_axis)
    local = rank_weights(_local(user_reprs, rows), items, bias,
                         _local(target_scores, rows), mixture)
    return _gathered(mesh, data_axis, rows, mesh.all_reduce(local, axis))


def sharded_candidate_scores(mesh, user_reprs, item_matrix, item_bias,
                             candidates, axis='model', data_axis='data',
                             mixture=None):
    """(B, T) scores of item ids against a row-sharded catalogue, each
    computed on its owning rank by the matched-pair kernel (K1c, or K4 for
    mixtures), so that it has the bits of the catalogue pass's score of the
    same pair.  The other ranks give 0 and a sum over the model axis
    merges.

    Parameters
    ----------
    candidates : (B, T) int, global item ids inside ``[0, N)``.

    Returns
    -------
    (B, T) float32, replicated.
    """
    return candidate_scores_of_block(
        mesh, user_reprs, _block(mesh, axis, item_matrix, item_bias),
        candidates, axis, data_axis, mixture)


def candidate_scores_of_block(mesh, user_reprs, block, candidates,
                              axis='model', data_axis='data', mixture=None):
    """:func:`sharded_candidate_scores` on this rank's ``block`` of the
    padded catalogue, ``(local rows, items, bias, first id)``."""
    local_rows, items, bias, first = block
    rows = _data_slice(mesh, user_reprs.shape[0], data_axis)
    users = _local(user_reprs, rows)
    local = _local(candidates, rows) - first
    owned = (local >= 0) & (local < local_rows)
    safe = torch.where(owned, local, 0)
    if mixture is None:
        scores = matched_target_scores(users, items, bias, safe)
    else:
        scores = matched_candidate_scores(users, items, bias, safe, mixture)
    # -0.0 is the sum's identity for every float, so the owner's score
    # keeps its bits (the sign of a zero included) through the sum.
    scores = torch.where(owned, scores, -0.0)
    return _gathered(mesh, data_axis, rows, mesh.all_reduce(scores, axis))
