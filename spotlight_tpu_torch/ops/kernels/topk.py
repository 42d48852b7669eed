"""Exact streaming top-k over the catalogue.

Counterpart of ``spotlight_tpu/ops/kernels/topk.py`` (``streaming_topk``).
On a CUDA tensor one fetch launches the hand-written kernel
(``csrc/topk.cu``); on a CPU tensor it runs the plain PyTorch version,
which scores with the same arithmetic (``ranking.plain_scores``) and sorts.
Both return the top ``k`` in (score descending, id ascending) order, the
order of ``lax.top_k``.

Fetches wider than :data:`SINGLE_LAUNCH_K` run in rounds of that width:
each round streams the catalogue once and selects the next items strictly
after the previous round's last (score, id) key, as the JAX package does
(with its own 128-wide rounds; the ids do not depend on the width).
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.kernels import _build
from spotlight_tpu_torch.ops.kernels.ranking import (
    _MAX_SHARED, catalogue_splits, check_factors, on_cuda, plain_scores,
    require_contiguous, stream_handle)

#: Widest fetch one launch takes.  Stage 1 keeps, for each of its 32
#: users, a list and a candidate buffer of KP 8-byte keys each in shared
#: memory: 128 KB at KP = 256 beside the ~33 KB of tiles at D = 64, while
#: KP = 512 would need 256 KB, beyond the 227 KB a block may use.
SINGLE_LAUNCH_K = 256

#: Kernel launches made by :func:`streaming_topk` (one per C call).
STREAMING_TOPK_LAUNCHES = 0

_TOPK_USERS = 32           # users per stage-1 block (csrc/topk.cu)
_MIN_KP = 16
_STAGE2_KEYS = 8192        # stage 2 sorts at most this many keys per user


def streaming_topk(user_reprs, item_matrix, item_bias, k):
    """Exact top-k catalogue items per user without materialising scores.

    Parameters
    ----------
    user_reprs : (B, D) float32
    item_matrix : (N, D) float32 or bfloat16; item_bias : (N,) float32
    k : int, at most the catalogue size

    Returns
    -------
    (scores, ids) : (B, k) float32 and (B, k) int32, score descending, ties
        by ascending id.  A score of -0.0 is returned as +0.0.
    """
    check_factors(user_reprs, item_matrix, item_bias)
    num_items = item_matrix.shape[0]
    if k > num_items:
        raise ValueError('k ({}) exceeds the catalog size ({})'
                         .format(k, num_items))
    if k < 1:
        raise ValueError('k must be positive (got {})'.format(k))
    if k <= SINGLE_LAUNCH_K:
        return _topk_call(user_reprs, item_matrix, item_bias, k)

    resume_score = resume_id = None
    score_parts, id_parts = [], []
    remaining = k
    while remaining > 0:
        round_k = min(SINGLE_LAUNCH_K, remaining)
        scores, ids = _topk_call(user_reprs, item_matrix, item_bias, round_k,
                                 resume_score, resume_id)
        score_parts.append(scores)
        id_parts.append(ids)
        resume_score = scores[:, -1].contiguous()
        resume_id = ids[:, -1].contiguous()
        remaining -= round_k
    return torch.cat(score_parts, dim=1), torch.cat(id_parts, dim=1)


def _topk_call(user_reprs, item_matrix, item_bias, k, resume_score=None,
               resume_id=None):
    """One fetch of at most SINGLE_LAUNCH_K, optionally resuming strictly
    after a per-user (score, id) key."""
    if on_cuda(user_reprs, item_matrix, item_bias):
        return _topk_cuda(user_reprs, item_matrix, item_bias, k,
                          resume_score, resume_id)
    return streaming_topk_plain(user_reprs, item_matrix, item_bias, k,
                                resume_score, resume_id)


def streaming_topk_plain(user_reprs, item_matrix, item_bias, k,
                         resume_score=None, resume_id=None):
    """Plain PyTorch version of one fetch, on any device: any ``k`` up to
    the catalogue size in one sort, optionally after a (B,) resume key."""
    scores = plain_scores(user_reprs, item_matrix, item_bias).T   # (B, N)
    if resume_score is not None:
        ids = torch.arange(scores.shape[1], device=scores.device)
        rs, rid = resume_score[:, None], resume_id[:, None]
        taken = (scores > rs) | ((scores == rs) & (ids <= rid))
        scores = scores.masked_fill(taken, float('-inf'))
    # A stable descending sort keeps equal scores in ascending id order.
    top, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top = top[:, :k]
    top = torch.where(top == 0, torch.zeros_like(top), top)
    return top, order[:, :k].to(torch.int32)


def _topk_cuda(user_reprs, item_matrix, item_bias, k, resume_score=None,
               resume_id=None):
    global STREAMING_TOPK_LAUNCHES
    require_contiguous(user_reprs, item_matrix, item_bias)
    lib = _build.load('topk')
    batch, dim = user_reprs.shape
    num_items = item_matrix.shape[0]
    kp = max(_MIN_KP, 1 << (k - 1).bit_length())
    if lib.spotlight_topk_stage1_smem_bytes(kp, dim) > _MAX_SHARED:
        raise ValueError('top-{} at embedding width {} exceeds the top-k '
                         'kernel\'s shared memory'.format(k, dim))
    device = user_reprs.device
    splits = catalogue_splits(-(-batch // _TOPK_USERS), num_items, device,
                              cap=_STAGE2_KEYS // kp)
    partial = torch.empty(batch * splits * kp, dtype=torch.int64,
                          device=device)
    scores = torch.empty(batch, k, dtype=torch.float32, device=device)
    ids = torch.empty(batch, k, dtype=torch.int32, device=device)
    if resume_score is not None:
        resume_id = resume_id.to(torch.int32).contiguous()
        resume_score = resume_score.contiguous()
        if resume_score.shape != (batch,) or resume_id.shape != (batch,):
            raise ValueError('resume keys must be (B,)')
        resume_ptrs = (resume_score.data_ptr(), resume_id.data_ptr())
    else:
        resume_ptrs = (None, None)
    status = lib.spotlight_streaming_topk(
        user_reprs.data_ptr(), item_matrix.data_ptr(),
        int(item_matrix.dtype == torch.bfloat16), item_bias.data_ptr(),
        *resume_ptrs, batch, num_items, dim, k, kp, splits,
        partial.data_ptr(), scores.data_ptr(), ids.data_ptr(),
        stream_handle(device))
    _build.check(status, 'streaming_topk kernel')
    STREAMING_TOPK_LAUNCHES += 1
    return scores, ids
