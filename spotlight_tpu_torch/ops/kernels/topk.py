"""Exact streaming top-k over the catalogue.

Counterpart of ``spotlight_tpu/ops/kernels/topk.py`` (``streaming_topk``,
with dot or mixture-of-tastes scoring).  On a CUDA tensor one fetch
launches the hand-written kernel (``csrc/topk.cu``); on a CPU tensor it runs
the plain PyTorch version, which scores with the same arithmetic
(``ranking.plain_scores``) and sorts.  Both return the top ``k`` in (score
descending, id ascending) order, the order of ``lax.top_k``, and the raw
scores: -0.0 and +0.0 tie in the order but keep their signs.

Fetches wider than :data:`SINGLE_LAUNCH_K` run in rounds of that width:
each round streams the catalogue once and selects the next items strictly
after the previous round's last (score, id) key, as the JAX package does
(with its own 128-wide rounds; the ids do not depend on the width).
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.kernels import _build
from spotlight_tpu_torch.ops.kernels.ranking import (
    _MAX_SHARED, MAX_MIXTURES, check_factors, on_cuda, plain_scores,
    require_contiguous, stream_handle)

#: Widest fetch one launch takes.  Stage 1 keeps, for each of its U users, a
#: list and a candidate buffer of 256 8-byte keys at KP <= 64 (KP: the fetch
#: rounded up to a power of two, at least 16) and 512 above, in shared
#: memory beside 33 KB of item slabs and the users' columns, 4 bytes each a
#: dimension.  With dot scoring U is 64 at KP <= 64 and 32 above (128 KB of
#: keys), which takes embedding widths up to 261 and 525; with mixtures U
#: is 16 users of 2 MP columns (M rounded up to MP = 2, 4 or 8), 32 KB of
#: keys at KP <= 64 and 64 KB above, which takes widths up to 647, 323
#: and 161 at KP <= 64 and 519, 259 and 129 above.  KP = 512 would need
#: 256 KB of dot keys, beyond the 227 KB a block may use.
SINGLE_LAUNCH_K = 256

#: Kernel launches made by :func:`streaming_topk` (one per C call), dot
#: and mixture scoring counted apart.
STREAMING_TOPK_LAUNCHES = 0
MIXTURE_STREAMING_TOPK_LAUNCHES = 0

_MIN_KP = 16
_STAGE2_KEYS = 8192        # stage 2 sorts at most this many keys per user


def streaming_topk(user_reprs, item_matrix, item_bias, k, num_mixtures=None):
    """Exact top-k catalogue items per user without materialising scores.

    On a card each fetch is two launches (``csrc/topk.cu``).  Stage 1 runs
    one block an SM, each over a contiguous split of the catalogue for 64
    dot users (32 at fetches past 64) or 16 mixture users held in shared
    memory; it scores 128-item tiles in registers as the rank pass does
    (``dot_tile_accumulate``, then the bias, or ``mixture_combine`` over a
    user's 2M dots), so every score has the bits of
    :func:`~.ranking.rank_weights`' and of the matched scores', and keeps
    the keys that beat each user's running k-th key in a list and buffer
    of 64-bit keys.  Stage 2 sorts each user's split lists into its top k.

    Parameters
    ----------
    user_reprs : (B, D) float32, or (B, 2 * M * D) for mixtures
    item_matrix : (N, D) float32 or bfloat16; item_bias : (N,) float32
    k : int, at most the catalogue size
    num_mixtures : int, optional
        M for mixture-of-tastes scoring; None scores dot products.

    Returns
    -------
    (scores, ids) : (B, k) float32 and (B, k) int32, score descending, ties
        by ascending id.
    """
    check_factors(user_reprs, item_matrix, item_bias, num_mixtures)
    num_items = item_matrix.shape[0]
    if k > num_items:
        raise ValueError('k ({}) exceeds the catalog size ({})'
                         .format(k, num_items))
    if k < 1:
        raise ValueError('k must be positive (got {})'.format(k))
    if k <= SINGLE_LAUNCH_K:
        return _topk_call(user_reprs, item_matrix, item_bias, k,
                          num_mixtures)

    resume_score = resume_id = None
    score_parts, id_parts = [], []
    remaining = k
    while remaining > 0:
        round_k = min(SINGLE_LAUNCH_K, remaining)
        scores, ids = _topk_call(user_reprs, item_matrix, item_bias, round_k,
                                 num_mixtures, resume_score, resume_id)
        score_parts.append(scores)
        id_parts.append(ids)
        resume_score = scores[:, -1].contiguous()
        resume_id = ids[:, -1].contiguous()
        remaining -= round_k
    return torch.cat(score_parts, dim=1), torch.cat(id_parts, dim=1)


def streams(k, dim, num_mixtures, device):
    """Whether :func:`streaming_topk` takes a top-``k`` fetch over items of
    width ``dim``, scored as dots (``num_mixtures`` None) or as mixtures of
    M tastes, on ``device``.

    Mixtures of more than :data:`~.ranking.MAX_MIXTURES` tastes never
    stream.  On the CPU the plain version takes every other operand.  On a
    card the built library says whether the stage-1 block of the fetch's
    widest launch fits in shared memory.
    """
    if num_mixtures is not None and num_mixtures > MAX_MIXTURES:
        return False
    if torch.device(device).type != 'cuda':
        return True
    return _fits(_build.load('topk'), _kp(min(k, SINGLE_LAUNCH_K)), dim,
                 num_mixtures or 0)


def _kp(k):
    """The list width of a fetch of ``k``: a power of two, at least 16."""
    return max(_MIN_KP, 1 << (k - 1).bit_length())


def _fits(lib, kp, dim, mixtures):
    return (lib.spotlight_topk_stage1_smem_bytes(kp, dim, mixtures)
            <= _MAX_SHARED)


def _topk_call(user_reprs, item_matrix, item_bias, k, num_mixtures=None,
               resume_score=None, resume_id=None):
    """One fetch of at most SINGLE_LAUNCH_K, optionally resuming strictly
    after a per-user (score, id) key."""
    if on_cuda(user_reprs, item_matrix, item_bias):
        return _topk_cuda(user_reprs, item_matrix, item_bias, k,
                          num_mixtures, resume_score, resume_id)
    return streaming_topk_plain(user_reprs, item_matrix, item_bias, k,
                                num_mixtures, resume_score, resume_id)


def streaming_topk_plain(user_reprs, item_matrix, item_bias, k,
                         num_mixtures=None, resume_score=None,
                         resume_id=None):
    """Plain PyTorch version of one fetch, on any device: any ``k`` up to
    the catalogue size in one sort, optionally after a (B,) resume key."""
    scores = plain_scores(user_reprs, item_matrix, item_bias,
                          num_mixtures).T                       # (B, N)
    if resume_score is not None:
        ids = torch.arange(scores.shape[1], device=scores.device)
        rs, rid = resume_score[:, None], resume_id[:, None]
        taken = (scores > rs) | ((scores == rs) & (ids <= rid))
        scores = scores.masked_fill(taken, float('-inf'))
    # A stable descending sort keeps equal scores (-0.0 and +0.0 among
    # them) in ascending id order.
    top, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k], order[:, :k].to(torch.int32)


def _topk_cuda(user_reprs, item_matrix, item_bias, k, num_mixtures=None,
               resume_score=None, resume_id=None):
    global STREAMING_TOPK_LAUNCHES, MIXTURE_STREAMING_TOPK_LAUNCHES
    require_contiguous(user_reprs, item_matrix, item_bias)
    lib = _build.load('topk')
    batch = user_reprs.shape[0]
    num_items, dim = item_matrix.shape
    mixtures = num_mixtures or 0
    kp = _kp(k)
    if not _fits(lib, kp, dim, mixtures):
        raise ValueError('top-{} at embedding width {}{} exceeds the top-k '
                         'kernel\'s shared memory'.format(
                             k, dim, ' with {} mixtures'.format(mixtures)
                             if mixtures else ''))
    device = user_reprs.device
    user_blocks = -(-batch // lib.spotlight_topk_block_users(kp, mixtures))
    splits = _splits(user_blocks, device, kp)
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
        *resume_ptrs, batch, num_items, dim, mixtures, k, kp, splits,
        partial.data_ptr(), scores.data_ptr(), ids.data_ptr(),
        stream_handle(device))
    _build.check(status, 'streaming_topk kernel')
    if mixtures:
        MIXTURE_STREAMING_TOPK_LAUNCHES += 1
    else:
        STREAMING_TOPK_LAUNCHES += 1
    return scores, ids


def _splits(user_blocks, device, kp):
    """Catalogue splits per user block.  Stage 1 runs one block an SM and
    its blocks cost the same, so it takes as many splits as fill one wave
    (rounded down: a second, partial wave would double the time; the kernel
    drops splits beyond the catalogue's tiles).  Stage 2 sorts at most
    ``_STAGE2_KEYS`` keys a user."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms // user_blocks, _STAGE2_KEYS // kp))
