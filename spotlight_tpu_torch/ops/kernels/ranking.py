"""Streaming rank weights over the catalogue, and matched target scores.

Counterpart of ``spotlight_tpu/ops/kernels/ranking.py`` (``rank_weights``
and ``matched_target_scores``).  On a CUDA tensor each function launches its
hand-written kernel (``csrc/ranking.cu``); on a CPU tensor it runs its plain
PyTorch version, which does the same arithmetic in the same order.  There is
no other path: a kernel that fails to build or launch raises.

The exact-tie contract (see ``csrc/common.cuh``): every score that is ever
compared is ``acc = 0; acc = acc + u[d] * i[d] for d in order; acc + bias``,
each product and sum rounded on its own.  :func:`plain_scores` and
:func:`matched_target_scores_plain` spell that order out as separate
elementwise ops (never ``matmul``, ``einsum`` or ``addcmul``, whose order
depends on the shape), so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.kernels import _build

#: Kernel launches made by :func:`rank_weights` and
#: :func:`matched_target_scores` (one per C call).
RANK_WEIGHTS_LAUNCHES = 0
MATCHED_SCORES_LAUNCHES = 0

# Users per K1 block and items per tile (csrc/ranking.cu).
_RANK_USERS = 64
_TILE_ITEMS = 64
_MAX_SHARED = 232448       # bytes of shared memory one H100 block may use
_BLOCKS_PER_SM = 4         # blocks in flight per SM the split count aims at


def on_cuda(*tensors):
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError('operands lie on several devices: {}'
                         .format(sorted(map(str, devices))))
    device = devices.pop()
    if device.type not in ('cuda', 'cpu'):
        raise ValueError('unsupported device {}'.format(device))
    return device.type == 'cuda'


def check_factors(user_reprs, item_matrix, item_bias):
    """Validate the (users, items, bias) operands every kernel takes."""
    if user_reprs.dim() != 2 or user_reprs.dtype != torch.float32:
        raise ValueError('user_reprs must be (B, D) float32')
    if item_matrix.dim() != 2 or item_matrix.dtype not in (torch.float32,
                                                           torch.bfloat16):
        raise ValueError('item_matrix must be (N, D) float32 or bfloat16')
    if item_matrix.shape[1] != user_reprs.shape[1]:
        raise ValueError('user and item widths differ ({} vs {})'.format(
            user_reprs.shape[1], item_matrix.shape[1]))
    if item_bias.shape != (item_matrix.shape[0],) or (
            item_bias.dtype != torch.float32):
        raise ValueError('item_bias must be (N,) float32')
    if item_matrix.shape[0] >= 2 ** 31:
        raise ValueError('catalogues beyond int32 ids are not supported')


def require_contiguous(*tensors):
    for tensor in tensors:
        if not tensor.is_contiguous():
            raise ValueError('the CUDA kernels take contiguous tensors')


def catalogue_splits(user_blocks, num_items, device, cap=None):
    """Catalogue splits per user block: enough blocks to give every SM
    ``_BLOCKS_PER_SM`` of them, no more splits than item tiles."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-num_items // _TILE_ITEMS)
    splits = max(1, min(tiles, -(-_BLOCKS_PER_SM * sms // user_blocks)))
    return min(splits, cap) if cap else splits


def stream_handle(device):
    return torch.cuda.current_stream(device).cuda_stream


def plain_scores(user_reprs, item_matrix, item_bias):
    """(N, B) item-major scores in the contract's order."""
    items = item_matrix.float()
    users_t = user_reprs.T
    acc = torch.zeros(items.shape[0], users_t.shape[1], dtype=torch.float32,
                      device=items.device)
    for d in range(items.shape[1]):
        acc = acc + items[:, d, None] * users_t[d]
    return acc + item_bias[:, None]


def rank_weights(user_reprs, item_matrix, item_bias, target_scores):
    """Combined streaming rank weights of target scores against the
    catalogue.

    ``weights[b, t] = count(score > ts) + 0.5 * count(score == ts)`` over
    ALL catalogue rows, the target itself included: the average-tie rank
    is ``weights + 0.5``.  ``target_scores`` must come from
    :func:`matched_target_scores`, so that the target's comparison with
    itself is an exact tie.

    Parameters
    ----------
    user_reprs : (B, D) float32
    item_matrix : (N, D) float32 or bfloat16
    item_bias : (N,) float32
    target_scores : (B, T) float32

    Returns
    -------
    (B, T) float32 weights.
    """
    check_factors(user_reprs, item_matrix, item_bias)
    if (target_scores.dim() != 2 or target_scores.dtype != torch.float32
            or target_scores.shape[0] != user_reprs.shape[0]):
        raise ValueError('target_scores must be (B, T) float32')
    if not on_cuda(user_reprs, item_matrix, item_bias, target_scores):
        return rank_weights_plain(user_reprs, item_matrix, item_bias,
                                   target_scores)
    return _rank_weights_cuda(user_reprs, item_matrix, item_bias,
                              target_scores)


def rank_weights_plain(user_reprs, item_matrix, item_bias, target_scores):
    """Plain PyTorch version of :func:`rank_weights`, on any device."""
    scores = plain_scores(user_reprs, item_matrix, item_bias)   # (N, B)
    batch, num_targets = target_scores.shape
    half_units = torch.zeros(batch, num_targets, dtype=torch.int64,
                             device=scores.device)
    for t in range(num_targets):
        ts = target_scores[:, t]
        half_units[:, t] = (2 * (scores > ts).sum(dim=0)
                            + (scores == ts).sum(dim=0))
    return half_units.float() * 0.5


def _rank_weights_cuda(user_reprs, item_matrix, item_bias, target_scores):
    global RANK_WEIGHTS_LAUNCHES
    require_contiguous(user_reprs, item_matrix, item_bias)
    lib = _build.load('ranking')
    batch, dim = user_reprs.shape
    num_items = item_matrix.shape[0]
    if lib.spotlight_rank_smem_bytes(dim) > _MAX_SHARED:
        raise ValueError('embedding width {} exceeds the rank kernel\'s '
                         'shared memory'.format(dim))
    device = user_reprs.device
    splits = catalogue_splits(-(-batch // _RANK_USERS), num_items, device)
    chunk = lib.spotlight_rank_max_targets()
    stream = stream_handle(device)
    parts = []
    for start in range(0, target_scores.shape[1], chunk):
        ts = target_scores[:, start:start + chunk].contiguous()
        half_units = torch.zeros(ts.shape, dtype=torch.int32, device=device)
        status = lib.spotlight_rank_weights(
            user_reprs.data_ptr(), item_matrix.data_ptr(),
            int(item_matrix.dtype == torch.bfloat16), item_bias.data_ptr(),
            ts.data_ptr(), half_units.data_ptr(), batch, num_items, dim,
            ts.shape[1], splits, stream)
        _build.check(status, 'rank_weights kernel')
        RANK_WEIGHTS_LAUNCHES += 1
        parts.append(half_units)
    half_units = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return half_units.float() * 0.5


def matched_target_scores(user_reprs, item_matrix, item_bias, ids):
    """Scores of item ``ids[b, t]`` for user ``b``, bit-identical to the
    scores :func:`rank_weights` compares (the exact-tie contract).

    Parameters
    ----------
    user_reprs : (B, D) float32
    item_matrix : (N, D) float32 or bfloat16
    item_bias : (N,) float32
    ids : (B, T) int; clipped into ``[0, N)``

    Returns
    -------
    (B, T) float32
    """
    check_factors(user_reprs, item_matrix, item_bias)
    if ids.dim() != 2 or ids.shape[0] != user_reprs.shape[0] or (
            ids.dtype.is_floating_point):
        raise ValueError('ids must be (B, T) integers')
    ids = ids.clamp(0, item_matrix.shape[0] - 1)
    if not on_cuda(user_reprs, item_matrix, item_bias, ids):
        return matched_target_scores_plain(user_reprs, item_matrix,
                                            item_bias, ids)
    return _matched_target_scores_cuda(user_reprs, item_matrix, item_bias,
                                       ids)


def matched_target_scores_plain(user_reprs, item_matrix, item_bias, ids):
    """Plain PyTorch version of :func:`matched_target_scores` (``ids``
    already inside ``[0, N)``), on any device."""
    rows = item_matrix[ids].float()                    # (B, T, D)
    acc = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    for d in range(rows.shape[2]):
        acc = acc + rows[:, :, d] * user_reprs[:, None, d]
    return acc + item_bias[ids]


def _matched_target_scores_cuda(user_reprs, item_matrix, item_bias, ids):
    global MATCHED_SCORES_LAUNCHES
    require_contiguous(user_reprs, item_matrix, item_bias)
    lib = _build.load('ranking')
    ids = ids.to(torch.int32).contiguous()
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    batch, num_targets = ids.shape
    if batch * num_targets == 0:
        return out
    status = lib.spotlight_matched_scores(
        user_reprs.data_ptr(), item_matrix.data_ptr(),
        int(item_matrix.dtype == torch.bfloat16), item_bias.data_ptr(),
        ids.data_ptr(), out.data_ptr(), batch, num_targets,
        user_reprs.shape[1], stream_handle(ids.device))
    _build.check(status, 'matched_target_scores kernel')
    MATCHED_SCORES_LAUNCHES += 1
    return out
