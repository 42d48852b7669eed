"""Streaming rank weights and rank counts over the catalogue, matched target
scores and matched candidate scores.

Counterpart of ``spotlight_tpu/ops/kernels/ranking.py`` (``rank_weights``
and ``rank_counts`` with dot or mixture-of-tastes scoring,
``reciprocal_ranks_streaming``, ``matched_target_scores``,
``matched_candidate_scores`` and the mixture score function
``make_mixture_score_fn`` / ``mixture_combine``).  On a CUDA tensor each
function launches its hand-written kernel (``csrc/ranking.cu``); on a CPU
tensor it runs its plain PyTorch version, which does the same arithmetic in
the same order.  There is no other path: a kernel that fails to build or
launch raises.

The exact-tie contract (see ``csrc/common.cuh``): every score that is ever
compared is a dot product ``acc = u[0] * i[0]; acc = acc + u[d] * i[d] for
d in order`` plus the bias, or the mixture of such dots that
:func:`plain_mixture_scores` spells out, each operation rounded on its own.
The plain versions run that order as separate elementwise ops (never
``matmul``, ``einsum``, ``addcmul`` or ``softmax``, whose order depends on
the shape), so kernel and plain version agree bit for bit.

Mixture scoring (``num_mixtures=M``) takes users as ``(B, 2 * M * D)``:
each user's M taste vectors, then its M attention vectors, as
``MixtureLSTMNet`` stacks them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spotlight_tpu_torch.ops.kernels import _build

#: Kernel launches made by :func:`rank_weights` and :func:`rank_counts`
#: (dot and mixture scoring counted apart), :func:`matched_target_scores`
#: and :func:`matched_candidate_scores` (one per C call; the two are one
#: kernel, counted apart by scoring).
RANK_WEIGHTS_LAUNCHES = 0
MIXTURE_RANK_WEIGHTS_LAUNCHES = 0
RANK_COUNTS_LAUNCHES = 0
MIXTURE_RANK_COUNTS_LAUNCHES = 0
MATCHED_SCORES_LAUNCHES = 0
CANDIDATE_SCORES_LAUNCHES = 0
#: Rows handed to the rank kernel by :func:`rank_weights`' launches (dot
#: and mixture scoring), summed over a call's launches: ``B * ceil(T /
#: chunk)`` a call of every row on every target chunk, fewer where
#: :func:`rank_launches` skips pads.
RANK_WEIGHTS_ROW_PASSES = 0

#: Most mixture components the kernels take (``kMaxMixtures``, common.cuh).
MAX_MIXTURES = 8

_MAX_SHARED = 232448       # bytes of shared memory one H100 block may use


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


def user_width(dim, num_mixtures):
    """Width of a user's row: ``D`` for dot scoring, ``2 * M * D`` for a
    mixture of M tastes."""
    return dim if num_mixtures is None else 2 * num_mixtures * dim


def check_factors(user_reprs, item_matrix, item_bias, num_mixtures=None):
    """Validate the (users, items, bias) operands every kernel takes."""
    if user_reprs.dim() != 2 or user_reprs.dtype != torch.float32:
        raise ValueError('user_reprs must be (B, K) float32')
    if item_matrix.dim() != 2 or item_matrix.dtype not in (torch.float32,
                                                           torch.bfloat16):
        raise ValueError('item_matrix must be (N, D) float32 or bfloat16')
    if num_mixtures is not None and not 1 <= num_mixtures <= MAX_MIXTURES:
        raise ValueError('num_mixtures must lie in [1, {}] (got {})'.format(
            MAX_MIXTURES, num_mixtures))
    width = user_width(item_matrix.shape[1], num_mixtures)
    if user_reprs.shape[1] != width:
        raise ValueError('user rows are {} wide, the items need {}'.format(
            user_reprs.shape[1], width))
    if item_bias.shape != (item_matrix.shape[0],) or (
            item_bias.dtype != torch.float32):
        raise ValueError('item_bias must be (N,) float32')
    if item_matrix.shape[0] >= 2 ** 31:
        raise ValueError('catalogues beyond int32 ids are not supported')


def require_contiguous(*tensors):
    for tensor in tensors:
        if not tensor.is_contiguous():
            raise ValueError('the CUDA kernels take contiguous tensors')


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _rank_splits(lib, batch, device, mixtures):
    """Catalogue splits per user block of a rank launch.  The rank kernel
    runs one block an SM and its blocks cost the same, so it takes as many
    splits as fill one wave (rounded down: a second, partial wave would
    double the time; the kernel drops splits beyond the catalogue's tiles
    and adds some where a split would hold more than its counts take)."""
    user_blocks = -(-batch // lib.spotlight_rank_block_users(mixtures))
    return max(1, _sm_count(device) // user_blocks)


def streams(dim, num_mixtures, device):
    """Whether :func:`rank_weights` and :func:`rank_counts` take items of
    width ``dim``, scored as dots (``num_mixtures`` None) or as mixtures of
    M tastes, on ``device``.

    Mixtures of more than :data:`MAX_MIXTURES` tastes never stream.  On the
    CPU the plain versions take every other operand.  On a card the built
    library says whether the rank kernel's narrowest launch fits in shared
    memory (wider target blocks are chunked).
    """
    if num_mixtures is not None and num_mixtures > MAX_MIXTURES:
        return False
    if torch.device(device).type != 'cuda':
        return True
    return _fits(_build.load('ranking'), dim, num_mixtures or 0)


def _fits(lib, dim, mixtures):
    return lib.spotlight_rank_smem_bytes(dim, mixtures) <= _MAX_SHARED


def _check_width(lib, dim, mixtures):
    """The rank kernel holds its users and two item slabs in shared memory:
    dot scoring takes D <= 768 (with fewer targets a launch past D = 383),
    mixtures of M <= 2, 4 or 8 tastes D <= 774, 387 or 193 (with fewer
    targets a launch past D = 719, 359 or 179)."""
    if not _fits(lib, dim, mixtures):
        raise ValueError('embedding width {} exceeds the rank kernel\'s '
                         'shared memory'.format(dim))


def stream_handle(device):
    return torch.cuda.current_stream(device).cuda_stream


def _plain_dot(item_at, user_at, dim):
    """The exact-tie contract's dot (common.cuh): the first product, then
    one product added at a time, in order."""
    acc = item_at(0) * user_at(0)
    for d in range(1, dim):
        acc = acc + item_at(d) * user_at(d)
    return acc


def _expf(x):
    """``expf`` as the kernels take it.  On the card ``torch.exp`` is the
    same libdevice ``expf``.  On the CPU, ``torch.exp`` of float32 gives a
    value that depends on where the element sits in its tensor (SIMD body
    or scalar tail), which would break the exact-tie contract between a
    catalogue pass and the matched scores; exp in float64, rounded to
    float32, gives every element the same value wherever it sits."""
    if x.is_cuda:
        return torch.exp(x)
    return torch.exp(x.double()).float()


def _plain_mixture(dot, num_mixtures, bias):
    """``mixture_combine`` of common.cuh over whole tensors: ``dot(k)``
    returns the dot products of user component k (tastes first, then
    attentions), in the shape of the result."""
    weights = [dot(num_mixtures + m) for m in range(num_mixtures)]
    amax = weights[0]
    for attention in weights[1:]:
        amax = torch.maximum(amax, attention)
    weights = [_expf(attention - amax) for attention in weights]
    denom = weights[0]
    for weight in weights[1:]:
        denom = denom + weight
    out = weights[0] * dot(0)
    for m in range(1, num_mixtures):
        out = out + weights[m] * dot(m)
    return out / denom + bias


def plain_scores(user_reprs, item_matrix, item_bias, num_mixtures=None):
    """(N, B) item-major scores in the contract's order."""
    if num_mixtures is not None:
        return plain_mixture_scores(user_reprs, item_matrix, item_bias,
                                    num_mixtures)
    items = item_matrix.float()
    users_t = user_reprs.T
    dot = _plain_dot(lambda d: items[:, d, None], lambda d: users_t[d],
                     items.shape[1])
    return dot + item_bias[:, None]


def plain_mixture_scores(user_reprs, item_matrix, item_bias, num_mixtures):
    """(N, B) item-major mixture-of-tastes scores (K3), in the contract's
    order.  ``user_reprs`` is (B, 2 * M * D): tastes, then attentions."""
    items = item_matrix.float()
    dim = items.shape[1]
    users_t = user_reprs.T

    def dot(k):
        return _plain_dot(lambda d: items[:, d, None],
                          lambda d: users_t[k * dim + d], dim)

    return _plain_mixture(dot, num_mixtures, item_bias[:, None])


def rank_weights(user_reprs, item_matrix, item_bias, target_scores,
                 num_mixtures=None, widths=None):
    """Combined streaming rank weights of target scores against the
    catalogue.

    ``weights[b, t] = count(score > ts) + 0.5 * count(score == ts)`` over
    ALL catalogue rows, the target itself included: the average-tie rank
    is ``weights + 0.5``.  ``target_scores`` must come from
    :func:`matched_target_scores` (dot scoring) or
    :func:`matched_candidate_scores` (mixtures), so that the target's
    comparison with itself is an exact tie.  A NaN target counts nothing
    (weight 0).

    Given ``widths``, row ``b``'s real targets are its first ``widths[b]``
    columns and the rest are NaN (the streaming MRR's pads, whose widths
    the host knows): on the card the kernel then runs only on the (rows,
    target chunk) pairs that hold a real target (:func:`rank_launches`).
    ``widths`` None runs every row on every chunk.  The weights are the
    same either way.

    Parameters
    ----------
    user_reprs : (B, D) float32, or (B, 2 * M * D) for mixtures
    item_matrix : (N, D) float32 or bfloat16
    item_bias : (N,) float32
    target_scores : (B, T) float32
    num_mixtures : int, optional
        M for mixture-of-tastes scoring; None scores dot products.
    widths : (B,) host ints in ``[0, T]``, optional

    Returns
    -------
    (B, T) float32 weights.
    """
    check_factors(user_reprs, item_matrix, item_bias, num_mixtures)
    if (target_scores.dim() != 2 or target_scores.dtype != torch.float32
            or target_scores.shape[0] != user_reprs.shape[0]):
        raise ValueError('target_scores must be (B, T) float32')
    if widths is not None:
        widths = np.asarray(widths, dtype=np.int64)
        if widths.shape != target_scores.shape[:1] or (
                len(widths) and not 0 <= widths.min() <= widths.max()
                <= target_scores.shape[1]):
            raise ValueError('widths must be (B,) ints in [0, T]')
    if not on_cuda(user_reprs, item_matrix, item_bias, target_scores):
        return rank_weights_plain(user_reprs, item_matrix, item_bias,
                                  target_scores, num_mixtures)
    return _rank_weights_cuda(user_reprs, item_matrix, item_bias,
                              target_scores, num_mixtures, widths)


def rank_weights_plain(user_reprs, item_matrix, item_bias, target_scores,
                       num_mixtures=None):
    """Plain PyTorch version of :func:`rank_weights`, on any device."""
    scores = plain_scores(user_reprs, item_matrix, item_bias,
                          num_mixtures)                         # (N, B)
    batch, num_targets = target_scores.shape
    half_units = torch.zeros(batch, num_targets, dtype=torch.int64,
                             device=scores.device)
    for t in range(num_targets):
        ts = target_scores[:, t]
        half_units[:, t] = (2 * (scores > ts).sum(dim=0)
                            + (scores == ts).sum(dim=0))
    return half_units.float() * 0.5


def range_widths(chunk, mixtures):
    """Widest in-chunk target count of each width range of
    :func:`rank_launches`, narrowest first: the rank kernel's
    instantiations (``dispatch_rank`` in csrc/ranking.cu: the targets a
    narrow launch holds in registers, 4, or 1 with mixtures of more than 4
    tastes; then 8 to 64 sorted targets with dot scoring), up to the
    chunk.  The narrow ones (1, 2 and 4 targets) share a range: they cost
    about the same a row, and a range more costs a launch more."""
    narrow = 1 if mixtures > 4 else 4
    widths = (narrow,) + (() if mixtures else (8, 16, 32, 64))
    return tuple(w for w in widths if w < chunk) + (chunk,)


def _chunk_loop(batch, num_targets, chunk):
    return [(0, batch, start, min(chunk, num_targets - start))
            for start in range(0, num_targets, chunk)]


def rank_launches(widths, num_targets, chunk, ranges, block_users):
    """The rank kernel's launches for rows of ragged target widths.

    Each launch is ``(first_row, end_row, first_col, num_cols)`` over the
    rows sorted by width, descending: rows ``[first_row, end_row)`` against
    target columns ``[first_col, first_col + num_cols)``.  Chunk ``c``
    (``chunk`` columns from ``c * chunk``) takes only the rows that hold a
    target there, the prefix of rows wider than ``c * chunk``, split at
    the ``ranges`` (:func:`range_widths`) of their widths within the chunk,
    each split rounded up to whole blocks of ``block_users`` (a launch's
    last block is paid for whole, so narrower rows fill it).  A launch
    takes as many columns as its widest row has in the chunk: the kernel
    runs the narrowest instantiation that holds them.  Where every row is
    ``num_targets`` wide, or ``num_targets`` fits the narrowest range,
    this is one launch of every row a chunk.

    Parameters
    ----------
    widths : (B,) ints, descending: each row's last real target column + 1
    num_targets : int, T
    chunk : int, the widest target block of one launch
    ranges : tuple of ints, :func:`range_widths`
    block_users : int, users a block of the rank kernel
    """
    batch = len(widths)
    if num_targets <= ranges[0] or (batch and widths[-1] >= num_targets):
        return _chunk_loop(batch, num_targets, chunk)
    descending = -np.asarray(widths, dtype=np.int64)

    def rows_past(width):
        return int(np.searchsorted(descending, -width, side='left'))

    launches = []
    for start in range(0, num_targets, chunk):
        rows = rows_past(start)
        first = 0
        for width in ranges[-2::-1] + (0,):
            end = min(rows, -(-rows_past(start + width) // block_users)
                      * block_users)
            if end > first:
                launches.append((first, end, start,
                                 min(int(widths[first]) - start, chunk)))
                first = end
    return launches


def _launch_plan(widths, batch, num_targets, chunk, ranges, block_users):
    """``(order, launches)`` of :func:`rank_launches` for a call's host
    ``widths`` (None: every row on every chunk), ``order`` the rows sorted
    by width, descending, or None where the launches are one of every row a
    chunk, which run on the rows as they are."""
    loop = _chunk_loop(batch, num_targets, chunk)
    if widths is None:
        return None, loop
    order = np.argsort(-widths, kind='stable')
    launches = rank_launches(widths[order], num_targets, chunk, ranges,
                             block_users)
    return (None, loop) if launches == loop else (order, launches)


def _upload(array, device):
    """A host array on ``device``, copied from pinned memory without
    waiting for the work queued on the card."""
    tensor = torch.from_numpy(array)
    if device.type != 'cuda':
        return tensor.to(device)
    return tensor.pin_memory().to(device, non_blocking=True)


def _rank_weights_cuda(user_reprs, item_matrix, item_bias, target_scores,
                       num_mixtures=None, widths=None):
    global RANK_WEIGHTS_LAUNCHES, MIXTURE_RANK_WEIGHTS_LAUNCHES
    global RANK_WEIGHTS_ROW_PASSES
    require_contiguous(user_reprs, item_matrix, item_bias)
    lib = _build.load('ranking')
    batch, num_targets = target_scores.shape
    num_items, dim = item_matrix.shape
    mixtures = num_mixtures or 0
    _check_width(lib, dim, mixtures)
    device = user_reprs.device
    chunk = lib.spotlight_rank_max_targets(dim, mixtures)
    order, launches = _launch_plan(
        widths, batch, num_targets, chunk, range_widths(chunk, mixtures),
        lib.spotlight_rank_block_users(mixtures))
    if order is not None:
        order = _upload(order, device)
        user_reprs = user_reprs.index_select(0, order)
        target_scores = target_scores.index_select(0, order)
    half_units = torch.zeros(batch, num_targets, dtype=torch.int32,
                             device=device)
    stream = stream_handle(device)
    for first, end, start, cols in launches:
        whole = start == 0 and cols == num_targets
        ts = target_scores[first:end, start:start + cols].contiguous()
        out = (half_units[first:end] if whole
               else torch.zeros(ts.shape, dtype=torch.int32, device=device))
        status = lib.spotlight_rank_weights(
            user_reprs[first:end].data_ptr(), item_matrix.data_ptr(),
            int(item_matrix.dtype == torch.bfloat16), item_bias.data_ptr(),
            ts.data_ptr(), out.data_ptr(), end - first, num_items, dim, cols,
            mixtures, _rank_splits(lib, end - first, device, mixtures),
            stream)
        _build.check(status, 'rank_weights kernel')
        if mixtures:
            MIXTURE_RANK_WEIGHTS_LAUNCHES += 1
        else:
            RANK_WEIGHTS_LAUNCHES += 1
        RANK_WEIGHTS_ROW_PASSES += end - first
        if not whole:
            half_units[first:end, start:start + cols] = out
    if order is not None:
        half_units = torch.empty_like(half_units).index_copy_(0, order,
                                                              half_units)
    return half_units.float() * 0.5


def rank_counts(user_reprs, item_matrix, item_bias, target_scores,
                target_ids, num_mixtures=None):
    """Streaming comparison counts of target scores against the catalogue
    (K5).

    ``greater[b, t]`` and ``equal[b, t]`` count the catalogue rows whose
    score is above, and equal to, ``target_scores[b, t]``, leaving out the
    row whose id is ``target_ids[b, t]``: the target is excluded by id, so
    its score may come from any arithmetic.  The average-tie rank is
    ``greater + equal / 2 + 1``.  Target ids outside ``[0, N)`` match no
    row (they are compared, never gathered), as per-shard callers need.

    Parameters
    ----------
    user_reprs : (B, D) float32, or (B, 2 * M * D) for mixtures
    item_matrix : (N, D) float32 or bfloat16
    item_bias : (N,) float32
    target_scores : (B, T) float32
    target_ids : (B, T) int
    num_mixtures : int, optional
        M for mixture-of-tastes scoring; None scores dot products.

    Returns
    -------
    (greater, equal) : (B, T) float32 counts.
    """
    check_factors(user_reprs, item_matrix, item_bias, num_mixtures)
    batch = user_reprs.shape[0]
    if (target_scores.dim() != 2 or target_scores.dtype != torch.float32
            or target_scores.shape[0] != batch):
        raise ValueError('target_scores must be (B, T) float32')
    if (target_ids.shape != target_scores.shape
            or target_ids.dtype.is_floating_point):
        raise ValueError('target_ids must be (B, T) integers, the shape of '
                         'target_scores')
    if not on_cuda(user_reprs, item_matrix, item_bias, target_scores,
                   target_ids):
        return rank_counts_plain(user_reprs, item_matrix, item_bias,
                                 target_scores, target_ids, num_mixtures)
    return _rank_counts_cuda(user_reprs, item_matrix, item_bias,
                             target_scores, target_ids, num_mixtures)


def rank_counts_plain(user_reprs, item_matrix, item_bias, target_scores,
                      target_ids, num_mixtures=None):
    """Plain PyTorch version of :func:`rank_counts`, on any device."""
    scores = plain_scores(user_reprs, item_matrix, item_bias,
                          num_mixtures)                         # (N, B)
    rows = torch.arange(scores.shape[0], device=scores.device)[:, None]
    greater = torch.zeros(target_scores.shape, dtype=torch.int64,
                          device=scores.device)
    equal = torch.zeros_like(greater)
    for t in range(target_scores.shape[1]):
        ts = target_scores[:, t]
        other = rows != target_ids[:, t]
        greater[:, t] = ((scores > ts) & other).sum(dim=0)
        equal[:, t] = ((scores == ts) & other).sum(dim=0)
    return greater.float(), equal.float()


def _rank_counts_cuda(user_reprs, item_matrix, item_bias, target_scores,
                      target_ids, num_mixtures=None):
    global RANK_COUNTS_LAUNCHES, MIXTURE_RANK_COUNTS_LAUNCHES
    require_contiguous(user_reprs, item_matrix, item_bias)
    lib = _build.load('ranking')
    batch = user_reprs.shape[0]
    num_items, dim = item_matrix.shape
    mixtures = num_mixtures or 0
    _check_width(lib, dim, mixtures)
    # Ids outside [0, N) match no row: -1 says so in int32 without
    # clamping, which would exclude a real row.
    target_ids = torch.where((target_ids >= 0) & (target_ids < num_items),
                             target_ids, -1).to(torch.int32)
    device = user_reprs.device
    splits = _rank_splits(lib, batch, device, mixtures)
    chunk = lib.spotlight_rank_max_targets(dim, mixtures)
    stream = stream_handle(device)
    greater_parts, equal_parts = [], []
    for start in range(0, target_scores.shape[1], chunk):
        ts = target_scores[:, start:start + chunk].contiguous()
        tids = target_ids[:, start:start + chunk].contiguous()
        greater = torch.zeros(ts.shape, dtype=torch.int32, device=device)
        equal = torch.zeros_like(greater)
        status = lib.spotlight_rank_counts(
            user_reprs.data_ptr(), item_matrix.data_ptr(),
            int(item_matrix.dtype == torch.bfloat16), item_bias.data_ptr(),
            ts.data_ptr(), tids.data_ptr(), greater.data_ptr(),
            equal.data_ptr(), batch, num_items, dim, ts.shape[1], mixtures,
            splits, stream)
        _build.check(status, 'rank_counts kernel')
        if mixtures:
            MIXTURE_RANK_COUNTS_LAUNCHES += 1
        else:
            RANK_COUNTS_LAUNCHES += 1
        greater_parts.append(greater)
        equal_parts.append(equal)
    return (torch.cat(greater_parts, dim=1).float(),
            torch.cat(equal_parts, dim=1).float())


def reciprocal_ranks_streaming(user_reprs, item_matrix, item_bias, targets,
                               target_mask):
    """Mean reciprocal (average-tie) rank per user through the rank-count
    kernel: the targets' scores by :func:`matched_target_scores`, then
    :func:`rank_counts` with the targets excluded by id.

    Parameters
    ----------
    user_reprs : (B, D) float32
    item_matrix : (N, D) float32 or bfloat16
    item_bias : (N,) float32
    targets : (B, T) int item ids (pads are clipped into ``[0, N)``)
    target_mask : (B, T) bool

    Returns
    -------
    (B,) float32 mean reciprocal rank over each row's valid targets.
    """
    safe_targets = targets.clamp(0, item_matrix.shape[0] - 1)
    target_scores = matched_target_scores(user_reprs, item_matrix,
                                          item_bias, safe_targets)
    greater, equal = rank_counts(user_reprs, item_matrix, item_bias,
                                 target_scores, safe_targets)
    # The target is left out of the counts: with its own tie, the average
    # rank is greater + ((equal + 1) + 1) / 2.
    ranks = greater + equal * 0.5 + 1.0
    rr = torch.where(target_mask, 1.0 / ranks, 0.0)
    denom = target_mask.sum(dim=1).clamp(min=1)
    return rr.sum(dim=1) / denom


def _check_ids(ids, user_reprs):
    """Validate (B, T) integer ids."""
    if ids.dim() != 2 or ids.shape[0] != user_reprs.shape[0] or (
            ids.dtype.is_floating_point):
        raise ValueError('ids must be (B, T) integers')


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
    _check_ids(ids, user_reprs)
    if not on_cuda(user_reprs, item_matrix, item_bias, ids):
        return matched_target_scores_plain(
            user_reprs, item_matrix, item_bias,
            ids.clamp(0, item_matrix.shape[0] - 1))
    return _matched_scores_cuda(user_reprs, item_matrix, item_bias, ids, 0)


def matched_target_scores_plain(user_reprs, item_matrix, item_bias, ids):
    """Plain PyTorch version of :func:`matched_target_scores` (``ids``
    already inside ``[0, N)``), on any device."""
    rows = item_matrix[ids].float()                    # (B, T, D)
    dot = _plain_dot(lambda d: rows[:, :, d], lambda d: user_reprs[:, None, d],
                     rows.shape[2])
    return dot + item_bias[ids]


def matched_candidate_scores(user_reprs, item_matrix, item_bias, ids,
                             num_mixtures):
    """Mixture-of-tastes scores of item ``ids[b, t]`` for user ``b`` (K4),
    bit-identical to the scores :func:`rank_weights` and
    :func:`~spotlight_tpu_torch.ops.kernels.topk.streaming_topk` compare
    with the same ``num_mixtures`` (the exact-tie contract).

    Parameters
    ----------
    user_reprs : (B, 2 * M * D) float32, tastes then attentions
    item_matrix : (N, D) float32 or bfloat16
    item_bias : (N,) float32
    ids : (B, T) int; clipped into ``[0, N)``
    num_mixtures : int, M

    Returns
    -------
    (B, T) float32
    """
    check_factors(user_reprs, item_matrix, item_bias, num_mixtures)
    _check_ids(ids, user_reprs)
    if not on_cuda(user_reprs, item_matrix, item_bias, ids):
        return matched_candidate_scores_plain(
            user_reprs, item_matrix, item_bias,
            ids.clamp(0, item_matrix.shape[0] - 1), num_mixtures)
    return _matched_scores_cuda(user_reprs, item_matrix, item_bias, ids,
                                num_mixtures)


def matched_candidate_scores_plain(user_reprs, item_matrix, item_bias, ids,
                                   num_mixtures):
    """Plain PyTorch version of :func:`matched_candidate_scores` (``ids``
    already inside ``[0, N)``), on any device."""
    rows = item_matrix[ids].float()                    # (B, T, D)
    dim = rows.shape[2]

    def dot(k):
        return _plain_dot(lambda d: rows[:, :, d],
                          lambda d: user_reprs[:, None, k * dim + d], dim)

    return _plain_mixture(dot, num_mixtures, item_bias[ids])


def matched_launch_shape(batch, num_targets, pair_slots, sms):
    """(users, targets) a block of a matched-pair launch takes, at most
    ``pair_slots`` pairs.  A user's targets are split into the fewest
    chunks that fit, of equal width; then each block takes as many users as
    spread the batch over about one wave of ``sms`` blocks (more blocks
    where the chunks allow no more users a block)."""
    chunks = -(-num_targets // pair_slots)
    chunk = -(-num_targets // chunks)
    users = min(pair_slots // chunk, -(-batch * chunks // sms))
    return max(1, users), chunk


def _matched_scores_cuda(user_reprs, item_matrix, item_bias, ids,
                         mixtures):
    """K1c (``mixtures`` 0) or K4: one launch, which reads int32 or int64 ids
    as they are and clamps them itself; nothing is read back."""
    global MATCHED_SCORES_LAUNCHES, CANDIDATE_SCORES_LAUNCHES
    require_contiguous(user_reprs, item_matrix, item_bias)
    lib = _build.load('ranking')
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int32)
    ids = ids.contiguous()
    batch, num_targets = ids.shape
    out = torch.empty(ids.shape, dtype=torch.float32, device=ids.device)
    if batch * num_targets == 0:
        return out
    users, chunk = matched_launch_shape(
        batch, num_targets, lib.spotlight_matched_pair_slots(mixtures),
        _sm_count(ids.device))
    num_items, dim = item_matrix.shape
    status = lib.spotlight_matched_scores(
        user_reprs.data_ptr(), item_matrix.data_ptr(),
        int(item_matrix.dtype == torch.bfloat16), item_bias.data_ptr(),
        ids.data_ptr(), int(ids.dtype == torch.int64), out.data_ptr(), batch,
        num_items, dim, num_targets, mixtures, users, chunk,
        stream_handle(ids.device))
    if mixtures:
        _build.check(status, 'matched_candidate_scores kernel')
        CANDIDATE_SCORES_LAUNCHES += 1
    else:
        _build.check(status, 'matched_target_scores kernel')
        MATCHED_SCORES_LAUNCHES += 1
    return out
