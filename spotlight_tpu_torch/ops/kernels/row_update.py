"""Row-sparse Adam on the rows named by occurrence ids (P1).

Counterpart of ``scripts/fused_rowupdate_probe.py``'s ``_row_update_kernel``
(``fused_row_update``: in-place Adam on unique rows with pre-summed
gradients) and of the row update inside
``spotlight_tpu/ops/lazy_adam.py::sparse_adam_rows``, which the lazy
training engine runs twice a step.  :func:`row_adam` takes the occurrence
ids sorted once by :func:`sort_occurrences` (torch's stable sort, as JAX's
``argsort``), as the pair ``(sorted_ids, order)``: each run of equal ids is
one row's segment, ``order`` names its occurrences in ascending occurrence
order.  The update sums each row's occurrence gradients, adds ``l2 * row``
when ``l2 != 0`` and applies Adam to ``param``, ``mu`` and ``nu`` in place.
The probe's pre-deduplicated form is unique sorted ids with ``order =
arange(n)``.

On a CUDA tensor :func:`row_adam` launches the kernel of
``csrc/row_update.cu``, which reads the pair directly: a call is the sort
and one launch, with nothing read back to the host.  On a CPU tensor it
runs :func:`row_adam_plain`, which groups the runs with torch ops
(:func:`prepare_segments`) and does the same arithmetic in the same order
(each segment's sum from +0.0 in ascending position, taken a rank at a
time), so kernel and plain version agree bit for bit.  Nothing falls back.

The float32 constants are rounded as JAX's weak typing rounds them: each
Python float (``b1``, ``1 - b1``, ``-lr``, ``eps``, ``l2``, ...) is computed
in double and rounded once, and the bias corrections are JAX's jitted
``1 - b ** t`` (:func:`~spotlight_tpu_torch.utils.training.bias_correction`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spotlight_tpu_torch.ops.kernels import _build
from spotlight_tpu_torch.ops.kernels.ranking import (on_cuda,
                                                     require_contiguous,
                                                     stream_handle)
from spotlight_tpu_torch.utils.training import B1, B2, EPS, bias_correction

#: Kernel launches made by :func:`row_adam` (one per CUDA call).
ROW_ADAM_LAUNCHES = 0


class AdamScalars(NamedTuple):
    """The float32 constants of one update."""
    b1: np.float32
    omb1: np.float32
    b2: np.float32
    omb2: np.float32
    neg_lr: np.float32
    eps: np.float32
    l2: np.float32
    bc1: np.float32
    bc2: np.float32


def adam_scalars(t, lr, l2=0.0, b1=B1, b2=B2, eps=EPS):
    """The float32 constants of step ``t`` (a host int, 1 for the first
    step)."""
    f32 = np.float32
    return AdamScalars(f32(b1), f32(1 - b1), f32(b2), f32(1 - b2), f32(-lr),
                       f32(eps), f32(l2), bias_correction(b1, t),
                       bias_correction(b2, t))


def sort_occurrences(ids):
    """``(sorted_ids, order)``: one stable sort of the flat occurrence ids
    (any shape), in their own dtype when int32 or int64 (any other integer
    dtype as int64); ``order`` is int64, equal ids in occurrence order."""
    flat = ids.reshape(-1)
    if flat.dtype not in (torch.int32, torch.int64):
        flat = flat.long()
    return torch.sort(flat, stable=True)


class Segments(NamedTuple):
    """The plain version's runs of a sorted occurrence list: segment ``s``
    covers ``order[offsets[s]:offsets[s + 1]]`` and names row ``rows[s]``;
    ``count`` (a 0-d tensor) segments exist; ``rows`` past ``count`` hold
    no meaning."""
    order: torch.Tensor
    offsets: torch.Tensor
    rows: torch.Tensor
    count: torch.Tensor


def prepare_segments(sorted_ids, order):
    """Group a sorted occurrence list (:func:`sort_occurrences`) into
    segments, with no host synchronisation: head flags, their running sum
    for segment numbers, the offsets by ``searchsorted`` and the segment
    count as a device scalar."""
    n = sorted_ids.numel()
    device = sorted_ids.device
    if n == 0:
        return Segments(order, torch.zeros(1, dtype=torch.int64,
                                           device=device), sorted_ids,
                        torch.zeros((), dtype=torch.int64, device=device))
    head = torch.ones(n, dtype=torch.bool, device=device)
    head[1:] = sorted_ids[1:] != sorted_ids[:-1]
    segment = torch.cumsum(head, 0) - 1
    offsets = torch.searchsorted(segment, torch.arange(n + 1, device=device))
    rows = sorted_ids[offsets[:n].clamp(max=n - 1)]
    return Segments(order, offsets, rows, head.sum())


def check_operands(param, mu, nu, grads, sorted_ids, order):
    if param.dim() != 2 or param.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError('param must be (R, W) float32 or bfloat16')
    for name, table in (('mu', mu), ('nu', nu)):
        if table.shape != param.shape or table.dtype != torch.float32:
            raise ValueError('{} must be float32 of the shape of param'
                             .format(name))
    n = order.numel()
    if order.shape != (n,) or order.dtype != torch.int64:
        raise ValueError('order must be (n,) int64')
    if sorted_ids.shape != (n,) or sorted_ids.dtype not in (torch.int32,
                                                            torch.int64):
        raise ValueError('sorted_ids must be (n,) int32 or int64, one per '
                         'occurrence')
    if grads.shape != (n, param.shape[1]) or grads.dtype != torch.float32:
        raise ValueError('grads must be (n, W) float32, one row per '
                         'occurrence')
    if param.shape[0] >= 2 ** 31 or n * -(-param.shape[1] // 32) >= 2 ** 31:
        raise ValueError('tables and id lists beyond int32 are not '
                         'supported')
    return on_cuda(param, mu, nu, grads, sorted_ids, order)


@torch.no_grad()
def row_adam(param, mu, nu, grads, sorted_ids, order, scalars):
    """Adam on the rows named by the sorted occurrence list ``(sorted_ids,
    order)`` (:func:`sort_occurrences`) with the occurrence gradients
    ``grads`` (n, W) float32, in place on ``param`` (R, W) float32 or
    bfloat16 and its float32 moments ``mu`` and ``nu``; an id outside
    ``[0, R)`` updates nothing.  ``scalars`` from :func:`adam_scalars`.
    Returns ``(param, mu, nu)``."""
    if not check_operands(param, mu, nu, grads, sorted_ids, order):
        return row_adam_plain(param, mu, nu, grads, sorted_ids, order,
                              scalars)
    global ROW_ADAM_LAUNCHES
    require_contiguous(param, mu, nu, grads, sorted_ids, order)
    n = order.numel()
    if n == 0 or param.numel() == 0:
        return param, mu, nu
    lib = _build.load('row_update')
    status = lib.spotlight_row_adam(
        param.data_ptr(), int(param.dtype == torch.bfloat16), mu.data_ptr(),
        nu.data_ptr(), grads.data_ptr(), sorted_ids.data_ptr(),
        int(sorted_ids.dtype == torch.int64), order.data_ptr(), n,
        param.shape[0], param.shape[1],
        *(float(value) for value in scalars), stream_handle(param.device))
    _build.check(status, 'row_adam kernel')
    ROW_ADAM_LAUNCHES += 1
    return param, mu, nu


def segment_sums_plain(grads, segments, num_segments, num_rows=None):
    """(num_segments, W) float32: each segment's occurrence gradients summed
    from +0.0 in ascending order, a rank at a time (every segment's first
    occurrence, then every second, ...).  With ``num_rows``, a segment whose
    row is outside ``[0, num_rows)`` sums nothing (the kernel skips it):
    the foreign ids of a mesh rank's stream, one long run, add no ranks."""
    starts = segments.offsets[:num_segments].long()
    lengths = segments.offsets[1:num_segments + 1].long() - starts
    if num_rows is not None:
        rows = segments.rows[:num_segments]
        lengths = torch.where((rows >= 0) & (rows < num_rows), lengths, 0)
    last = segments.order.numel() - 1
    order = segments.order.long()
    summed = torch.zeros(num_segments, grads.shape[1], dtype=torch.float32,
                         device=grads.device)
    zero = torch.zeros((), dtype=torch.float32, device=grads.device)
    depth = int(lengths.max()) if num_segments else 0
    for rank in range(depth):
        # A segment shorter than the rank adds +0.0, which changes no sum:
        # one that starts from +0.0 never reads -0.0.
        term = grads[order[torch.clamp(starts + rank, max=last)]]
        summed = summed + torch.where((lengths > rank)[:, None], term, zero)
    return summed


@torch.no_grad()
def row_adam_plain(param, mu, nu, grads, sorted_ids, order, scalars):
    """The kernel's arithmetic as separate torch ops (any device)."""
    segments = prepare_segments(sorted_ids, order)
    num_segments = int(segments.count)
    if num_segments == 0:
        return param, mu, nu
    summed = segment_sums_plain(grads, segments, num_segments,
                                param.shape[0])
    rows = segments.rows[:num_segments].long()
    keep = torch.nonzero((rows >= 0) & (rows < param.shape[0])).reshape(-1)
    rows, g = rows[keep], summed[keep]

    # Factors and terms as 0-d CPU tensors, which a CUDA kernel takes by
    # value as float32.  The divisors live on the tables' device: PyTorch's
    # CUDA division by a CPU scalar multiplies by its reciprocal instead.
    b1, omb1, b2, omb2, neg_lr, eps, l2 = (
        torch.tensor(value, dtype=torch.float32) for value in scalars[:7])
    bc1, bc2 = (torch.full((), float(value), dtype=torch.float32,
                           device=param.device) for value in scalars[7:])
    p = param[rows].float()
    if float(scalars.l2) != 0.0:
        g = g + l2 * p
    m = b1 * mu[rows] + omb1 * g
    v = b2 * nu[rows] + (omb2 * g) * g
    # The square root in float64, rounded once to float32: the correctly
    # rounded float32 root that __fsqrt_rn gives (torch's CPU float32 sqrt
    # is off by an ulp at some values).
    root = torch.sqrt((v / bc2).double()).float()
    delta = (neg_lr * (m / bc1)) / (root + eps)
    param[rows] = (p + delta.to(param.dtype).float()).to(param.dtype)
    mu[rows] = m
    nu[rows] = v
    return param, mu, nu
