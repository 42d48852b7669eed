"""Row-sparse Adam on the rows named by occurrence ids (P1).

Counterpart of ``scripts/fused_rowupdate_probe.py``'s ``_row_update_kernel``
(``fused_row_update``: in-place Adam on unique rows with pre-summed
gradients) and of the row update inside
``spotlight_tpu/ops/lazy_adam.py::sparse_adam_rows``, which the lazy
training engine runs twice a step.  :func:`row_adam` takes occurrence ids
with repeats: :func:`prepare_segments` groups them by row with a stable
sort (torch's, shared by both versions), and the update sums each row's
occurrence gradients, adds ``l2 * row`` when ``l2 != 0`` and applies Adam to
``param``, ``mu`` and ``nu`` in place.

On a CUDA tensor :func:`row_adam` launches the kernel of
``csrc/row_update.cu``; on a CPU tensor it runs :func:`row_adam_plain`,
which does the same arithmetic in the same order as separate torch ops
(each segment's sum from +0.0 in ascending occurrence order, taken a rank
at a time), so kernel and plain version agree bit for bit.  Nothing falls
back.  No step of either reads a value back to the host on the kernel's
path: the number of distinct rows stays on the device.

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


class Segments(NamedTuple):
    """Occurrences grouped by row: ``order`` (n,) lists the occurrences by
    ascending row id (equal ids in occurrence order), segment ``s`` covers
    ``order[offsets[s]:offsets[s + 1]]`` and names row ``rows[s]``;
    ``count`` (a 0-d tensor) segments exist.  All int32, on the ids'
    device; ``rows`` past ``count`` hold no meaning."""
    order: torch.Tensor
    offsets: torch.Tensor
    rows: torch.Tensor
    count: torch.Tensor


def prepare_segments(ids):
    """Group the occurrence ids (any shape, any integer dtype) by row, with
    no host synchronisation: a stable sort, head flags, their running sum
    for segment numbers, the offsets by ``searchsorted`` and the segment
    count as a device scalar."""
    flat = ids.reshape(-1).to(torch.int32)
    n = flat.numel()
    device = flat.device
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=device)
        return Segments(empty, torch.zeros(1, dtype=torch.int32,
                                           device=device), empty,
                        torch.zeros((), dtype=torch.int32, device=device))
    sorted_ids, order = torch.sort(flat, stable=True)
    head = torch.ones(n, dtype=torch.bool, device=device)
    head[1:] = sorted_ids[1:] != sorted_ids[:-1]
    segment = torch.cumsum(head, 0) - 1
    offsets = torch.searchsorted(
        segment, torch.arange(n + 1, device=device), out_int32=True)
    rows = sorted_ids[offsets[:n].clamp(max=n - 1).long()]
    count = head.sum().to(torch.int32)
    return Segments(order.to(torch.int32), offsets, rows, count)


def check_operands(param, mu, nu, grads, segments):
    if param.dim() != 2 or param.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError('param must be (R, W) float32 or bfloat16')
    for name, table in (('mu', mu), ('nu', nu)):
        if table.shape != param.shape or table.dtype != torch.float32:
            raise ValueError('{} must be float32 of the shape of param'
                             .format(name))
    n = segments.order.numel()
    if grads.shape != (n, param.shape[1]) or grads.dtype != torch.float32:
        raise ValueError('grads must be (n, W) float32, one row per '
                         'occurrence')
    if param.shape[0] >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError('tables and id lists beyond int32 are not '
                         'supported')
    return on_cuda(param, mu, nu, grads, *segments)


@torch.no_grad()
def row_adam(param, mu, nu, grads, segments, scalars):
    """Adam on the rows of ``segments`` (:func:`prepare_segments`) with the
    occurrence gradients ``grads`` (n, W) float32, in place on ``param``
    (R, W) float32 or bfloat16 and its float32 moments ``mu`` and ``nu``.
    ``scalars`` from :func:`adam_scalars`.  Returns ``(param, mu, nu)``."""
    if not check_operands(param, mu, nu, grads, segments):
        return row_adam_plain(param, mu, nu, grads, segments, scalars)
    global ROW_ADAM_LAUNCHES
    require_contiguous(param, mu, nu, grads, *segments)
    n = segments.order.numel()
    if n == 0 or param.numel() == 0:
        return param, mu, nu
    lib = _build.load('row_update')
    status = lib.spotlight_row_adam(
        param.data_ptr(), int(param.dtype == torch.bfloat16), mu.data_ptr(),
        nu.data_ptr(), grads.data_ptr(), segments.order.data_ptr(),
        segments.offsets.data_ptr(), segments.rows.data_ptr(),
        segments.count.data_ptr(), n, param.shape[0], param.shape[1],
        *(float(value) for value in scalars), stream_handle(param.device))
    _build.check(status, 'row_adam kernel')
    ROW_ADAM_LAUNCHES += 1
    return param, mu, nu


def segment_sums_plain(grads, segments, num_segments):
    """(num_segments, W) float32: each segment's occurrence gradients summed
    from +0.0 in ascending order, a rank at a time (every segment's first
    occurrence, then every second, ...)."""
    starts = segments.offsets[:num_segments].long()
    lengths = segments.offsets[1:num_segments + 1].long() - starts
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
def row_adam_plain(param, mu, nu, grads, segments, scalars):
    """The kernel's arithmetic as separate torch ops (any device)."""
    num_segments = int(segments.count)
    if num_segments == 0:
        return param, mu, nu
    summed = segment_sums_plain(grads, segments, num_segments)
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
