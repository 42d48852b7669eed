"""Bloom gather-sum with the multi-hot semantics (K7f) and its gradient
(K7b).

Counterpart of ``spotlight_tpu/ops/kernels/multihot.py``:
``multihot_gather_sum(table, rows, mask_row_zero)`` is ``multihot @ table``
with ``multihot[b, c]`` the number of hashes of id ``b`` that land on row
``c``: duplicates count twice, and ``mask_row_zero`` drops every row-0
contribution (the padding convention of ``BloomEmbedding``), in the forward
and in the gradient.  It accumulates in float32 and rounds to the table's
dtype once; the gradient ``multihot.T @ grad`` likewise, row 0 zero under
the mask.  The TPU kernel's one-hot tile on the MXU, and with it its bf16
hi/lo split of float32 tables (about 16 bits), are not carried over: here
the float32 sum is exact to float32 rounding.  The TPU-only ``batch_tile``,
``table_tile`` and ``interpret`` arguments are dropped.

On CUDA tensors the forward launches ``gather_sum_kernel`` and the backward
``scatter_rows_kernel`` (``csrc/gather_sum.cu``, K7b, deterministic: no
floating-point atomics); on CPU tensors both run their plain versions.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.kernels import gather_sum

#: Launches of the forward (K7f) and of the backward (K7b) kernel made by
#: :func:`multihot_gather_sum`.
MULTIHOT_LAUNCHES = 0
MULTIHOT_BACKWARD_LAUNCHES = 0


def multihot_gather_sum_plain(table, rows, mask_row_zero=False):
    """Plain PyTorch version of :func:`multihot_gather_sum` (rows
    validated), on any device."""
    return gather_sum.gather_sum_plain(table, rows, mask_row_zero,
                                       torch.float32)


def multihot_gather_sum_backward_plain(grad, rows, num_rows,
                                       mask_row_zero=False, dtype=None):
    """Plain PyTorch version of the backward (K7b): ``(C, D)`` summed in
    float32 in the kernel's order, in ``dtype`` (default the
    cotangent's)."""
    return gather_sum.scatter_rows_plain(grad, rows, num_rows, mask_row_zero,
                                         torch.float32, dtype or grad.dtype)


class _MultihotGatherSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, rows, mask_row_zero):
        global MULTIHOT_LAUNCHES
        ctx.save_for_backward(rows)
        ctx.num_rows = table.shape[0]
        ctx.mask_row_zero = mask_row_zero
        ctx.dtype = table.dtype
        if not table.is_cuda:
            return multihot_gather_sum_plain(table, rows, mask_row_zero)
        out = gather_sum.gather_sum_cuda(table, rows, mask_row_zero, False)
        MULTIHOT_LAUNCHES += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        global MULTIHOT_BACKWARD_LAUNCHES
        rows, = ctx.saved_tensors
        if not grad.is_cuda:
            return multihot_gather_sum_backward_plain(
                grad, rows, ctx.num_rows, ctx.mask_row_zero,
                ctx.dtype), None, None
        dtable = gather_sum.scatter_rows_cuda(grad, rows, ctx.num_rows,
                                              ctx.mask_row_zero, False,
                                              ctx.dtype)
        MULTIHOT_BACKWARD_LAUNCHES += 1
        return dtable, None, None


def multihot_gather_sum(table, rows, mask_row_zero=False):
    """Fused ``table[rows].sum(-2)`` with multi-hot semantics,
    differentiable in ``table``.

    Parameters
    ----------
    table : (C, D) float32 or bfloat16 compressed embedding table
    rows : (B, k) int hashed row indices per id, each in ``[0, C)``; int32
        and int64 are taken as given.  On the card the kernel checks them:
        a row outside stops the launch with a device-side error at the next
        synchronisation, as ``F.embedding_bag`` does; on the CPU it raises
        ``ValueError``.
    mask_row_zero : bool
        Drop every contribution that lands on row 0 (padding semantics, see
        :class:`~spotlight_tpu_torch.ops.embeddings.BloomEmbedding`); the
        gradient to row 0 is zero as well.

    Returns
    -------
    (B, D) summed embeddings, in ``table.dtype``.
    """
    rows = gather_sum.check_operands(table, rows)
    return _MultihotGatherSum.apply(table, rows, bool(mask_row_zero))
