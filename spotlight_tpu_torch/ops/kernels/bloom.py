"""Fused bloom gather-sum (K6) with its backward.

Counterpart of ``spotlight_tpu/ops/kernels/bloom.py``: ``bloom_gather_sum(
table, rows)`` is ``table[rows].sum(-2)`` over the k hashed rows of each
id, summed in hash order in the table's dtype (the JAX kernel's accumulator
has the output's dtype), row 0 included.  Its gradient scatter-adds the
cotangent into every hashed row, in the cotangent's dtype, as the JAX
package's custom VJP does.  The TPU-only ``tile_batch`` and ``interpret``
arguments are dropped.

On CUDA tensors the forward launches ``gather_sum_kernel`` and the backward
``scatter_rows_kernel`` (``csrc/gather_sum.cu``); on CPU tensors both run
their plain versions.  No layer calls this op: ``BloomEmbedding`` gathers,
masks and sums in torch, as the JAX package's layer does.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.kernels import gather_sum

#: Launches of the forward and of the backward kernel made by
#: :func:`bloom_gather_sum`.
BLOOM_GATHER_LAUNCHES = 0
BLOOM_GATHER_BACKWARD_LAUNCHES = 0


def bloom_gather_sum_plain(table, rows):
    """Plain PyTorch version of :func:`bloom_gather_sum` (rows validated),
    on any device."""
    return gather_sum.gather_sum_plain(table, rows, False, table.dtype)


def bloom_gather_sum_backward_plain(grad, rows, num_rows):
    """Plain PyTorch version of the backward: ``(C, D)`` in the cotangent's
    dtype, in the kernel's order."""
    return gather_sum.scatter_rows_plain(grad, rows, num_rows, False,
                                         grad.dtype, grad.dtype)


class _BloomGatherSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, rows):
        global BLOOM_GATHER_LAUNCHES
        ctx.save_for_backward(rows)
        ctx.num_rows = table.shape[0]
        if not table.is_cuda:
            return bloom_gather_sum_plain(table, rows)
        out = gather_sum.gather_sum_cuda(table, rows, False, True)
        BLOOM_GATHER_LAUNCHES += 1
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        global BLOOM_GATHER_BACKWARD_LAUNCHES
        rows, = ctx.saved_tensors
        if not grad.is_cuda:
            return (bloom_gather_sum_backward_plain(grad, rows, ctx.num_rows),
                    None)
        dtable = gather_sum.scatter_rows_cuda(grad, rows, ctx.num_rows, False,
                                              True, grad.dtype)
        BLOOM_GATHER_BACKWARD_LAUNCHES += 1
        return dtable, None


def bloom_gather_sum(table, rows):
    """Fused ``table[rows].sum(-2)``, differentiable in ``table``.

    Parameters
    ----------
    table : (C, D) float32 or bfloat16 compressed embedding table
    rows : (B, k) int hashed row indices per id, each in ``[0, C)``; int32
        and int64 are taken as given.  On the card the kernel checks them:
        a row outside stops the launch with a device-side error at the next
        synchronisation, as ``F.embedding_bag`` does; on the CPU it raises
        ``ValueError``.

    Returns
    -------
    (B, D) summed embeddings, in ``table.dtype``.
    """
    rows = gather_sum.check_operands(table, rows)
    return _BloomGatherSum.apply(table, rows)
