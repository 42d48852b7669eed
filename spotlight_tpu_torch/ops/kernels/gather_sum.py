"""The bloom gather-sum and its transpose, shared by
:mod:`~spotlight_tpu_torch.ops.kernels.bloom` (K6) and
:mod:`~spotlight_tpu_torch.ops.kernels.multihot` (K7f, K7b).

Both entry points compute ``table[rows].sum(-2)``; they differ in the mask
of row 0 and in the accumulator's dtype.  On CUDA tensors the launchers here
run the kernels of ``csrc/gather_sum.cu``; on CPU tensors the entry points
run the plain versions here, which spell out the kernels' order (hash order
forward, ascending flat index ``b * k + j`` within a row backward, each sum
started from its first term) as separate elementwise ops, so kernel and
plain version agree bit for bit.  ``index_add_`` is no plain version of the
backward: on CUDA it adds with atomics, in an order that changes from
launch to launch.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.kernels import _build
from spotlight_tpu_torch.ops.kernels.ranking import (on_cuda,
                                                     require_contiguous,
                                                     stream_handle)


def check_operands(table, rows):
    """Validate a (C, D) float32 or bfloat16 table and (B, k) integer rows;
    returns the rows contiguous, int32 or int64 as given (any other integer
    dtype as int32).  Only host metadata is read on CUDA tensors: there the
    kernel checks every row it reads, and a row outside ``[0, C)`` stops
    the launch with a device-side error that surfaces at the next
    synchronisation, as ``F.embedding_bag``'s does.  On CPU tensors such a
    row raises ``ValueError`` here (one look at the least and largest
    row), since torch's plain gather would wrap a negative row."""
    if table.dim() != 2 or table.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError('table must be (C, D) float32 or bfloat16')
    if rows.dim() != 2 or rows.dtype.is_floating_point:
        raise ValueError('rows must be (B, k) integers')
    num_rows = table.shape[0]
    if num_rows >= 2 ** 31 or rows.numel() >= 2 ** 31:
        raise ValueError('tables and row lists beyond int32 are not '
                         'supported')
    if not on_cuda(table, rows) and rows.numel():
        low, high = torch.stack(list(torch.aminmax(rows))).tolist()
        if low < 0 or high >= num_rows:
            raise ValueError('rows must lie in [0, {}) (got [{}, {}])'.format(
                num_rows, low, high))
    if rows.dtype not in (torch.int32, torch.int64):
        rows = rows.to(torch.int32)
    return rows.contiguous()


def gather_sum_plain(table, rows, mask_row_zero, acc_dtype):
    """``table[rows].sum(-2)`` summed in hash order from the first term in
    ``acc_dtype``, rounded to the table's dtype; with ``mask_row_zero`` a
    row equal to 0 adds a zero vector."""
    batch, num_hashes = rows.shape
    if num_hashes == 0:
        return table.new_zeros(batch, table.shape[1])
    rows = rows.long()
    zero = torch.zeros((), dtype=acc_dtype, device=table.device)

    def term(j):
        vectors = table[rows[:, j]].to(acc_dtype)
        if mask_row_zero:
            vectors = torch.where((rows[:, j] == 0)[:, None], zero, vectors)
        return vectors

    acc = term(0)
    for j in range(1, num_hashes):
        acc = acc + term(j)
    return acc.to(table.dtype)


def scatter_rows_plain(grad, rows, num_rows, mask_row_zero, acc_dtype,
                       out_dtype):
    """The transpose of :func:`gather_sum_plain`: ``dtable[c]`` sums
    ``grad[b]`` over the ``(b, j)`` with ``rows[b, j] == c`` in ascending
    flat index, from the first term, in ``acc_dtype``; untouched rows, and
    row 0 under ``mask_row_zero``, are zero.  The contributions are taken a
    rank at a time (every row's first, then every row's second, ...), so the
    work is the number of contributions whatever their skew."""
    batch, num_hashes = rows.shape
    dtable = torch.zeros(num_rows, grad.shape[1], dtype=acc_dtype,
                         device=grad.device)
    flat = rows.reshape(-1).long()
    if flat.numel():
        sorted_rows, order = torch.sort(flat, stable=True)
        rank = (torch.arange(flat.numel(), device=flat.device)
                - torch.searchsorted(sorted_rows, sorted_rows))
        by_rank = torch.argsort(rank, stable=True)
        start = 0
        for count in torch.bincount(rank).tolist():
            pick = by_rank[start:start + count]
            target = sorted_rows[pick]
            contribution = grad[order[pick] // num_hashes].to(acc_dtype)
            if start == 0:
                dtable[target] = contribution
            else:
                dtable[target] = dtable[target] + contribution
            start += count
    if mask_row_zero:
        dtable[0] = 0.0
    return dtable.to(out_dtype)


def gather_sum_cuda(table, rows, mask_row_zero, acc_table):
    """Launch the gather-sum kernel on validated operands: one launch, no
    host synchronisation."""
    require_contiguous(table, rows)
    lib = _build.load('gather_sum')
    batch, num_hashes = rows.shape
    out = torch.empty(batch, table.shape[1], dtype=table.dtype,
                      device=table.device)
    if batch == 0 or table.shape[1] == 0:
        return out
    if num_hashes == 0:
        return out.zero_()
    status = lib.spotlight_gather_sum(
        table.data_ptr(), int(table.dtype == torch.bfloat16), table.shape[0],
        rows.data_ptr(), int(rows.dtype == torch.int64), out.data_ptr(),
        batch, num_hashes, table.shape[1], int(mask_row_zero),
        int(acc_table), stream_handle(table.device))
    _build.check(status, 'gather_sum kernel')
    return out


def sort_rows(rows):
    """``(sorted_rows, order)``: one stable sort of the flat (B, k) rows as
    int32 keys (validated rows lie in ``[0, C)``, C < 2^31; a sort of int32
    keys takes half the radix passes of int64), ``order`` int64, equal rows
    in ascending flat index ``b * k + j``."""
    return torch.sort(rows.reshape(-1).to(torch.int32), stable=True)


def scatter_rows_cuda(grad, rows, num_rows, mask_row_zero, acc_table,
                      out_dtype):
    """Launch the scatter-by-row kernel: ``grad`` (B, D) in the table's
    dtype, ``rows`` the validated (B, k) int32 or int64 rows.  A call is one
    stable sort of the flat rows (:func:`sort_rows`) and one launch, which
    reads the sort's two outputs as they are, with no host
    synchronisation."""
    lib = _build.load('gather_sum')
    grad = grad.to(out_dtype).contiguous()
    dim = grad.shape[1]
    dtable = torch.empty(num_rows, dim, dtype=out_dtype, device=grad.device)
    if num_rows == 0 or dim == 0:
        return dtable
    if rows.numel() == 0:
        return dtable.zero_()
    sorted_rows, order = sort_rows(rows)
    status = lib.spotlight_scatter_rows(
        grad.data_ptr(), int(out_dtype == torch.bfloat16),
        sorted_rows.data_ptr(), order.data_ptr(), order.numel(),
        dtable.data_ptr(), num_rows, rows.shape[1], dim, int(mask_row_zero),
        int(acc_table), stream_handle(grad.device))
    _build.check(status, 'scatter_rows kernel')
    return dtable
