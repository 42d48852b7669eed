"""Precisions of the reference and of its controls.

The reference runs in float32 with TF32 off, as the configurations state.
The controls compute the same in the nearest precision below: TF32 for the
matrix products (float32 inputs rounded to TF32's 10-bit mantissa, then
multiplied and summed in float32, which is what the tensor cores do, so the
control reads the same on the CPU and on the card), and bfloat16 where no
matrix product is involved.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    """float32 products with TF32 off, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_tf32(x):
    """``x`` (float32) rounded to nearest on TF32's 10-bit mantissa, still
    stored as float32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1fff
    return rounded.view(torch.float32)


def operand(x, precision):
    """A matrix product's operand in ``precision``: 'float32' as it is,
    'tf32' rounded to TF32."""
    if precision == 'float32':
        return x
    if precision == 'tf32':
        return to_tf32(x)
    raise ValueError('unknown precision {!r}'.format(precision))
