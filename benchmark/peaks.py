"""The yardstick: the chip's published peaks and the operations and bytes
of the port's work, counted from shapes.

A frozen copy of the arithmetic of ``chip_smoke.py`` (``bound``,
``no_fma_floor_ms``, ``mixture_ops``, the rank and top-k passes' counts),
with the dense engine's Adam bytes beside it.  Counts follow the roofline
rule: each input byte read once and each output byte written once,
whatever a kernel reads again.
"""

from __future__ import annotations

import math

#: Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
#: outside the tensor cores, and HBM3 bandwidth.
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
#: float32 instructions a second when no multiply and add may fuse (132 SMs
#: x 128 lanes x ~1.98 GHz): the floor of scores held to the port's
#: exact-tie order, which bars FMA.
NO_FMA_OPS_PER_S = 33.5e12

FLOAT32_BYTES = 4


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the float32
    peak and the bytes over the memory rate."""
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def no_fma_floor_ms(batch, num_items, width):
    """The exact-tie order's floor of a catalogue pass: 2 B N K float32
    instructions at NO_FMA_OPS_PER_S, K the user width (D for dots, 2 M D
    for a mixture of M tastes)."""
    return 2 * batch * num_items * width / NO_FMA_OPS_PER_S * 1e3


def mixture_ops(batch, num_items, dim, mixtures):
    """float32 operations of mixture scores for batch x num_items pairs:
    2M dots of D multiplies and adds, then the combine (M - 1 maxima, M
    subtractions, M expf counted as one operation each, M - 1 adds to the
    denominator, M multiplies and M - 1 adds, a division and the bias)."""
    return batch * num_items * (2 * 2 * mixtures * dim + 6 * mixtures)


def scoring_ops(batch, num_items, dim, mixtures=None):
    """float32 operations of scoring a batch against the catalogue: 2 B N D
    for dots, :func:`mixture_ops` for mixtures."""
    if mixtures is None:
        return 2 * batch * num_items * dim
    return mixture_ops(batch, num_items, dim, mixtures)


def user_width(dim, mixtures=None):
    """Floats a user (or sequence) hands the catalogue pass: D, or 2 M D."""
    return dim if mixtures is None else 2 * mixtures * dim


def target_compares(targets):
    """Compares (each with its add) that placing one item's score among a
    user's ``targets`` needs: one per target while they are few, a search
    of the sorted targets (ceil(log2(T + 1)) + 1) once that is fewer."""
    return min(targets, math.ceil(math.log2(targets + 1)) + 1)


def rank_pass(batch, num_items, dim, targets, mixtures=None):
    """(ops, bytes) of the rank pass (K1, dot or mixture scoring): the
    scores, then a compare and an add per item and target compare
    (:func:`target_compares`); the items and their bias, the users, and per
    target a score in and a weight out."""
    ops = (scoring_ops(batch, num_items, dim, mixtures)
           + 2 * batch * target_compares(targets) * num_items)
    nbytes = (FLOAT32_BYTES * num_items * (dim + 1)
              + FLOAT32_BYTES * batch * user_width(dim, mixtures)
              + 8 * batch * targets)
    return ops, nbytes


def dense_adam_bytes(num_params):
    """Bytes one dense Adam step must move: each parameter, its two moments
    read and written once (float32)."""
    return 6 * FLOAT32_BYTES * num_params


def dense_adam_ops(num_params):
    """float32 operations of one dense Adam step in the port's order, per
    parameter: two for each moment, the two bias corrections, the square
    root, the epsilon, the division, the learning rate and the add."""
    return 13 * num_params


def bilinear_step(batch, dim, num_params, negatives=1):
    """(ops, bytes) of one dense BPR step of a bilinear model with fused
    (D + 1)-wide tables: the forward and backward of the pair scores, then
    Adam over every parameter; the batch's gathered rows (user, item and
    each negative) read and their gradients written, beside Adam's
    passes."""
    rows = batch * (2 + negatives)
    width = dim + 1
    ops = 6 * rows * width + dense_adam_ops(num_params)
    nbytes = (dense_adam_bytes(num_params)
              + 2 * FLOAT32_BYTES * rows * width + 8 * rows)
    return ops, nbytes
