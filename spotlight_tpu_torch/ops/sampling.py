"""Negative item sampling and the in-batch importance weights.

Counterpart of ``spotlight_tpu/ops/sampling.py``.  The JAX package draws
its negatives with ``jax.random`` inside the jitted epoch; the port draws
them from an explicit ``torch.Generator`` (:func:`sample_items_device`),
a whole epoch at a time, so the same seed gives the same stream on the CPU
and on the card.  The two generators give different numbers: tests hand
both packages the same draws.

The in-batch weights correct negatives taken from the batch's own positive
items (drawn from the empirical item distribution) back to the uniform
objective: each pair is weighted by ``uniform(j) / q(j)``
(:func:`inbatch_importance_weight_table`; numpy, as in JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from spotlight_tpu_torch.ops.losses import sigmoid


def sample_items(num_items, shape, random_state=None):
    """Uniformly sample item ids on the host (API parity helper): int64
    ids in ``[0, num_items)`` from a numpy RandomState."""
    if random_state is None:
        random_state = np.random.RandomState()
    return random_state.randint(0, num_items, shape, dtype=np.int64)


def sample_items_device(generator, num_items, shape, device='cpu'):
    """Uniformly sample int64 item ids in ``[0, num_items)`` from
    ``generator`` (a CPU ``torch.Generator``), placed on ``device``."""
    ids = torch.randint(0, num_items, tuple(shape), generator=generator,
                        dtype=torch.int64)
    return ids.to(device)


def inbatch_importance_weights(item_ids, num_items, padding_idx=None):
    """Per-interaction importance weights for in-batch negatives: the
    :func:`inbatch_importance_weight_table` gathered at ``item_ids``
    (float32, shaped like ``item_ids``)."""
    weights = inbatch_importance_weight_table(item_ids, num_items,
                                              padding_idx=padding_idx)
    flat = np.asarray(item_ids).reshape(-1)
    out = weights[flat]
    return out.reshape(np.asarray(item_ids).shape).astype(np.float32)


def inbatch_importance_weight_table(item_ids, num_items, padding_idx=None):
    """``w(j) = n / (distinct * count(j))`` for the items occurring in
    ``item_ids``, 0 otherwise and at ``padding_idx``: a ``(num_items,)``
    float32 table normalised so ``E_{j~q}[w] = 1``."""
    flat = np.asarray(item_ids).reshape(-1)
    valid = np.ones(flat.shape, dtype=bool)
    if padding_idx is not None:
        valid = flat != padding_idx
    counts = np.bincount(flat[valid], minlength=num_items)
    if padding_idx is not None:
        counts[padding_idx] = 0
    distinct = int((counts > 0).sum())
    n = int(valid.sum())
    weights = np.zeros(num_items, dtype=np.float32)
    occupied = counts > 0
    weights[occupied] = n / (max(distinct, 1) * counts[occupied])
    return weights


def weighted_inbatch_elems(loss, elems, negative_scores, pair_weight):
    """Apply the in-batch importance weight to elementwise loss values.

    The pairwise losses weight the whole term; ``pointwise`` weights only
    its negative term ``sigmoid(neg)``: ``(elems - s) + w * s``."""
    if loss == 'pointwise':
        neg_elems = sigmoid(negative_scores)
        return (elems - neg_elems) + pair_weight * neg_elems
    return elems * pair_weight


def inbatch_pair_weights(weight, negative_scores, num_negatives):
    """Importance weight of each in-batch pair: the weight rolled by one
    for a single negative; for several (``adaptive_hinge``) the weight of
    the highest-scoring negative, whose shift is ``1 + argmax``."""
    if num_negatives == 1:
        return torch.roll(weight, 1, dims=0)
    stack = torch.stack([torch.roll(weight, s, dims=0)
                         for s in range(1, num_negatives + 1)], dim=0)
    hardest = torch.argmax(negative_scores, dim=0)
    return torch.take_along_dim(stack, hardest[None], dim=0)[0]
