"""The operations of a call through causal self-attention blocks
(``SelfAttentionNet``), counted from its sequences' real steps.

Only the products count, two operations a multiply-add: per block and
sequence of l real steps, the three D x D projections (query, key, value)
and the feed-forward layer's two (W_1, W_2), 5 x 2 l D^2 (SASRec's block
has no output projection), and over the l (l + 1) / 2 causal pairs of real
steps the scores and the weighted sum of values, 2 x 2 D l (l + 1) / 2.
Padded steps, masked pairs and the elementwise passes (LayerNorms,
softmax, ReLU, residuals: under 5% of the count at D = 50) are left out.
The catalogue scoring adds 2 B N D (``peaks.scoring_ops``).
"""

from __future__ import annotations

import numpy as np

from benchmark import peaks


def block_ops(real_steps, dim):
    """float32 operations of one block over sequences with ``real_steps``
    (one count a sequence) real steps."""
    steps = np.asarray(real_steps, dtype=np.float64)
    return float((10 * dim * dim * steps
                  + 2 * dim * steps * (steps + 1)).sum())


def call_ops(real_steps, dim, num_blocks, num_items):
    """float32 operations of one call: ``num_blocks`` blocks over its
    sequences, then their catalogue scoring."""
    return (num_blocks * block_ops(real_steps, dim)
            + peaks.scoring_ops(len(real_steps), num_items, dim))
