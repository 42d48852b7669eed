"""SASRec (Kang and McAuley, "Self-Attentive Sequential Recommendation",
ICDM 2018, arXiv:1808.09781) scoring the catalogue, in plain PyTorch.

The forward pass written out from the paper, with the departures the
configuration lists under ``assumed``: Spotlight's item bias column in
the scores, the authors' code's final LayerNorm and LayerNorm epsilon of
1e-8.  Dropout is off (the serving forward pass).

Weights are named as the port's ``SelfAttentionNet`` names its parameters
(the harness hands both sides the same tensors): the fused item table
``item_embeddings.weight`` ``(N, D + 1)`` with the bias in column ``D``
and id 0 the padding id, embedding as zeros; the positions
``position_embeddings`` ``(n, D)``; per block ``blocks.<b>.`` ``w_q``,
``w_k``, ``w_v``, ``w_1``, ``w_2`` ``(D, D)`` (``x @ W``), ``b_1``,
``b_2``, and the LayerNorms ``norm_a_weight``, ``norm_a_bias``,
``norm_f_weight``, ``norm_f_bias``; ``output_norm.weight`` and
``output_norm.bias``.

A sequence of L items is shifted right by one padding step, so that the
output at step t has seen the items before t; step j of the L + 1 takes
position row n - 1 - (L - j) (the newest step row n - 1), and a step
without a row is padding.  Every product's operands go through
:func:`~benchmark.reference.precision.operand`, so that the same code gives
the float32 reference and its TF32 control.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.precision import float32_exact, operand

#: LayerNorm's epsilon (the authors' code's).
EPS = 1e-8


def _product(x, w, precision):
    return operand(x, precision) @ operand(w, precision)


def _layer_norm(x, gain, offset):
    mean = x.mean(dim=-1, keepdim=True)
    variance = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(variance + EPS) * gain + offset


def _attention(a, block, real, precision):
    """Causal single-head attention of LayerNormed inputs ``a`` (B, T, D),
    keys at padding steps (``real`` False) hidden; a query with no key
    left gives zeros."""
    dim = a.shape[-1]
    queries = _product(a, block['w_q'], precision)
    keys = _product(a, block['w_k'], precision)
    values = _product(a, block['w_v'], precision)
    scores = _product(queries, keys.transpose(1, 2), precision) \
        / math.sqrt(dim)
    steps = a.shape[1]
    visible = (torch.arange(steps, device=a.device)[None, :]
               <= torch.arange(steps, device=a.device)[:, None])
    visible = visible[None] & real[:, None, :]
    scores = torch.where(visible, scores, torch.full_like(scores, -math.inf))
    top = scores.amax(dim=-1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    exps = torch.exp(scores - top)
    total = exps.sum(dim=-1, keepdim=True)
    weights = torch.where(total > 0, exps / torch.where(total > 0, total, 1.0),
                          torch.zeros_like(exps))
    return _product(weights, values, precision)


def representations(weights, sequences, num_blocks, precision='float32'):
    """(B, L + 1, D) outputs of the blocks' final LayerNorm on the shifted
    ``sequences`` (B, L) of item ids: step t has seen the items before t,
    step L all of them.  float32 products with TF32 off."""
    with float32_exact():
        return _representations(weights, sequences, num_blocks, precision)


def _representations(weights, sequences, num_blocks, precision):
    table = weights['item_embeddings.weight']
    positions = weights['position_embeddings']
    window, dim = positions.shape
    length = sequences.shape[1]
    if length > window:
        raise ValueError('{} items past the {} positions'.format(length,
                                                                  window))
    ids = torch.cat([torch.zeros_like(sequences[:, :1]), sequences], dim=1)
    real = ids != 0
    rows = torch.arange(length + 1, device=ids.device) + (window - 1 - length)
    position_rows = torch.where((rows >= 0)[:, None],
                                positions[rows.clamp(min=0)],
                                torch.zeros_like(positions[:1]))
    x = (table[ids][..., :dim] + position_rows[None]) * real[..., None]
    for b in range(num_blocks):
        block = {name[len('blocks.{}.'.format(b)):]: value
                 for name, value in weights.items()
                 if name.startswith('blocks.{}.'.format(b))}
        a = _layer_norm(x, block['norm_a_weight'], block['norm_a_bias'])
        s = x + _attention(a, block, real, precision)
        f = _layer_norm(s, block['norm_f_weight'], block['norm_f_bias'])
        inner = torch.relu(_product(f, block['w_1'], precision)
                           + block['b_1'])
        x = (s + _product(inner, block['w_2'], precision) + block['b_2']) \
            * real[..., None]
    return _layer_norm(x, weights['output_norm.weight'],
                       weights['output_norm.bias'])


def final_representation(weights, sequences, num_blocks,
                         precision='float32'):
    """(B, D): the output at the newest step, after every item of
    ``sequences`` (B, L)."""
    return representations(weights, sequences, num_blocks, precision)[:, -1]


def catalogue_scores(weights, final, precision='float32'):
    """(B, N) scores of final representations (B, D): the dot with each
    item's factors plus its bias."""
    table = weights['item_embeddings.weight']
    dim = table.shape[1] - 1
    with float32_exact():
        return (_product(final, table[:, :dim].T, precision)
                + table[:, dim][None, :])


def bpr_loss(weights, sequences, negatives, row_mask, num_blocks):
    """The estimator's per-step BPR loss of one batch: at every step t of
    ``sequences`` (B, L), the item at t against ``negatives[:, t]``, scored
    by the output before t; the mean of ``1 - sigmoid(positive -
    negative)`` over the steps that hold an item in rows with
    ``row_mask``."""
    table = weights['item_embeddings.weight']
    dim = table.shape[1] - 1
    per_step = representations(weights, sequences, num_blocks)[:, :-1]

    def scores(items):
        rows = table[items] * (items != 0)[..., None]
        return (per_step * rows[..., :dim]).sum(dim=-1) + rows[..., dim]

    loss = 1.0 - torch.sigmoid(scores(sequences) - scores(negatives))
    mask = ((sequences != 0) & row_mask[:, None]).float()
    return (loss * mask).sum() / mask.sum().clamp(min=1.0)
