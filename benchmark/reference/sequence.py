"""Spotlight's ``MixtureLSTMNet`` (Kula, arXiv:1711.08379) scoring the
catalogue, in plain PyTorch.

The item table is fused, ``(num_items, D + 1)`` with the bias in column
``D``; id 0 is the padding id and embeds as zeros.  The LSTM takes the
embedded sequence shifted right by one zero step (each step sees the items
before it) with gates in the order (i, f, g, o); its last hidden state is
projected to M taste vectors and M attention vectors.  An item's score is
the softmax-over-tastes of its attention dots, weighting its taste dots,
plus its bias.
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import operand


def final_representation(weights, sequences, precision='float32'):
    """(B, 2M, D) final representations of ``sequences`` (B, L): the last
    LSTM state after the whole sequence, projected."""
    table = weights['item_embeddings.weight']
    dim = table.shape[1] - 1
    emb = table[sequences][..., :dim] * (sequences != 0)[..., None]
    emb = torch.cat([torch.zeros_like(emb[:, :1]), emb], dim=1)
    w_ih = operand(weights['lstm.w_ih'], precision)
    w_hh = operand(weights['lstm.w_hh'], precision)
    x_proj = (operand(emb, precision) @ w_ih + weights['lstm.b_ih']
              + weights['lstm.b_hh'])
    h = c = torch.zeros_like(x_proj[:, 0, :dim])
    for step in range(x_proj.shape[1]):
        gates = x_proj[:, step] + operand(h, precision) @ w_hh
        i, f, g, o = gates.split(dim, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    projected = (operand(h, precision)
                 @ operand(weights['projection.weight'], precision)
                 + weights['projection.bias'])
    return projected.reshape(h.shape[0], -1, dim)


def catalogue_scores(weights, final, precision='float32'):
    """(B, N) mixture scores of final representations (B, 2M, D)."""
    table = weights['item_embeddings.weight']
    dim = table.shape[1] - 1
    mixtures = final.shape[1] // 2
    items = operand(table[:, :dim], precision)
    tastes = operand(final[:, :mixtures], precision) @ items.T
    attention = operand(final[:, mixtures:], precision) @ items.T
    weights_ = torch.softmax(attention, dim=1)
    return (weights_ * tastes).sum(dim=1) + table[:, dim][None, :]
