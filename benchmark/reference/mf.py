"""Spotlight's ``BilinearNet`` with user and item biases, the BPR loss and
Adam in optax's order, in plain PyTorch.

Tables are fused as the configurations hand them out: ``(rows, D + 1)``,
the factors in columns ``[:D]`` and the bias in column ``D``.
"""

from __future__ import annotations

import torch

from benchmark.reference.precision import operand

#: Adam's defaults (optax's, and Spotlight's torch.optim.Adam's).
B1, B2, EPS = 0.9, 0.999, 1e-8


def catalogue_scores(user_rows, item_table, precision='float32'):
    """(B, N) scores of users (rows of the user table) against every item:
    ``u . i + b_u + b_i``, the product in ``precision``."""
    dim = item_table.shape[1] - 1
    users = operand(user_rows[:, :dim].float(), precision)
    items = operand(item_table[:, :dim].float(), precision)
    return (users @ items.T + item_table[:, dim].float()[None, :]
            + user_rows[:, dim].float()[:, None])


def pair_scores(user_rows, item_rows):
    dim = user_rows.shape[-1] - 1
    return ((user_rows[..., :dim] * item_rows[..., :dim]).sum(-1)
            + user_rows[..., dim] + item_rows[..., dim])


def bpr_loss(user_table, item_table, users, items, negatives, mask):
    """Spotlight's BPR, ``1 - sigmoid(pos - neg)``, its mean over the rows
    that ``mask`` keeps."""
    u = user_table[users]
    positive = pair_scores(u, item_table[items])
    negative = pair_scores(u, item_table[negatives])
    elems = 1.0 - torch.sigmoid(positive - negative)
    mask = mask.to(elems.dtype)
    return (elems * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class Adam:
    """Adam with moments over whole tables, in optax's order:
    ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
    ``p += -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``."""

    def __init__(self, tables, learning_rate):
        self.learning_rate = learning_rate
        self.count = 0
        self.mu = [torch.zeros_like(t) for t in tables]
        self.nu = [torch.zeros_like(t) for t in tables]

    @torch.no_grad()
    def step(self, tables, grads):
        self.count += 1
        bc1 = 1.0 - B1 ** self.count
        bc2 = 1.0 - B2 ** self.count
        for table, grad, mu, nu in zip(tables, grads, self.mu, self.nu):
            mu.mul_(B1).add_((1.0 - B1) * grad)
            nu.mul_(B2).add_((1.0 - B2) * grad * grad)
            table.add_((mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
                       * -self.learning_rate)


def bpr_steps(user_table, item_table, batches, learning_rate,
              dtype=torch.float32, keep=None):
    """Dense BPR steps from the given tables (copied, in ``dtype``):
    autograd over the whole tables, then :class:`Adam`.  ``batches`` is a
    list of ``(users, items, negatives, mask)``; ``keep`` (a bool mask of
    the batch's rows, or None) drops rows from every step, for planting
    the fault of a batch half left out.

    Returns ``(losses, first_grads, tables)``: each step's loss, the first
    step's gradients and the tables after the last step, all float32."""
    tables = [user_table.detach().to(dtype).clone().requires_grad_(),
              item_table.detach().to(dtype).clone().requires_grad_()]
    adam = Adam([t.detach() for t in tables], learning_rate)
    losses, first = [], None
    for users, items, negatives, mask in batches:
        if keep is not None:
            mask = mask * keep.to(mask.dtype)
        loss = bpr_loss(tables[0], tables[1], users, items, negatives, mask)
        grads = torch.autograd.grad(loss, tables)
        if first is None:
            first = [g.float() for g in grads]
        adam.step([t.data for t in tables], grads)
        losses.append(float(loss.detach()))
    return losses, first, [t.detach().float() for t in tables]
