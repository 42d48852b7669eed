"""Row-sparse (lazy) Adam training engine for large embedding tables.

Counterpart of ``spotlight_tpu/factorization/lazy.py`` on one device.  The
dense engine computes table-sized gradients and sweeps Adam over whole
tables every step; this engine's cost does not grow with the tables:

- the rows are gathered outside autograd and the gradient is taken with
  respect to the gathered rows (float32, also for a bfloat16 table), so no
  table-sized gradient exists;
- each table's occurrence gradients go to
  :func:`~spotlight_tpu_torch.ops.lazy_adam.sparse_adam_rows`, which groups
  them by row and runs P1 (``ops/kernels/row_update.py``): the row-Adam
  kernel on the card, its plain version on the CPU.  Two launches a step,
  one per table, in place.

Semantics are torch's ``SparseAdam`` (untouched rows' moments do not
decay; the bias correction uses the global step), with the reference's
coupled ``l2`` once per touched row.  A padded example's ids (user 0, item
0 and its sampled negatives) carry zero gradient rows and still take a
momentum step, as in JAX.  Selected with ``sparse=True`` on the
factorization estimator (the fused ``BilinearNet`` layout, no custom
optimizer).
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows
from spotlight_tpu_torch.ops.losses import IMPLICIT_LOSSES
from spotlight_tpu_torch.ops.sampling import (inbatch_pair_weights,
                                              weighted_inbatch_elems)
from spotlight_tpu_torch.utils.training import masked_mean

USER_TABLE = 'user_embeddings.weight'
ITEM_TABLE = 'item_embeddings.weight'


def _fused_pair_scores(u_rows, i_rows_stacked, dim):
    """(S, B) scores from fused rows: u_rows (B, D+1), stacked item rows
    (S, B, D+1), the arithmetic of ``BilinearNet.apply_with_negatives``."""
    return ((u_rows[None, :, :dim] * i_rows_stacked[..., :dim]).sum(dim=-1)
            + u_rows[None, :, dim] + i_rows_stacked[..., dim])


def _batch_item_ids(batch, negatives, in_batch):
    """The flat item ids of one step: the positives alone (in-batch) or the
    positives followed by the sampled negatives ``(n_neg, B)``."""
    items = batch['item_ids']
    if in_batch:
        return items
    return torch.cat([items[None], negatives], dim=0).reshape(-1)


def build_lazy_step(net, loss, learning_rate, l2, num_negatives,
                    negative_sampling='uniform'):
    """The lazy engine's step for a fused-layout ``BilinearNet``:
    ``step(opt_state, batch, negatives) -> loss`` (a device scalar), with
    ``opt_state`` from :func:`~spotlight_tpu_torch.ops.lazy_adam.
    lazy_adam_init` (updated in place, ``t`` included) and ``negatives``
    ``(n_neg, B)`` item ids (None for in-batch negatives).  Nothing is read
    back to the host."""
    dim = net.embedding_dim
    loss_func = IMPLICIT_LOSSES[loss]
    adaptive = loss == 'adaptive_hinge'
    n_neg = num_negatives if adaptive else 1
    in_batch = negative_sampling == 'in_batch'

    def stacked_scores(u_rows, i_rows, batch):
        """Loss elements, in-batch weights applied, from float32 fused
        rows; ``i_rows`` is flat ``(S * B, D + 1)``, S = 1 (in-batch) or
        1 + n_neg (uniform)."""
        if in_batch:
            pos_rows = i_rows.reshape(-1, dim + 1)
            stacked = torch.stack(
                [pos_rows] + [torch.roll(pos_rows, s, dims=0)
                              for s in range(1, n_neg + 1)], dim=0)
            dots = _fused_pair_scores(u_rows, stacked, dim)
            positive = dots[0]
            negative = dots[1:] if adaptive else dots[1]
            elems = loss_func(positive, negative, reduce=False)
            pair_weight = inbatch_pair_weights(batch['negative_weight'],
                                               negative, n_neg)
            return weighted_inbatch_elems(loss, elems, negative, pair_weight)
        stacked = i_rows.reshape(1 + n_neg, -1, dim + 1)
        dots = _fused_pair_scores(u_rows, stacked, dim)
        positive = dots[0]
        negative = dots[1:] if adaptive else dots[1]
        return loss_func(positive, negative, reduce=False)

    def step(opt_state, batch, negatives):
        users = batch['user_ids']
        opt_state['t'] += 1
        t = opt_state['t']
        u_table = net.user_embeddings.weight.data
        i_table = net.item_embeddings.weight.data
        flat_items = _batch_item_ids(batch, negatives, in_batch)

        # Cast after the gather, outside autograd: a bfloat16 table keeps
        # bfloat16 gathers, the score and gradient math runs in float32.
        u_rows = u_table[users].float().requires_grad_()
        i_rows = i_table[flat_items].float().requires_grad_()
        with torch.enable_grad():
            loss_value = masked_mean(stacked_scores(u_rows, i_rows, batch),
                                     batch['mask'])
            gu, gi = torch.autograd.grad(loss_value, (u_rows, i_rows))

        sparse_adam_rows(users, u_table, opt_state['mu'][USER_TABLE],
                         opt_state['nu'][USER_TABLE], gu, t, learning_rate,
                         l2)
        sparse_adam_rows(flat_items, i_table, opt_state['mu'][ITEM_TABLE],
                         opt_state['nu'][ITEM_TABLE], gi, t, learning_rate,
                         l2)
        return loss_value.detach()

    return step
