"""Row-sparse (lazy) Adam training engine for large embedding tables.

Counterpart of ``spotlight_tpu/factorization/lazy.py``.  The
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
optimizer).  With ``explicit`` the step scores the positives alone
against ``batch['ratings']`` (the explicit estimator's losses; no negative
is drawn).

On a mesh (:mod:`spotlight_tpu_torch.parallel`) the tables and their
moments are row-sharded over ``'model'``, and the batch over the batch axes
of the exchange (``parallel.training.batch_axes``).  Each rank looks its
slice's rows up through the exchange, outside autograd; takes the loss of
its slice over the global mask count, so each occurrence's gradient row is
one device's; gathers the ids and gradient rows over the batch axes in role
order (``parallel.training.gather_roles``), which is one device's order;
and runs P1 on the rows of its blocks that it owns
(``parallel.training.owned_row_update``).  With uniform negatives every
rank's blocks are then one device's, bit for bit.  A step hands the
``'data'`` axis only the slice's ids and its ``(D + 1)``-wide gradient
rows, not table-sized gradients.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.lazy_adam import lazy_adam_init, sparse_adam_rows
from spotlight_tpu_torch.ops.losses import EXPLICIT_LOSSES, IMPLICIT_LOSSES
from spotlight_tpu_torch.ops.sampling import (inbatch_pair_weights,
                                              weighted_inbatch_elems)
from spotlight_tpu_torch.parallel import training as ptraining
from spotlight_tpu_torch.parallel.sharding import (PartitionSpec,
                                                   _exchange_gather,
                                                   holds_blocks)
from spotlight_tpu_torch.utils.training import masked_mean

__all__ = ['build_lazy_step', 'lazy_adam_init', 'lazy_opt_specs',
           'sparse_adam_rows']

USER_TABLE = 'user_embeddings.weight'
ITEM_TABLE = 'item_embeddings.weight'


def lazy_opt_specs(param_specs):
    """The spec tree of :func:`lazy_adam_init`'s state on a mesh: the
    moments shard as their parameters; the step count replicates."""
    return {'mu': param_specs, 'nu': param_specs, 't': PartitionSpec()}


def _fused_pair_scores(u_rows, i_rows_stacked, dim):
    """(S, B) scores from fused rows: u_rows (B, D+1), stacked item rows
    (S, B, D+1), the arithmetic of ``BilinearNet.apply_with_negatives``."""
    return ((u_rows[None, :, :dim] * i_rows_stacked[..., :dim]).sum(dim=-1)
            + u_rows[None, :, dim] + i_rows_stacked[..., dim])


def _batch_item_ids(batch, negatives, positives_only):
    """The flat item ids of one step: the positives alone (explicit or
    in-batch) or the positives followed by the sampled negatives
    ``(n_neg, B)``."""
    items = batch['item_ids']
    if positives_only:
        return items
    return torch.cat([items[None], negatives], dim=0).reshape(-1)


def build_lazy_step(net, loss, learning_rate, l2, num_negatives,
                    negative_sampling='uniform', explicit=False, mesh=None,
                    exchange='psum'):
    """The lazy engine's step for a fused-layout ``BilinearNet``:
    ``step(opt_state, batch, negatives) -> loss`` (a device scalar), with
    ``opt_state`` from :func:`~spotlight_tpu_torch.ops.lazy_adam.
    lazy_adam_init` (updated in place, ``t`` included) and ``negatives``
    ``(n_neg, B)`` item ids (None for in-batch negatives and for
    ``explicit``, whose batch carries ``'ratings'``).  Nothing is read back
    to the host.

    On a ``mesh`` the network holds its blocks of the tables, ``batch`` and
    ``negatives`` are the rank's slice (``parallel.training.batch_rows``),
    the rows come through ``exchange`` and the loss returned is the sum of
    the ranks' over the batch axes, replicated (see the module
    docstring)."""
    dim = net.embedding_dim
    loss_func = (EXPLICIT_LOSSES if explicit else IMPLICIT_LOSSES)[loss]
    adaptive = loss == 'adaptive_hinge'
    n_neg = num_negatives if adaptive else 1
    in_batch = (not explicit) and negative_sampling == 'in_batch'

    def stacked_scores(u_rows, i_rows, batch):
        """Loss elements, in-batch weights applied, from float32 fused
        rows; ``i_rows`` is flat ``(S * B, D + 1)``, S = 1 (explicit and
        in-batch) or 1 + n_neg (uniform)."""
        if explicit:
            predictions = _fused_pair_scores(u_rows, i_rows[None], dim)[0]
            if loss == 'poisson':
                predictions = torch.exp(predictions)
            return loss_func(batch['ratings'], predictions, reduce=False)
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

    if mesh is not None:
        return _mesh_step(net, stacked_scores, learning_rate, l2, explicit
                          or in_batch, mesh, exchange)

    def step(opt_state, batch, negatives):
        users = batch['user_ids']
        opt_state['t'] += 1
        t = opt_state['t']
        u_table = net.user_embeddings.weight.data
        i_table = net.item_embeddings.weight.data
        flat_items = _batch_item_ids(batch, negatives,
                                     explicit or in_batch)

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


def _mesh_step(net, stacked_scores, learning_rate, l2, positives_only, mesh,
               exchange):
    """The body of JAX's ``_build_distributed`` ``sharded_step``: the step
    of :func:`build_lazy_step` on a mesh."""
    dim = net.embedding_dim
    axes = ptraining.batch_axes(exchange)
    # Whole tables (a model trained replicated): a plain gather, and every
    # rank owns every row.
    replicated = not holds_blocks(net)

    def lookup(table, ids):
        # Outside autograd; at full capacity, the capacity-factored
        # exchange drops nothing.
        with torch.no_grad():
            rows = (table[ids] if replicated else
                    _exchange_gather(mesh, table, ids, 'model', exchange))
            return rows.float().requires_grad_()

    def step(opt_state, batch, negatives):
        users = batch['user_ids']
        opt_state['t'] += 1
        t = opt_state['t']
        u_table = net.user_embeddings.weight.data
        i_table = net.item_embeddings.weight.data
        roles = (batch['item_ids'][None] if positives_only else
                 torch.cat([batch['item_ids'][None], negatives], dim=0))

        u_rows = lookup(u_table, users)
        i_rows = lookup(i_table, roles.reshape(-1))
        with torch.enable_grad():
            elems = stacked_scores(u_rows, i_rows, batch)
            mask = batch['mask'].to(elems.dtype)
            count = mesh.all_reduce(mask.sum(), axes)
            local_loss = (elems * mask).sum() / torch.clamp(count, min=1.0)
            gu, gi = torch.autograd.grad(local_loss, (u_rows, i_rows))

        # The global occurrence stream in one device's order, in two
        # gathers (ids, gradient rows): users, then the item positives and
        # each negative column.
        ids = ptraining.gather_roles(
            mesh, torch.cat([users[None], roles]), axes)
        grads = ptraining.gather_roles(mesh, torch.cat(
            [gu[None], gi.reshape(roles.shape + (dim + 1,))]), axes)
        ptraining.owned_row_update(
            ids[0], u_table, opt_state['mu'][USER_TABLE],
            opt_state['nu'][USER_TABLE], grads[0], t, learning_rate, l2,
            mesh, replicated)
        ptraining.owned_row_update(
            ids[1:].reshape(-1), i_table, opt_state['mu'][ITEM_TABLE],
            opt_state['nu'][ITEM_TABLE], grads[1:].reshape(-1, dim + 1), t,
            learning_rate, l2, mesh, replicated)
        return mesh.all_reduce(local_loss.detach(), axes)

    return step
