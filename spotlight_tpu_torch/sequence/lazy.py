"""Row-sparse (lazy) Adam engine for the sequence models.

Counterpart of ``spotlight_tpu/sequence/lazy.py``: the
sequence analogue of :mod:`spotlight_tpu_torch.factorization.lazy` (see
there for torch-``SparseAdam`` semantics).  The item table's gradient is
taken with respect to the gathered rows, and its Adam moments update only
at the touched rows through
:func:`~spotlight_tpu_torch.ops.lazy_adam.sparse_adam_rows` (P1 on the
card, one launch a step), so the step's table cost does not grow with the
catalogue.  The dense tower (the LSTM, convolution or projection
parameters) keeps the dense engine's Adam.  The optimizer state is hybrid::

    {'table': {'mu': (N, D + 1) float32, 'nu': (N, D + 1) float32},
     'tower': the tower Adam's state (utils.training.Adam),
     't': int}

Above about 1M items the dense engine's whole-table Adam sweep dominates its
step; this engine keeps the exact (uncompressed) table competitive there.
It composes with ``table_dtype=bfloat16`` (bfloat16 storage, float32
moments and update math) and ``negative_sampling='in_batch'`` (the
negatives are batch rolls of the gathered positive rows: no negative
gather).  Selected with ``sparse=True`` on the sequence estimator (a
built-in representation in the fused layout, no custom optimizer).

On a mesh (the ``'psum'`` and ``'alltoall'`` exchanges; the estimator
trains dense under ``'alltoall_cf'``, as JAX's does) the item table and its
moments are row-sharded over ``'model'`` and the tower is replicated: the
factorization engine's mesh step (see
:mod:`spotlight_tpu_torch.factorization.lazy`) for the item rows, plus one
all-reduce over ``'data'`` of the tower's gradients
(``parallel.training.reduce_grads``) before its replicated Adam.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.embeddings import PADDING_IDX
from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows
from spotlight_tpu_torch.ops.losses import IMPLICIT_LOSSES
from spotlight_tpu_torch.ops.sampling import (inbatch_pair_weights,
                                              weighted_inbatch_elems)
from spotlight_tpu_torch.parallel import training as ptraining
from spotlight_tpu_torch.parallel.sharding import (PartitionSpec,
                                                   _exchange_gather,
                                                   holds_blocks)
from spotlight_tpu_torch.utils.training import masked_mean

ITEM_TABLE = 'item_embeddings.weight'


def tower_parameters(net):
    """Every parameter of ``net`` but the fused item table, by name."""
    return {name: p for name, p in net.named_parameters()
            if name != ITEM_TABLE}


def lazy_seq_adam_init(net, tower_optimizer):
    """The hybrid optimizer state: float32 moments shaped like the item
    table (float32 also for a bfloat16 table), the tower optimizer's state
    and the global step ``t``."""
    table = net.item_embeddings.weight

    def zeros32():
        return torch.zeros(table.shape, dtype=torch.float32,
                           device=table.device)

    return {'table': {'mu': zeros32(), 'nu': zeros32()},
            'tower': tower_optimizer.init(tower_parameters(net)),
            't': 0}


def lazy_seq_opt_specs(opt_state, params, param_specs):
    """The spec tree of the hybrid state on a mesh: the table's moments
    shard as the item table, the tower optimizer's state as the tower's
    parameters (``parallel.training.opt_specs_like``); ``t`` replicates."""
    table_spec = param_specs[ITEM_TABLE]
    tower = {name: value for name, value in params.items()
             if name != ITEM_TABLE}
    tower_specs = {name: spec for name, spec in param_specs.items()
                   if name != ITEM_TABLE}
    return {'table': {'mu': table_spec, 'nu': table_spec},
            'tower': ptraining.opt_specs_like(opt_state['tower'], tower,
                                              tower_specs),
            't': PartitionSpec()}


def _masked_rows(table, ids):
    """Fused rows of ``ids`` in float32, the padding id's rows zero (the
    read-side semantics of the item layer).  The mask is outside autograd,
    so the cotangents at padding positions are not zero: the step drops
    those ids before the row update."""
    rows = table[ids]
    rows = torch.where((ids == PADDING_IDX)[..., None],
                       torch.zeros((), dtype=rows.dtype, device=rows.device),
                       rows)
    return rows.float()


def _drop_pad(ids, num_rows):
    """The padding id routed to ``num_rows``, an id P1 skips, so the
    padding row and its moments stay zero."""
    return torch.where(ids == PADDING_IDX, num_rows, ids)


def build_lazy_step(net, loss, learning_rate, l2, num_negatives,
                    tower_optimizer, negative_sampling='uniform', mesh=None,
                    exchange='psum'):
    """The lazy engine's step for a fused-layout sequence representation:
    ``step(opt_state, batch, negatives) -> loss`` (a device scalar), with
    ``opt_state`` from :func:`lazy_seq_adam_init` (updated in place, ``t``
    included) and ``negatives`` the batch's ``(B, T)`` item ids
    (``(n, B, T)`` for ``adaptive_hinge``; None in-batch).  Nothing is read
    back to the host.

    On a ``mesh`` (``exchange`` 'psum' or 'alltoall') the network holds its
    block of the item table, ``batch`` and ``negatives`` are the rank's
    slice of the batch over ``'data'``, and the loss returned is the sum of
    the ranks' over ``'data'``, replicated (see the module docstring)."""
    dim = net.embedding_dim
    loss_func = IMPLICIT_LOSSES[loss]
    adaptive = loss == 'adaptive_hinge'
    n_neg = num_negatives if adaptive else 1
    in_batch = negative_sampling == 'in_batch'
    tower = tower_parameters(net)

    def step_elems(pos_rows, neg_rows, batch):
        """Elementwise loss (B, T) from float32 fused rows; ``neg_rows``
        ``(n, B, T, D + 1)``, None in-batch."""
        reprs, _ = net._user_repr_from_emb(pos_rows[..., :dim])
        positive = net._score_vectors(reprs, pos_rows[..., :dim],
                                      pos_rows[..., dim])
        if in_batch:
            negative = [net._score_vectors(
                reprs, torch.roll(pos_rows[..., :dim], s, dims=0),
                torch.roll(pos_rows[..., dim], s, dims=0))
                for s in range(1, n_neg + 1)]
        else:
            negative = [net._score_vectors(reprs, rows[..., :dim],
                                           rows[..., dim])
                        for rows in neg_rows]
        negative = torch.stack(negative, dim=0) if adaptive else negative[0]
        elems = loss_func(positive, negative, reduce=False)
        if in_batch:
            pair_weight = inbatch_pair_weights(batch['negative_weight'],
                                               negative, n_neg)
            elems = weighted_inbatch_elems(loss, elems, negative,
                                           pair_weight)
        return elems

    if mesh is not None:
        if exchange not in ('psum', 'alltoall'):
            raise ValueError("the sequence lazy engine looks rows up "
                             "through 'psum' or 'alltoall' on a mesh (got "
                             '{!r})'.format(exchange))
        return _mesh_step(net, step_elems, tower, learning_rate, l2, n_neg,
                          in_batch, tower_optimizer, mesh, exchange)

    def step(opt_state, batch, negatives):
        sequences = batch['sequences']                          # (B, T)
        opt_state['t'] += 1
        table = net.item_embeddings.weight.data
        pos_rows = _masked_rows(table, sequences).requires_grad_()
        rows = [pos_rows]
        ids = [sequences.reshape(-1)]
        if not in_batch:
            negatives = negatives.reshape((n_neg,) + sequences.shape)
            rows.append(_masked_rows(table, negatives).requires_grad_())
            ids.append(negatives.reshape(-1))
        mask = (sequences != PADDING_IDX) & (batch['mask'][:, None] > 0)
        with torch.enable_grad():
            loss_value = masked_mean(
                step_elems(pos_rows, None if in_batch else rows[1], batch),
                mask)
            grads = torch.autograd.grad(
                loss_value, rows + list(tower.values()), allow_unused=True)
        row_grads = torch.cat([g.reshape(-1, dim + 1)
                               for g in grads[:len(rows)]])
        sparse_adam_rows(_drop_pad(torch.cat(ids), table.shape[0]), table,
                         opt_state['table']['mu'], opt_state['table']['nu'],
                         row_grads, opt_state['t'], learning_rate, l2)
        tower_optimizer.update(
            tower, {name: torch.zeros_like(p) if g is None else g
                    for (name, p), g in zip(tower.items(),
                                            grads[len(rows):])},
            opt_state['tower'])
        return loss_value.detach()

    return step


def _mesh_step(net, step_elems, tower, learning_rate, l2, n_neg, in_batch,
               tower_optimizer, mesh, exchange):
    """The body of JAX's ``_build_distributed`` ``sharded_step``: the step
    of :func:`build_lazy_step` on a mesh."""
    dim = net.embedding_dim
    # A whole table (a model trained replicated): a plain gather, and every
    # rank owns every row.
    replicated = not holds_blocks(net.item_embeddings)

    def lookup(table, ids):
        # Outside autograd; the padding id's rows are zeroed after the
        # exchange.
        with torch.no_grad():
            rows = (table[ids] if replicated else
                    _exchange_gather(mesh, table, ids, 'model', exchange))
            rows = torch.where((ids == PADDING_IDX)[..., None],
                               torch.zeros((), dtype=rows.dtype,
                                           device=rows.device), rows)
        return rows.float().requires_grad_()

    def step(opt_state, batch, negatives):
        sequences = batch['sequences']                    # (B_local, T)
        opt_state['t'] += 1
        table = net.item_embeddings.weight.data
        rows = [lookup(table, sequences)]
        roles = [sequences[None]]
        if not in_batch:
            negatives = negatives.reshape((n_neg,) + sequences.shape)
            rows.append(lookup(table, negatives))
            roles.append(negatives)
        mask = ((sequences != PADDING_IDX)
                & (batch['mask'][:, None] > 0)).float()
        with torch.enable_grad():
            elems = step_elems(rows[0], None if in_batch else rows[1],
                               batch)
            count = mesh.all_reduce(mask.sum(), 'data')
            local_loss = (elems * mask).sum() / torch.clamp(count, min=1.0)
            grads = torch.autograd.grad(local_loss,
                                        rows + list(tower.values()),
                                        allow_unused=True)
        # (S, B_local, T) ids and (S, B_local, T, W) gradient rows.
        roles = torch.cat(roles)
        row_grads = torch.cat([grads[0][None]] + list(grads[1:len(rows)]))

        # The global occurrence stream in one device's order (positives,
        # then each negative column); the padding id is routed out of this
        # rank's rows in global coordinates, before the owned shift.
        ids = ptraining.gather_roles(mesh, roles, 'data').reshape(-1)
        row_grads = ptraining.gather_roles(mesh, row_grads,
                                           'data').reshape(-1, dim + 1)
        local_rows = table.shape[0]
        start = 0 if replicated else mesh.index('model') * local_rows
        ids = torch.where(ids == PADDING_IDX, start + local_rows, ids)
        ptraining.owned_row_update(
            ids, table, opt_state['table']['mu'], opt_state['table']['nu'],
            row_grads, opt_state['t'], learning_rate, l2, mesh, replicated)

        tower_grads = {name: torch.zeros_like(p) if g is None else g
                       for (name, p), g in zip(tower.items(),
                                               grads[len(rows):])}
        tower_optimizer.update(
            tower, ptraining.reduce_grads(mesh, tower_grads,
                                          dict.fromkeys(tower, 'data')),
            opt_state['tower'])
        return mesh.all_reduce(local_loss.detach(), 'data')

    return step
