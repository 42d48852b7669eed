"""Data-parallel training on a mesh, with row-sharded tables.

Counterpart of ``spotlight_tpu/parallel/training.py``.  Every rank is one
process, and every rank runs the same steps (SPMD):

- the minibatch is sharded over ``'data'`` (over both axes for the
  capacity-factored exchange): every rank draws the whole batch's
  permutation and negatives from its estimator's generator, seeded alike,
  and keeps its contiguous slice (:func:`batch_rows`);
- embedding tables are row-sharded over ``'model'``: a rank holds its
  block of each table and of its Adam moments, and looks rows up through
  the exchange of :mod:`spotlight_tpu_torch.parallel.sharding`; the
  network's other parameters are replicated;
- the masked-mean loss divides each rank's local sum by the **global**
  mask count (an all-reduce over the batch axes), so the per-example
  cotangents are those of one device;
- gradients are then reduced by JAX's three calculi (:func:`build_step`),
  and the port's ``Adam`` updates each rank's blocks in place.

The row-sparse (lazy) engines share two helpers here: the role-ordered
gather of a step's ids and gradient rows over the batch axes
(:func:`gather_roles`), and the update of the rows a rank owns
(:func:`owned_row_update`), P1 on its blocks.

JAX runs the steps of an epoch in one ``lax.scan``
(``epoch_scan_distributed``); the port runs them from
``utils.training.run_epoch``, one step a batch.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows
from spotlight_tpu_torch.parallel.mesh import BOTH
from spotlight_tpu_torch.parallel.sharding import (PartitionSpec,
                                                   network_specs,
                                                   shard_params)
from spotlight_tpu_torch.utils import training


def opt_specs_like(opt_state, params, param_specs):
    """Build a PartitionSpec tree for optimizer state by structure-matching
    against the parameter tree.

    Optimizer moments (Adam's ``mu`` and ``nu``) are dicts with exactly the
    parameters' names and inherit the parameters' specs wholesale; every
    other leaf (the step count) replicates.  Matching on structure, not
    leaf shapes, cannot mis-shard a dense parameter that happens to share a
    table's shape."""
    names = set(params)

    def assign(subtree):
        if isinstance(subtree, dict) and set(subtree) == names:
            return {name: param_specs[name] for name in subtree}
        if isinstance(subtree, dict):
            return {key: assign(value) for key, value in subtree.items()}
        if isinstance(subtree, (list, tuple)):
            return type(subtree)(assign(value) for value in subtree)
        return PartitionSpec()

    return assign(opt_state)


def batch_axes(exchange):
    """The axes the batch shards over: both for the capacity-factored
    exchange, else ``'data'``."""
    return BOTH if exchange == 'alltoall_cf' else 'data'


def batch_rows(mesh, batch_size, exchange):
    """This rank's contiguous slice of a batch of ``batch_size`` rows."""
    axes = batch_axes(exchange)
    rows = batch_size // mesh.size(axes)
    start = mesh.index(axes) * rows
    return slice(start, start + rows)


def gather_roles(mesh, tensor, axes):
    """``tensor`` ``(S, B_local, ...)`` of every rank of ``axes``,
    concatenated along its batch dimension (1): ``(S, B, ...)``, each role
    (positives, then each negative column) in the order of the global batch
    (JAX's ``all_gather(..., axis=1, tiled=True)``).  ``Mesh.all_gather``
    concatenates along dimension 0, so the ranks' parts are put back in
    role order after it."""
    parts = mesh.all_gather(tensor, axes)
    ranks = mesh.size(axes)
    shape = tuple(tensor.shape)
    return parts.reshape((ranks,) + shape).transpose(0, 1).reshape(
        (shape[0], ranks * shape[1]) + shape[2:])


def owned_row_update(ids, table, mu, nu, grad_rows, t, learning_rate, l2,
                     mesh, replicated=False):
    """:func:`~spotlight_tpu_torch.ops.lazy_adam.sparse_adam_rows` on the
    rows of this rank's block ``table`` (and its moments) that it owns:
    every global id outside ``[start, start + local_rows)`` goes to the
    sentinel ``local_rows``, which P1 skips (JAX's
    ``_owned_row_update``).  The foreign ids are one run at the end of the
    sort.  A ``replicated`` table is whole on every rank, which owns every
    row of it."""
    if replicated:
        return sparse_adam_rows(ids, table, mu, nu, grad_rows, t,
                                learning_rate, l2)
    local_rows = table.shape[0]
    start = mesh.index('model') * local_rows
    local = ids - start
    local = torch.where((local >= 0) & (local < local_rows), local,
                        local_rows)
    return sparse_adam_rows(local, table, mu, nu, grad_rows, t,
                            learning_rate, l2)


def dense_step(model, elems_fn):
    """An estimator's dense-engine ``step(opt_state, batch, negatives)``:
    :func:`build_step` on its mesh, else the single-device step."""
    if model._mesh is None:
        return training.build_dense_step(model._net, elems_fn,
                                         model._optimizer)
    return build_step(model._net, elems_fn, model._optimizer, model._mesh,
                      model._param_specs, model._exchange)


def shard_network(net, mesh, exchange, device):
    """(network, specs): ``net`` (its tables whole, drawn on the CPU) with
    its tables row-sharded over ``mesh``'s model axis (``net.sharded``, where
    it has one; else every parameter replicates), each parameter replaced
    by this rank's block of it on ``device``."""
    if hasattr(net, 'sharded'):
        net = net.sharded('model', mesh.shape['model'], exchange=exchange,
                          mesh=mesh)
    specs = network_specs(net)
    params = dict(net.named_parameters())
    blocks = shard_params(params, specs, mesh)
    with torch.no_grad():
        for name, param in params.items():
            param.data = blocks[name].to(device=device, copy=True)
    return net.to(device), specs


def reduce_grads(mesh, grads, reduce_over):
    """``grads`` (by name), each summed over its axis of ``reduce_over``:
    the gradients of an axis and dtype flattened into one buffer, one
    all-reduce each, in the order of ``grads`` (every rank alike).  Over
    an axis of one rank the sum is the gradient itself, and nothing is
    copied or sent."""
    buckets = {}
    for name, grad in grads.items():
        axis = reduce_over[name]
        if mesh.size(axis) > 1:
            buckets.setdefault((axis, grad.dtype), []).append(name)
    grads = dict(grads)
    for (axis, _), names in buckets.items():
        total = mesh.all_reduce(
            torch.cat([grads[name].reshape(-1) for name in names]), axis)
        parts = total.split([grads[name].numel() for name in names])
        for name, part in zip(names, parts):
            grads[name] = part.view(grads[name].shape)
    return grads


def build_step(net, elems_fn, optimizer, mesh, param_specs,
               exchange='psum'):
    """The mesh step, ``step(opt_state, batch, negatives) -> loss`` (a
    device scalar, replicated), the body of JAX's ``sharded_step``:
    ``batch`` and ``negatives`` are this rank's slice
    (:func:`batch_rows`), ``elems_fn(batch, negatives) -> (elementwise
    loss, mask)`` runs the network through its exchanges.

    The loss is the local sum over the global mask count.  Then, by
    exchange:

    - ``'psum'``: each owner's table rows take their cotangents once (the
      lookup's backward is the identity); every gradient is summed over
      ``'data'``;
    - ``'alltoall'``: every model rank computes the same loss, and its
      backward sends each row's cotangent to the owner, so the loss is
      divided by the model size first; table gradients are summed over
      ``'data'``, replicated ones over both axes;
    - ``'alltoall_cf'``: the batch is sharded over both axes, each row's
      cotangent reaches its owner once; table gradients are summed over
      ``'data'``, replicated ones over both axes.

    The reported loss is JAX's: the local losses summed over ``'data'``
    (times the model size for ``'alltoall'``), or over both axes for
    ``'alltoall_cf'``.  A parameter the loss does not reach gets a zero
    gradient, as JAX's ``grad`` gives it.  The gradients go through
    :func:`reduce_grads`: one all-reduce an axis, none over an axis of one
    rank.
    """
    axes = batch_axes(exchange)
    model_size = mesh.shape['model']
    reduce_over = {name: ('data' if exchange == 'psum' or 'model' in spec
                          else BOTH)
                   for name, spec in param_specs.items()}

    def step(opt_state, batch, negatives):
        params = dict(net.named_parameters())
        elems, mask = elems_fn(batch, negatives)
        mask = mask.to(elems.dtype)
        count = mesh.all_reduce(mask.sum(), axes)
        loss = (elems * mask).sum() / torch.clamp(count, min=1.0)
        if exchange == 'alltoall':
            # Every model rank computes this loss: its owners' rows take
            # model_size cotangents, which sum to the true one.
            loss = loss / model_size
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {name: torch.zeros_like(p) if g is None else g
                 for (name, p), g in zip(params.items(), grads)}
        optimizer.update(params, reduce_grads(mesh, grads, reduce_over),
                         opt_state)
        loss = loss.detach()
        if exchange == 'alltoall':
            return mesh.all_reduce(loss, 'data') * model_size
        return mesh.all_reduce(loss, axes)

    return step
