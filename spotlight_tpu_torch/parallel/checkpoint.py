"""Sharded checkpoints of training state, through ``torch.distributed.checkpoint``.

Counterpart of ``spotlight_tpu/parallel/checkpoint.py`` (orbax there).
:mod:`spotlight_tpu_torch.utils.serialization` pickles a whole estimator,
and for a model trained on a mesh it gathers every table onto each rank
first.  This module is the scale path: each rank writes its own blocks of
the tables and their moments, and reads back only the rows its layout
holds, so no table passes through a collective.

What is saved is the JAX package's ``{'params', 'opt_state', 'key'}``:

- ``params``: the network's ``named_parameters()``;
- ``opt_state``: the optimizer state of either engine (the dense
  ``utils.training.Adam`` state with its host int ``count``, the lazy
  ``{'mu', 'nu', 't'}``, or the sequence lazy engine's ``{'table', 'tower',
  't'}``); host numbers are stored as 0-d tensors and come back as they
  were;
- ``generator``: the estimator's ``torch.Generator`` state (every rank's
  is the same).

On a mesh of several ranks every rank calls alike (SPMD).  A row-sharded
leaf (its spec in ``_param_specs`` or ``_opt_specs``) is handed to
``torch.distributed.checkpoint`` (DCP) as a ``DTensor`` of the rank's block
over the grid (``Mesh.device_mesh``), ``Replicate()`` over ``'data'`` and
``Shard(0)`` over ``'model'``, so the file holds the whole padded table
once, each block written by one of its replicas; DCP takes a plain tensor
for replicated and writes it once.  (Handed plain per-rank blocks under one
key, DCP would keep one rank's and drop the others without a word.)  A
model with no mesh, or a mesh of one rank, is saved and restored without
the process group (``no_dist=True``), so a one-device restore in rank 0 of
a larger job waits for no other rank.

Usage::

    from spotlight_tpu_torch.parallel import checkpoint

    checkpoint.save_state(path, model)           # params + opt state + generator
    checkpoint.restore_state(path, model)        # in-place restore
"""

from __future__ import annotations

import os
import shutil
import warnings

import torch
import torch.distributed as dist

from spotlight_tpu_torch.parallel.mesh import BOTH
from spotlight_tpu_torch.parallel.sharding import PartitionSpec, shard_params

_SEPARATOR = '/'


def _flatten(tree, prefix=(), out=None):
    """``{'a/b/c': leaf}`` of nested dicts, lists and tuples (a
    ``PartitionSpec`` is a leaf)."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, prefix + (str(key),), out)
    elif (isinstance(tree, (list, tuple))
          and not isinstance(tree, PartitionSpec)):
        for index, value in enumerate(tree):
            _flatten(value, prefix + (str(index),), out)
    else:
        out[_SEPARATOR.join(prefix)] = tree
    return out


def _with_scalars(tree, values, prefix=()):
    """``tree`` with its host-number leaves replaced by ``values`` (by flat
    key); its tensors are kept (restored in place)."""
    if isinstance(tree, dict):
        return {key: _with_scalars(value, values, prefix + (str(key),))
                for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_scalars(value, values, prefix + (str(i),))
                          for i, value in enumerate(tree))
    return values.get(_SEPARATOR.join(prefix), tree)


def _state(model):
    """The flat training state: tensors (parameters detached, sharing
    their storage), host numbers and the generator's state."""
    state = _flatten({'params': {name: p.detach() for name, p in
                                 model._net.named_parameters()},
                      'opt_state': model._opt_state})
    state['generator'] = model._generator.get_state()
    return state


def _specs(model):
    """The flat spec of every leaf of :func:`_state`, or None when the
    model holds whole tables on every rank (no mesh, a mesh of one rank,
    or no specs yet)."""
    if not _distributed(model) or model._param_specs is None:
        return None
    specs = _flatten({'params': model._param_specs,
                      'opt_state': model._opt_specs})
    specs['generator'] = ()
    return specs


def _distributed(model):
    mesh = model._mesh
    return mesh is not None and mesh.size(BOTH) > 1


def _sharded_axis(spec):
    return spec[0] if spec else None


def _global_shape(leaf, spec, mesh):
    """The shape of the whole (padded) leaf of which ``leaf`` is the rank's
    part."""
    if not torch.is_tensor(leaf):
        return ()
    shape = tuple(leaf.shape)
    axis = _sharded_axis(spec)
    if axis is None:
        return shape
    return (shape[0] * mesh.shape[axis],) + shape[1:]


def _dcp_leaf(leaf, spec, mesh):
    """What DCP is handed for a leaf: a ``DTensor`` of a row-sharded
    block over the grid, the tensor itself when replicated, a 0-d tensor
    for a host number."""
    if not torch.is_tensor(leaf):
        return torch.tensor(leaf)
    axis = _sharded_axis(spec)
    if axis is None:
        return leaf
    from torch.distributed.tensor import DTensor, Replicate, Shard

    device_mesh = mesh.device_mesh()
    placements = [Shard(0) if name == axis else Replicate()
                  for name in device_mesh.mesh_dim_names]
    return DTensor.from_local(
        leaf, device_mesh, placements, run_check=False,
        shape=torch.Size(_global_shape(leaf, spec, mesh)),
        stride=leaf.stride())


def _dcp(call, state, path, model=None):
    """``dcp.save`` or ``dcp.load`` of ``state`` at ``path`` over the
    grid's process group when ``model`` is on a mesh of several ranks, else
    in this process alone (whose warning that it assumes so is dropped)."""
    if model is not None and _distributed(model):
        return call(state, checkpoint_id=path,
                    process_group=model._mesh.groups[BOTH])
    with warnings.catch_warnings():
        warnings.filterwarnings('ignore', message='torch.distributed is '
                                'disabled')
        return call(state, checkpoint_id=path, no_dist=True)


def save_state(path, model, force=True):
    """Write the model's training state (parameters, optimizer moments and
    step counts, the generator's state) as a DCP checkpoint directory.  On
    a mesh every rank calls alike and writes its own blocks; a table is
    stored once, whole and padded as the layout pads it.  ``force``
    replaces an existing ``path``; without it an existing path raises."""
    path = os.path.abspath(path)
    if not model._initialized:
        raise ValueError('Cannot checkpoint an unfitted model.')
    import torch.distributed.checkpoint as dcp

    distributed = _distributed(model)
    group = model._mesh.groups[BOTH] if distributed else None
    exists = os.path.exists(path)
    if distributed:
        # Every rank has seen the path before one removes it.
        dist.barrier(group=group)
    if exists:
        if not force:
            raise ValueError('Destination {} already exists.'.format(path))
        if not distributed or dist.get_rank(group) == 0:
            shutil.rmtree(path)
    if distributed:
        dist.barrier(group=group)
    state, specs = _state(model), _specs(model) or {}
    _dcp(dcp.save, {key: _dcp_leaf(leaf, specs.get(key), model._mesh)
                    for key, leaf in state.items()}, path, model)
    return path


def restore_state(path, model):
    """Restore training state in place.

    The model must already be initialized (so its network, optimizer state
    and, on a mesh, their specs exist); values are replaced with the
    checkpointed ones, laid out as the model's current layout lays them
    out, which may differ from the layout at save time.

    Where the stored shapes equal the model's padded shapes, each rank
    reads only its blocks (DCP reshards a ``Shard(0)`` layout of the same
    whole shape).  Where they differ (padding depends on the model-axis
    count: 150 rows are 152 at four shards, 150 at two), the layouts are
    reconciled leaf by leaf as the JAX package does: the stored leaves are
    read to host memory, their leading dimension cut or zero-padded to the
    model's, and each rank keeps its block.  Dropped rows must be zero,
    which shard padding always is (real rows are ``[0, num_embeddings)``
    in every layout, padding rows take no update); a non-zero dropped row,
    or any other difference of shape, raises ``ValueError`` before the
    model is touched.  Values are cast to the model's dtypes (a bfloat16
    table).  A checkpoint of another structure (a dense optimizer state
    onto a lazy model, or the reverse) raises ``ValueError``.

    Afterwards the parameter version moves on and the cached item factors,
    catalogue blocks and epoch functions are dropped, so no metric scores
    stale factors; step counts come back as host ints, and the generator
    continues the saved stream.
    """
    path = os.path.abspath(path)
    if not model._initialized:
        raise ValueError('Initialize the model (e.g. via fit on one batch '
                         'or _initialize) before restoring.')
    import torch.distributed.checkpoint as dcp

    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    state, specs = _state(model), _specs(model) or {}
    mesh = model._mesh
    shapes = {key: _global_shape(leaf, specs.get(key), mesh)
              for key, leaf in state.items()}
    if _shapes_match(stored, shapes):
        loaded = {key: _dcp_leaf(leaf, specs.get(key), mesh)
                  for key, leaf in state.items()}
        _dcp(dcp.load, loaded, path, model)
        # The tensors were loaded in place; the host numbers and the
        # generator's state are installed.
        values = {key: value for key, value in loaded.items()
                  if not torch.is_tensor(state[key])
                  or key == 'generator'}
    else:
        values = _restore_cross_layout(path, state, specs, shapes, stored,
                                       mesh)
    _install(model, state, values)
    return model


def _shapes_match(stored, shapes):
    """True when every stored leaf's shape equals the model's.

    A checkpoint whose structure differs from the model's (a dense
    optimizer state against a ``sparse=True`` model's ``{mu, nu, t}``, or
    the reverse, another representation) cannot be reconciled at all, and
    raises."""
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    if set(stored) != set(shapes) or not all(
            isinstance(meta, TensorStorageMetadata)
            for meta in stored.values()):
        missing = sorted(set(shapes) - set(stored))
        extra = sorted(set(stored) - set(shapes))
        raise ValueError(
            'Checkpoint structure does not match the model (missing {}, '
            'unexpected {}). The checkpoint was saved from a different '
            'engine configuration (e.g. sparse=True vs a dense optimizer '
            'state, or a different representation); construct the model '
            'with the same settings it was saved with before restoring.'
            .format(missing, extra))
    return all(tuple(stored[key].size) == shape
               for key, shape in shapes.items())


def _restore_cross_layout(path, state, specs, shapes, stored, mesh):
    """The leaves of a checkpoint whose padded table shapes differ from the
    model's: read whole to host memory (every rank alike, without the
    process group), each leading dimension cut or zero-padded to the
    model's whole shape, cast to the model's dtype and cut to the rank's
    block.  Returns ``{key: value}``; raises before anything is
    installed."""
    import torch.distributed.checkpoint as dcp

    host = {key: torch.empty(tuple(meta.size), dtype=meta.properties.dtype)
            for key, meta in stored.items()}
    _dcp(dcp.load, host, path)
    values = {}
    for key, leaf in state.items():
        value = host[key]
        if torch.is_tensor(leaf):
            value = _adapt(value, shapes[key]).to(leaf.dtype)
        values[key] = value
    sharded = [key for key in values
               if _sharded_axis(specs.get(key)) is not None]
    values.update(shard_params({key: values[key] for key in sharded},
                               {key: specs[key] for key in sharded}, mesh))
    return values


def _adapt(value, shape):
    """``value`` with its leading dimension cut or zero-padded to
    ``shape``; only shard padding differs between layouts."""
    if tuple(value.shape) == shape:
        return value
    if (value.dim() != len(shape) or value.dim() < 1
            or tuple(value.shape[1:]) != shape[1:]):
        raise ValueError(
            'Checkpoint leaf of shape {} cannot be adapted to {}: only '
            'leading-dimension (shard padding) differences are '
            'reconcilable.'.format(tuple(value.shape), shape))
    rows = shape[0]
    if value.shape[0] > rows:
        if torch.any(value[rows:] != 0):
            raise ValueError(
                'Cross-layout restore would drop non-zero rows ({} -> {}): '
                'the checkpoint holds more real rows than the model.'
                .format(tuple(value.shape), shape))
        return value[:rows]
    return torch.cat([value, value.new_zeros(
        (rows - value.shape[0],) + tuple(value.shape[1:]))])


def _install(model, state, values):
    """Copy the restored tensors into the model's (in place, on their
    devices), put back the host numbers and the generator's state, and
    drop what was computed from the old parameters."""
    scalars = {}
    for key, leaf in state.items():
        value = values.get(key, leaf)
        if key == 'generator':
            model._generator.set_state(value)
        elif torch.is_tensor(leaf):
            if value is not leaf:
                leaf.copy_(value)
        else:
            scalars[key.split(_SEPARATOR, 1)[1]] = type(leaf)(value.item())
    model._opt_state = _with_scalars(model._opt_state, scalars)
    model._params_version += 1
    model._item_factor_cache = None
    model._shard_catalog_cache = None
    model._epoch_fn_cache = {}
