"""The row layout of tables over a mesh.

Counterpart of the table layout of ``spotlight_tpu/parallel/sharding.py``:
a table is **block-row-sharded** over an axis of the mesh, shard ``s``
owning the contiguous rows ``[s * rows_per_shard, (s + 1) *
rows_per_shard)``, so the sharded layout is the dense one cut into blocks.
A spec tree says, leaf by leaf, which axis a parameter's rows shard over
(``PartitionSpec('model', None)``) or that it is replicated
(``PartitionSpec()``).

The sharded embedding layers and their exchanges (``ShardedEmbedding``,
``ShardedBloomEmbedding``, ``alltoall_lookup``) come with the sharded
training engines.
"""

from __future__ import annotations


def rows_per_shard(num_rows, num_shards):
    return -(-num_rows // num_shards)


class PartitionSpec(tuple):
    """The mesh axis each dimension of a leaf shards over (None: not
    sharded), as ``jax.sharding.PartitionSpec``; ``PartitionSpec()``
    replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return 'PartitionSpec{}'.format(tuple(self))


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples, with the
    matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value, *(r[key] for r in rest))
                for key, value in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(_tree_map(fn, value, *(r[i] for r in rest))
                          for i, value in enumerate(tree))
    return fn(tree, *rest)


def _block(value, spec, mesh):
    """This rank's block of ``value`` under ``spec``: the rows its axis
    index owns, or the whole of a replicated leaf."""
    if not spec or spec[0] is None:
        if any(axis is not None for axis in spec):
            raise NotImplementedError(
                'only the rows of a table shard (got {!r})'.format(spec))
        return value
    axis = spec[0]
    shards = mesh.shape[axis]
    if value.shape[0] % shards:
        raise ValueError('{} rows do not divide over {} {} shards'.format(
            value.shape[0], shards, axis))
    rows = value.shape[0] // shards
    start = mesh.index(axis) * rows
    return value[start:start + rows]


def shard_params(params, specs, mesh):
    """This rank's part of a parameter tree under a matching spec tree:
    the rows its coordinate owns of each row-sharded leaf (a view) and the
    whole of each replicated one."""
    return _tree_map(lambda value, spec: _block(value, spec, mesh), params,
                     specs)


def replicated_like(params):
    """A spec tree replicating every leaf."""
    return _tree_map(lambda _: PartitionSpec(), params)
