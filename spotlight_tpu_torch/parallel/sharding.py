"""Row-sharded embedding tables, their exchanges and the row layout.

Counterpart of ``spotlight_tpu/parallel/sharding.py``.  A table is
**block-row-sharded** over an axis of the mesh: shard ``s`` owns the
contiguous rows ``[s * rows_per_shard, (s + 1) * rows_per_shard)``, so the
sharded layout is the dense one (padded with zero rows to a multiple of the
axis) cut into blocks.  A spec tree says, leaf by leaf, which axis a
parameter's rows shard over (``PartitionSpec('model', None)``) or that it
is replicated (``PartitionSpec()``).

:class:`ShardedEmbedding` and :class:`ShardedBloomEmbedding` wrap a dense
or bloom layer and hold its table as their own ``weight``, so a network's
parameter names stay those of the unsharded network.  The leading dimension
of ``weight`` picks the lookup, as the JAX package's trace-time shape does:

- the whole padded table (a loaded model, one device): a plain gather;
- this rank's block of ``rows_per_shard`` rows (a model trained on a
  mesh): a collective exchange over the mesh's ``axis``, SPMD, every rank
  of the axis looking up alike:

  - ``'psum'`` (:func:`_exchange_gather`): each rank gathers the rows it
    owns, the others read as -0.0 (the identity of the sum, so every row
    keeps its bits), and one all-reduce over the axis assembles them.  Its
    backward is the identity, the transpose JAX gives ``psum`` over an axis
    the loss is replicated on: each owner's rows take the cotangent once
    (``torch.distributed.nn``'s all-reduce would all-reduce the cotangent
    too and scale the table gradients by the axis size);
  - ``'alltoall'`` (:func:`alltoall_lookup`): ids travel to their owners,
    rows come back, and the backward runs the reverse all-to-all;
  - ``'alltoall_cf'`` (:func:`alltoall_capacity_lookup`): the same for
    ids that differ from rank to rank, packed into per-owner buckets.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spotlight_tpu_torch.ops.embeddings import FusedBiasEmbedding
from spotlight_tpu_torch.ops.hashing import bloom_hash

EXCHANGES = ('psum', 'alltoall', 'alltoall_cf')


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


def _padded(weight, rows):
    """``weight`` (detached) with zero rows appended up to ``rows``."""
    weight = weight.detach()
    pad = rows - weight.shape[0]
    if pad:
        weight = torch.cat([weight, weight.new_zeros(
            (pad,) + tuple(weight.shape[1:]))])
    return weight


class _ShardedTable(nn.Module):
    """The state and checks the two sharded layers share."""

    def __init__(self, weight, axis, num_shards, exchange, mesh):
        super().__init__()
        if exchange not in EXCHANGES:
            raise ValueError('exchange must be one of {} (got {!r})'.format(
                EXCHANGES, exchange))
        self.axis = axis
        self.num_shards = num_shards
        self.exchange = exchange
        self.mesh = mesh
        self._table_rows = weight.shape[0]
        self.weight = nn.Parameter(_padded(weight, self.padded_rows))

    @property
    def padded_rows(self):
        return rows_per_shard(self._table_rows,
                              self.num_shards) * self.num_shards

    @property
    def holds_block(self):
        """Whether ``weight`` is this rank's block (a mesh-trained table)
        rather than the whole padded table."""
        return self.weight.shape[0] != self.padded_rows

    def spec(self):
        """PartitionSpec for this layer's parameters."""
        return {'weight': PartitionSpec(self.axis, None)}

    def _gather(self, rows):
        """Rows of the table (global indices): a plain gather of the whole
        table, or the exchange of a block."""
        weight = self.weight
        if weight.shape[0] == self.padded_rows:
            return F.embedding(rows, weight)
        local_rows = self.padded_rows // self.num_shards
        if weight.shape[0] != local_rows:
            raise ValueError(
                '{} saw table with {} rows; expected global {} or per-shard '
                '{}'.format(type(self).__name__, weight.shape[0],
                            self.padded_rows, local_rows))
        if self.mesh is None:
            raise RuntimeError('a block of a sharded table looks up through '
                               'its mesh, and this layer has none')
        return _exchange_gather(self.mesh, weight, rows, self.axis,
                                self.exchange)

    def __getstate__(self):
        # The mesh holds this process's groups: a pickled layer has none.
        state = dict(self.__dict__)
        state['mesh'] = None
        return state


class ShardedEmbedding(_ShardedTable):
    """A row-sharded wrapper around a dense embedding layer.

    Parameters
    ----------
    inner : ScaledEmbedding, ZeroEmbedding or FusedBiasEmbedding
        The wrapped layer: its table (padded with zero rows to
        ``padded_rows``) becomes this layer's ``weight``; its padding row
        and its lookup's dtype are kept.
    axis : str
        Mesh axis name over which rows are sharded.
    num_shards : int
        Size of that mesh axis.
    exchange : str, 'psum' (default), 'alltoall' or 'alltoall_cf'
        Collective of a block's lookup (see the module docstring).
    mesh : :class:`~spotlight_tpu_torch.parallel.mesh.Mesh`, optional
        The rank's mesh, whose groups run the exchange; a layer holding the
        whole table needs none.
    """

    def __init__(self, inner, axis='model', num_shards=1, exchange='psum',
                 mesh=None):
        super().__init__(inner.weight, axis, num_shards, exchange, mesh)
        self.num_embeddings = inner.num_embeddings
        self.embedding_dim = inner.embedding_dim
        self.padding_idx = getattr(inner, 'padding_idx', None)
        # FusedBiasEmbedding's lookups return float32 whatever its dtype.
        self.upcast = isinstance(inner, FusedBiasEmbedding)

    def forward(self, ids):
        vectors = self.apply_raw(ids)
        return vectors.float() if self.upcast else vectors

    def apply_raw(self, ids):
        """Rows of ``ids`` in the table's dtype, the padding row read as
        zeros."""
        return self._masked(self._gather(ids), ids)

    def _masked(self, vectors, ids):
        if self.padding_idx is not None:
            vectors = torch.where((ids == self.padding_idx)[..., None],
                                  torch.zeros((), dtype=vectors.dtype,
                                              device=vectors.device),
                                  vectors)
        return vectors

    def block_rows(self):
        """This rank's block of the table as lookups read it (the padding
        row as zeros), in the table's dtype: the rows of ids ``index x
        rows`` on.  Padded rows past ``num_embeddings`` are zero."""
        rows = self.weight.shape[0]
        first = (self.mesh.index(self.axis) * rows if self.holds_block
                 else 0)
        ids = first + torch.arange(rows, device=self.weight.device)
        return self._masked(self.weight, ids)


class ShardedBloomEmbedding(_ShardedTable):
    """A bloom-compressed embedding table row-sharded over a mesh axis.

    The compressed table is a plain table of hashed rows, so it
    block-shards like any other: each of an id's ``k`` hashed rows is
    looked up through the same exchange as :class:`ShardedEmbedding`, row
    0 (the frozen padding and collision row, on shard 0) is masked to zero
    after the rows are assembled, so it never takes a gradient, and the
    ``k`` rows are summed in the order of the unsharded layer: the same
    bits as :class:`~spotlight_tpu_torch.ops.embeddings.BloomEmbedding`.

    Parameters are those of :class:`ShardedEmbedding`, ``inner`` a
    ``BloomEmbedding``.
    """

    def __init__(self, inner, axis='model', num_shards=1, exchange='psum',
                 mesh=None):
        super().__init__(inner.weight, axis, num_shards, exchange, mesh)
        self.num_embeddings = inner.num_embeddings
        self.embedding_dim = inner.embedding_dim
        self.padding_idx = inner.padding_idx
        self.num_hash_functions = inner.num_hash_functions
        self.compressed_num_embeddings = inner.compressed_num_embeddings

    def hashed_rows(self, ids):
        """int32 row indices of shape ``ids.shape + (num_hash_functions,)``
        (``BloomEmbedding.hashed_rows``)."""
        return bloom_hash(ids, self.num_hash_functions,
                          self.compressed_num_embeddings,
                          padding_idx=self.padding_idx)

    def forward(self, ids):
        return self._summed(self.hashed_rows(ids), self._gather)

    def _summed(self, rows, gather):
        vectors = gather(rows)
        if self.padding_idx is not None:
            # Row 0 is the frozen padding row: zero contribution, no grad.
            vectors = torch.where((rows == 0)[..., None],
                                  torch.zeros((), dtype=vectors.dtype,
                                              device=vectors.device),
                                  vectors)
        return vectors.sum(dim=-2)

    def block_rows(self):
        """The lookups of this rank's block of the id space,
        ``rows_per_shard(num_embeddings, num_shards)`` ids from ``index x
        that`` (past ``num_embeddings``, the last valid id stands in).
        The ranks ask for different ids, so a block's rows come through
        the capacity-factored exchange whatever the layer's exchange, its
        buckets as wide as the most rows any rank asks of one owner (read
        back once, and agreed over the axis): no id overflows."""
        if not self.holds_block:
            return self(torch.arange(self.num_embeddings,
                                     device=self.weight.device))
        count = rows_per_shard(self.num_embeddings, self.num_shards)
        first = self.mesh.index(self.axis) * count
        ids = (first + torch.arange(count, device=self.weight.device)).clamp(
            max=self.num_embeddings - 1)
        rows = self.hashed_rows(ids)
        per_owner = torch.bincount(
            rows.reshape(-1).long() // self.weight.shape[0],
            minlength=self.num_shards).max()
        capacity = int(self.mesh.all_gather(per_owner[None],
                                            self.axis).max())
        return self._summed(
            rows, lambda rows: alltoall_capacity_lookup(
                self.mesh, self.weight, rows, self.axis, capacity)[0])


class _SumOverAxis(torch.autograd.Function):
    """``mesh.all_reduce`` forward, the identity backward (JAX's transpose
    of ``psum`` over an axis the loss is replicated on)."""

    @staticmethod
    def forward(ctx, tensor, mesh, axis):
        return mesh.all_reduce(tensor, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _AllToAll(torch.autograd.Function):
    """``mesh.all_to_all`` forward; the backward sends each chunk's
    cotangent back where the chunk came from (the same exchange)."""

    @staticmethod
    def forward(ctx, tensor, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all(tensor, axis)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_to_all(grad, ctx.axis), None, None


def _exchange_gather(mesh, weight_local, ids, axis, exchange):
    """Rows of global ``ids`` from a block-row-sharded table through the
    configured exchange (shared by :class:`ShardedEmbedding` and
    :class:`ShardedBloomEmbedding`)."""
    if exchange == 'alltoall':
        return alltoall_lookup(mesh, weight_local, ids, axis=axis)
    if exchange == 'alltoall_cf':
        # Capacity-factored: ids are this rank's own batch slice (the
        # engine shards the batch over the model axis too).
        vectors, _overflow = alltoall_capacity_lookup(mesh, weight_local,
                                                      ids, axis=axis)
        return vectors

    # Vocab-parallel default: gather owned rows, sum partials.
    local_rows = weight_local.shape[0]
    start = mesh.index(axis) * local_rows
    owned = (ids >= start) & (ids < start + local_rows)
    local_ids = torch.where(owned, ids - start, 0)
    vectors = torch.where(owned[..., None], F.embedding(local_ids,
                                                        weight_local),
                          torch.full((), -0.0, dtype=weight_local.dtype,
                                     device=weight_local.device))
    return _SumOverAxis.apply(vectors, mesh, axis)


def _serve(mesh, weight_local, received, axis):
    """Rows of the requested ids this rank owns; -1 and foreign requests
    read as -0.0."""
    local_rows = weight_local.shape[0]
    start = mesh.index(axis) * local_rows
    owned = (received >= start) & (received < start + local_rows)
    local_idx = torch.where(owned, received - start, 0)
    return torch.where(owned[..., None], F.embedding(local_idx, weight_local),
                       torch.full((), -0.0, dtype=weight_local.dtype,
                                  device=weight_local.device))


def alltoall_lookup(mesh, weight_local, ids, axis='model'):
    """Row-sharded lookup through an explicit all-to-all id exchange.

    The three phases of the JAX package's function, every rank of ``axis``
    calling with the same ``ids`` (replicated):

    1. per-destination request buckets ``(num_shards, n)`` (ids not owned
       by the destination carry -1) are exchanged with ``all_to_all``;
    2. each rank serves the requests it owns from its block (the others
       read as -0.0);
    3. the served rows are exchanged back and summed over the sources
       (each id is owned by exactly one shard, so the sum keeps its bits).

    The backward sends each row's cotangent back through the reverse
    exchange to the owner's rows.

    Parameters
    ----------
    mesh : :class:`~spotlight_tpu_torch.parallel.mesh.Mesh`
    weight_local : (rows_per_shard, dim) this rank's block
    ids : int tensor of any shape, global row indices
    axis : mesh axis name

    Returns
    -------
    ``ids.shape + (dim,)`` embedding rows.
    """
    num_shards = mesh.size(axis)
    local_rows = weight_local.shape[0]
    flat = ids.reshape(-1).to(torch.int32)
    owner = flat // local_rows
    dest = torch.arange(num_shards, dtype=torch.int32,
                        device=flat.device)[:, None]
    requests = torch.where(owner[None, :] == dest, flat[None, :], -1)
    # Phase 1: requests[s] travels to shard s.
    received = mesh.all_to_all(requests, axis)
    # Phase 2: serve from the local block.
    served = _serve(mesh, weight_local, received, axis)
    # Phase 3: served[s'] returns to requester s'; sum over owners.
    returned = _AllToAll.apply(served, mesh, axis)
    vectors = returned.sum(dim=0)
    return vectors.reshape(tuple(ids.shape) + (weight_local.shape[1],))


def alltoall_capacity_lookup(mesh, weight_local, ids, axis='model',
                             capacity=None):
    """Capacity-factored row-sharded lookup for model-sharded batches.

    Each rank of ``axis`` holds its own ``ids`` (its slice of a batch
    sharded over the table axis too), so requests are packed into
    per-owner buckets of ``capacity`` slots before the exchange:

    1. stable-sort the ids by owning shard; id ``i`` of an owner's group
       takes slot ``i`` of that owner's bucket row (-1 pads);
    2. ``all_to_all`` the ``(S, capacity)`` buckets, serve them from the
       local block, ``all_to_all`` the rows back;
    3. unscatter the bucket rows to the ids' order.

    With ``capacity = ids.numel()`` (the default) no id overflows and the
    rows are exact for any input.  A smaller capacity drops the ids past
    their owner's bucket (their rows read as zeros) and counts them in the
    returned ``overflow``; callers that reduce the capacity must check it.
    The backward runs the reverse exchange onto the owners' rows.

    Parameters
    ----------
    mesh : :class:`~spotlight_tpu_torch.parallel.mesh.Mesh`
    weight_local : (rows_per_shard, dim)
    ids : int tensor of any shape, this rank's own
    axis : mesh axis name
    capacity : int, optional
        Bucket slots per destination shard.

    Returns
    -------
    (vectors, overflow) : ``ids.shape + (dim,)`` rows and an int32 scalar
        tensor, the count of ids past their owner's bucket.
    """
    num_shards = mesh.size(axis)
    local_rows = weight_local.shape[0]
    device = weight_local.device
    flat = ids.reshape(-1).to(torch.int32)
    n = flat.shape[0]
    if capacity is None:
        capacity = n
    owner = flat // local_rows

    # Stable sort by owner; rank within its owner's group = position -
    # group start.
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order]
    sorted_ids = flat[order]
    positions = torch.arange(n, device=device)
    rank = positions - torch.searchsorted(sorted_owner, sorted_owner)
    fits = rank < capacity
    overflow = (~fits).sum().to(torch.int32)
    # An overflowed id writes the one slot past the buckets, dropped.
    slot = torch.where(fits, sorted_owner.long() * capacity + rank,
                       num_shards * capacity)

    requests = torch.full((num_shards * capacity + 1,), -1,
                          dtype=torch.int32, device=device)
    requests[slot] = sorted_ids
    requests = requests[:-1].reshape(num_shards, capacity)

    received = mesh.all_to_all(requests, axis)
    served = _serve(mesh, weight_local, received, axis)
    returned = _AllToAll.apply(served, mesh, axis)

    # Unscatter: sorted position i reads its bucket slot, then the sort is
    # undone.
    payload = returned.reshape(num_shards * capacity, -1)
    sorted_vectors = torch.where(
        fits[:, None], payload[slot.clamp(max=num_shards * capacity - 1)],
        torch.zeros((), dtype=payload.dtype, device=device))
    inverse = torch.empty_like(order)
    inverse[order] = positions
    vectors = sorted_vectors[inverse]
    return (vectors.reshape(tuple(ids.shape) + (weight_local.shape[1],)),
            overflow)


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


def gather_params(params, specs, mesh):
    """The inverse of :func:`shard_params`: each row-sharded leaf's blocks
    gathered over its axis (every rank calls it alike); replicated leaves
    as they are."""
    def whole(value, spec):
        if not spec or spec[0] is None:
            return value
        return mesh.all_gather(value, spec[0])
    return _tree_map(whole, params, specs)


def held_part(net, name, tensor):
    """The part of a parameter ``tensor`` that ``net`` holds at ``name``:
    this rank's block of a whole table (padded or not) when the parameter
    is a sharded table's block, else ``tensor`` itself (a block already,
    or a replicated parameter)."""
    path = name.rpartition('.')[0]
    layer = net.get_submodule(path) if path else net
    if (not getattr(layer, 'holds_block', False)
            or tensor.shape[0] == layer.weight.shape[0]):
        return tensor
    return _block(_padded(tensor, layer.padded_rows),
                  layer.spec()['weight'], layer.mesh)


def holds_blocks(module):
    """Whether a sharded table in ``module`` (``module`` itself included)
    holds this rank's block of its rows (a table trained on a mesh) rather
    than the whole padded table: the one test of it, which the networks'
    catalogue factors, the metrics and ``save`` ask."""
    return any(getattr(layer, 'holds_block', False)
               for layer in module.modules())


def network_specs(net):
    """The spec of every parameter of ``net``, by its name in
    ``named_parameters()``: a sharded layer's ``spec()``, else
    replicated (the flat form of the JAX networks' ``param_specs``)."""
    specs = {}
    for name, _ in net.named_parameters():
        path, _, leaf = name.rpartition('.')
        module = net.get_submodule(path) if path else net
        specs[name] = (module.spec()[leaf]
                       if isinstance(module, _ShardedTable)
                       else PartitionSpec())
    return specs


def replicated_like(params):
    """A spec tree replicating every leaf."""
    return _tree_map(lambda _: PartitionSpec(), params)
