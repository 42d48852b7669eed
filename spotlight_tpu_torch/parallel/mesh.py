"""A ``(data, model)`` grid of ``torch.distributed`` ranks.

Counterpart of ``spotlight_tpu/parallel/mesh.py``.  JAX drives every device
of a mesh from one program; here each rank is a process of its own, and
every rank runs the same code (SPMD): the same calls, the same collectives
in the same order, and the same replicated result, as JAX's global view
returns.  Ranks are laid out row-major, rank ``r`` at
``(r // model, r % model)``, as ``np.asarray(devices).reshape(data, model)``
lays out JAX's devices.  The ``model`` group of a rank holds its row of the
grid (the ranks that share a user batch and split the catalogue), its
``data`` group its column (the ranks that hold the same catalogue block).

The collectives sum, gather or exchange along one axis, or over the whole
grid (``('data', 'model')``), on the tensors' own device: NCCL takes the
card's tensors, and gloo takes CPU tensors and CUDA tensors too (it copies
them through host memory itself), which is how several gloo ranks share
one card (NCCL refuses two ranks on one GPU).  Evaluation sends small
payloads ((B, T) scores or counts, (B, k) candidate lists); training sends
the looked-up rows, their exchanged ids and the gradients of the rank's
blocks.  :data:`COLLECTIVE_BYTES` counts what this rank hands each
collective.  Along an axis of one rank every collective is the identity, as
``jax.lax.psum`` over a one-device axis is: it returns its input, and
nothing is copied, sent or counted.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

#: Bytes of the tensors this process handed its collectives, by ``(op,
#: axis)``: ``op`` one of 'all_reduce', 'all_gather', 'all_to_all', ``axis``
#: 'data', 'model' or 'data,model'.  Zero it by assigning ``{}``, as the
#: kernels' launch counters are zeroed.
COLLECTIVE_BYTES = {}

#: The axes of the whole grid, the batch axes of the capacity-factored
#: exchange.
BOTH = ('data', 'model')


def _axis_key(axis):
    """A group's key in ``Mesh.groups``: an axis name, or BOTH."""
    if isinstance(axis, (tuple, list)):
        axis = tuple(axis)
        if len(axis) == 1:
            return axis[0]
        if sorted(axis) != sorted(BOTH):
            raise ValueError('unknown mesh axes {!r}'.format(axis))
        return BOTH
    return axis


def _count(op, axis, tensor):
    key = (op, axis if isinstance(axis, str) else ','.join(axis))
    COLLECTIVE_BYTES[key] = (COLLECTIVE_BYTES.get(key, 0)
                             + tensor.numel() * tensor.element_size())


class Mesh:
    """This rank's place in a ``(data, model)`` grid of ranks.

    Attributes
    ----------
    shape : dict
        ``{'data': data, 'model': model}``, as ``jax.sharding.Mesh.shape``.
    data_index, model_index : int
        This rank's coordinates in the grid.
    device : torch.device
        The device of this rank's work.
    groups : dict
        The ``torch.distributed`` group of each axis that holds this rank,
        and of the whole grid under ``('data', 'model')``.
    """

    def __init__(self, data, model, rank, device, groups):
        self.shape = {'data': data, 'model': model}
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self.device = device
        self.groups = groups
        self._device_mesh = None

    def __repr__(self):
        return 'Mesh(data={data}, model={model}, rank={rank}, {device})'.format(
            rank=self.rank, device=self.device, **self.shape)

    def device_mesh(self):
        """The grid as a ``torch.distributed`` ``DeviceMesh`` of dims
        ``('data', 'model')``, for ``DTensor``s of the ranks' blocks (the
        sharded checkpoints).  Made at the first call, which every rank
        makes alike (it makes the groups of both dims), and kept."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            grid = np.arange(self.size(BOTH)).reshape(self.shape['data'],
                                                      self.shape['model'])
            self._device_mesh = DeviceMesh(self.device.type, grid,
                                           mesh_dim_names=BOTH)
        return self._device_mesh

    def index(self, axis):
        """This rank's coordinate along ``axis``; along ``('data',
        'model')``, its row-major position in the grid."""
        axis = _axis_key(axis)
        if axis == BOTH:
            return self.rank
        return self.data_index if axis == 'data' else self.model_index

    def size(self, axis):
        """The number of ranks along ``axis`` (or both axes)."""
        axis = _axis_key(axis)
        if axis == BOTH:
            return self.shape['data'] * self.shape['model']
        return self.shape[axis]

    def all_reduce(self, tensor, axis):
        """The sum of ``tensor`` over the ranks of ``axis`` (an axis name or
        ``('data', 'model')``), on every one of them (``jax.lax.psum``);
        ``tensor`` itself is left as it was, and is what an axis of one rank
        returns."""
        axis = _axis_key(axis)
        if self.size(axis) == 1:
            return tensor
        total = tensor.clone(memory_format=torch.contiguous_format)
        _count('all_reduce', axis, total)
        dist.all_reduce(total, group=self.groups[axis])
        return total

    def all_gather(self, tensor, axis):
        """The ``tensor`` of every rank of ``axis``, concatenated along the
        first dimension in the order of the ranks' coordinates."""
        axis = _axis_key(axis)
        if self.size(axis) == 1:
            return tensor
        tensor = tensor.contiguous()
        _count('all_gather', axis, tensor)
        parts = [torch.empty_like(tensor) for _ in range(self.size(axis))]
        dist.all_gather(parts, tensor, group=self.groups[axis])
        return torch.cat(parts)

    def all_to_all(self, tensor, axis):
        """``jax.lax.all_to_all(tensor, axis, split_axis=0,
        concat_axis=0)``: the first dimension is cut into one chunk per rank
        of ``axis``, chunk ``j`` goes to the rank of coordinate ``j``, and
        the chunks received are concatenated in the order of the senders'
        coordinates.  One ``all_to_all_single``, on the tensor's device
        under either backend."""
        axis = _axis_key(axis)
        if self.size(axis) == 1:
            return tensor
        tensor = tensor.contiguous()
        if tensor.shape[0] % self.size(axis):
            raise ValueError('{} rows do not split over the {} ranks of {}'
                             .format(tensor.shape[0], self.size(axis), axis))
        _count('all_to_all', axis, tensor)
        out = torch.empty_like(tensor)
        dist.all_to_all_single(out, tensor, group=self.groups[axis])
        return out


def make_mesh(data=None, model=None, devices=None):
    """Build a ``(data, model)`` mesh over the ranks of the default process
    group.

    Every rank must call it, with the same sizes: it makes the groups of
    both axes with ``dist.new_group``, which every rank calls in one fixed
    order.

    Parameters
    ----------
    data, model : int, optional
        Axis sizes.  If only one is given, the other is inferred from the
        world size; if neither, every rank goes to the ``data`` axis.
    devices : list of torch.device or str, optional
        One device per rank, ``devices[rank]`` being this rank's.  By
        default rank ``r`` works on ``cuda:{r % device_count}``.

    Returns
    -------
    Mesh
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError('make_mesh needs an initialised default process '
                           'group (torch.distributed.init_process_group)')
    n = dist.get_world_size()
    rank = dist.get_rank()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass devices= '
                               "(for example ['cpu'] * world size)")
        devices = ['cuda:{}'.format(r % torch.cuda.device_count())
                   for r in range(n)]
    if len(devices) != n:
        raise ValueError('{} devices for a world of {} ranks'.format(
            len(devices), n))

    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        if n % model:
            raise ValueError('Device count {} not divisible by model={}'
                             .format(n, model))
        data = n // model
    elif model is None:
        if n % data:
            raise ValueError('Device count {} not divisible by data={}'
                             .format(n, data))
        model = n // data

    if data * model != n:
        raise ValueError('data * model = {} != {} devices'
                         .format(data * model, n))

    grid = np.arange(n).reshape(data, model)
    groups = {}
    # Every rank creates every group, rows then columns, then the whole
    # grid, in one order.
    for axis, lines in (('model', grid), ('data', grid.T)):
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    groups[BOTH] = dist.new_group(list(range(n)))
    return Mesh(data, model, rank, torch.device(devices[rank]), groups)
