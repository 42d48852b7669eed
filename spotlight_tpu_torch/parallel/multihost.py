"""Multi-process (multi-host) training support.

Counterpart of ``spotlight_tpu/parallel/multihost.py``.  One process a
rank, every process running the same program (SPMD): the mesh spans every
rank of the default process group (:func:`~spotlight_tpu_torch.parallel.
make_mesh`), NCCL between cards, gloo for CPU ranks or several ranks on one
card (NCCL refuses two ranks on one GPU).

Typical use::

    from spotlight_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize()                  # torchrun's environment
    mesh = make_mesh(model=8)               # spans every rank
    batch = multihost.global_batch_array(mesh, local_rows)
    model = ImplicitFactorizationModel(mesh=mesh)
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend='nccl'):
    """Join the default ``torch.distributed`` process group, once per
    process, before any mesh is made.

    With every argument None the group is read from the environment that
    ``torchrun`` sets (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  Otherwise ``coordinator_address``
    (``'host:port'`` or ``'tcp://host:port'``, rank 0's) and the world's
    ``num_processes`` and this ``process_id`` name it.  ``backend`` is
    ``'nccl'`` (one card a rank; the rank's card, ``LOCAL_RANK`` or the
    rank modulo the cards, becomes its current device) or ``'gloo'`` (CPU
    ranks, or several ranks on one card).
    """
    if coordinator_address is None:
        init_method = 'env://'
    elif '://' in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = 'tcp://' + coordinator_address
    kwargs = {}
    if num_processes is not None:
        kwargs['world_size'] = num_processes
    if process_id is not None:
        kwargs['rank'] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if backend == 'nccl':
        local = int(os.environ.get(
            'LOCAL_RANK', dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)


def is_primary():
    """True on rank 0, and in a process with no group (use it to gate
    logging and single-writer output)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_batch_array(mesh, host_local, axis='data'):
    """Assemble the global batch from per-rank local batch slices.

    Each rank passes *its* slice of the batch (the data-parallel
    convention: disjoint per-rank input pipelines along ``axis``; the ranks
    of one coordinate pass the same slice), and every rank gets the whole
    batch on its device, the slices concatenated in the order of the
    ranks' coordinates along ``axis``: ``mesh.size(axis) * local_rows``
    rows, the values of the JAX package's global array.
    """
    local = torch.as_tensor(np.asarray(host_local), device=mesh.device)
    return mesh.all_gather(local, axis)
