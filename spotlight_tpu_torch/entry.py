"""Entry points: a forward step of the flagship model, and the multi-device
dry run.

Counterpart of the repository's ``__graft_entry__.py``:

- :func:`entry`: an ``LSTMNet`` over 2,048 items (D=64) scoring every step
  of a ``(128, 64)`` batch of item sequences, and the whole catalogue from
  each sequence's final state (the training path's forward and the serving
  path's scores);
- :func:`dryrun_multichip`: every distributed training and evaluation path
  on a mesh of ranks, once each, at tiny shapes.

Usage::

    from spotlight_tpu_torch.entry import entry
    fn, args = entry()                  # on the card
    predictions, catalog = fn(*args)    # (128, 64), (128, 2048)

and, from the command line, the dry run on ``N`` ranks (one process each,
joined through ``parallel.multihost.initialize``; gloo over CPU tensors
with ``--cpu``, else on the cards, gloo where ranks share one)::

    python -m spotlight_tpu_torch.entry N [--cpu]

which prints ``dryrun_multichip OK``.
"""

from __future__ import annotations

import os
import socket
import sys

import numpy as np
import torch

from spotlight_tpu_torch.factorization._base import resolve_device
from spotlight_tpu_torch.sequence import LSTMNet

NUM_ITEMS, EMBEDDING_DIM = 2048, 64
BATCH, LENGTH = 128, 64


def forward(net, sequences):
    """``(per-step scores of the sequences' own items (B, T), catalogue
    scores of the final states (B, num_items))``."""
    per_step, final = net.user_representation(sequences)
    return net.score(per_step, sequences), net.score_catalog(final)


def entry(device=None):
    """Return ``(fn, example_args)``: :func:`forward` and ``(net,
    sequences)``, with the network's parameters drawn from a seeded
    generator and the sequences from ``RandomState(0)`` (ids in [1,
    2048)).  ``device`` is the card unless the caller passes another
    (``'cpu'``); without a card the default raises."""
    device = resolve_device(device)
    net = LSTMNet(NUM_ITEMS, EMBEDDING_DIM,
                  generator=torch.Generator().manual_seed(0), device=device)
    sequences = torch.as_tensor(
        np.random.RandomState(0).randint(1, NUM_ITEMS, size=(BATCH, LENGTH)),
        dtype=torch.int64, device=device)
    return forward, (net, sequences)


def dryrun_multichip(n_devices, device=None):
    """Make an ``n_devices`` mesh of the ranks of the default process group
    (every rank calls alike), fit one epoch of each distributed training
    path on tiny shapes, check each model's ``predict`` shape, then run the
    streaming metrics on the mesh: the multi-device dry run of
    ``__graft_entry__.dryrun_multichip``, on ``torch.distributed``.

    The layout is 2 x (n/2) for n >= 4, 1 x 2 for 2, 1 x 1 for 1.  The fits:
    adaptive-hinge MF, the LSTM sequence model, a bloom-compressed
    ``BilinearNet`` (replicated bloom tables beside row-sharded biases),
    MF under ``'alltoall'`` and ``'alltoall_cf'``, the LSTM under
    ``'alltoall_cf'``, and the lazy (``sparse=True``) MF, LSTM and
    ``'alltoall_cf'`` MF.  ``evaluation.MATERIALIZE_ROUTES`` must not move
    during the metrics (the JAX package's ``FALLBACK_COUNTS``).
    ``device`` is every rank's device (``'cpu'``); by default rank ``r``
    works on card ``r`` modulo the cards.
    """
    import torch.distributed as dist

    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.data import Interactions, SequenceInteractions
    from spotlight_tpu_torch.factorization import (BilinearNet,
                                                   ImplicitFactorizationModel)
    from spotlight_tpu_torch.ops import BloomEmbedding
    from spotlight_tpu_torch.parallel import make_mesh
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(
            'need a process group of {} ranks (parallel.multihost.'
            'initialize), have {}'.format(
                n_devices, dist.get_world_size() if dist.is_initialized()
                else 'none'))
    if n_devices >= 4:
        layout = (2, n_devices // 2)
    elif n_devices == 2:
        layout = (1, 2)
    else:
        layout = (1, 1)
    devices = None if device is None else [device] * n_devices
    mesh = make_mesh(*layout, devices=devices)

    rs = np.random.RandomState(0)
    batch_size = 8 * mesh.shape['data']
    n = 4 * batch_size
    interactions = Interactions(rs.randint(0, 37, n), rs.randint(0, 53, n),
                                num_users=37, num_items=53)
    sequences = rs.randint(1, 53, size=(2 * batch_size, 6))
    seq_data = SequenceInteractions(sequences, num_items=53)
    cf_batch = batch_size * mesh.shape['model']

    def fit_mf(**kwargs):
        settings = dict(loss='bpr', embedding_dim=16, n_iter=1,
                        batch_size=batch_size, mesh=mesh,
                        random_state=np.random.RandomState(0))
        settings.update(kwargs)
        model = ImplicitFactorizationModel(**settings).fit(interactions)
        assert model.predict(0).shape == (53,)
        return model

    def fit_lstm(**kwargs):
        settings = dict(loss='bpr', representation='lstm', embedding_dim=16,
                        n_iter=1, batch_size=batch_size, mesh=mesh,
                        random_state=np.random.RandomState(0))
        settings.update(kwargs)
        model = ImplicitSequenceModel(**settings).fit(seq_data)
        assert model.predict(sequences[0]).shape == (53,)
        return model

    # Row-sharded user and item tables, the batch over 'data'.
    model = fit_mf(loss='adaptive_hinge')
    # The item table sharded, the LSTM tower replicated.
    fit_lstm()
    # Bloom tables replicated beside row-sharded bias tables.
    generator = torch.Generator().manual_seed(0)
    fit_mf(representation=BilinearNet(
        37, 53, 16,
        user_embedding_layer=BloomEmbedding(37, 16, compression_ratio=0.5,
                                            generator=generator),
        item_embedding_layer=BloomEmbedding(53, 16, compression_ratio=0.5,
                                            generator=generator),
        generator=generator))
    fit_mf(exchange='alltoall')
    # The capacity-factored exchange: the batch over both axes.
    fit_mf(exchange='alltoall_cf', batch_size=cf_batch)
    fit_lstm(exchange='alltoall_cf', batch_size=cf_batch)
    # The lazy engines: row-sharded tables and moments, P1 on each rank's
    # rows.
    assert fit_mf(sparse=True)._lazy
    assert fit_lstm(sparse=True)._lazy
    assert fit_mf(sparse=True, exchange='alltoall_cf',
                  batch_size=cf_batch)._lazy

    # The sharded streaming metrics, through the kernels on each rank's
    # block of the catalogue; none may take the materialize route.
    routes = evaluation.MATERIALIZE_ROUTES
    mrr = evaluation.mrr_score(model, interactions, train=interactions,
                               streaming=True)
    assert mrr.shape[0] > 0 and np.all(mrr > 0)
    precision, recall = evaluation.precision_recall_score(
        model, interactions, k=5, streaming=True)
    assert precision.shape == recall.shape == mrr.shape
    assert evaluation.MATERIALIZE_ROUTES == routes, (
        'sharded streaming evaluation took the materialize route {} times'
        .format(evaluation.MATERIALIZE_ROUTES - routes))


def _dryrun_rank(rank, n_devices, address, backend, device):
    """One rank of the command line's dry run."""
    import torch.distributed as dist

    from spotlight_tpu_torch.parallel import multihost

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    multihost.initialize(address, n_devices, rank, backend=backend)
    try:
        dryrun_multichip(n_devices, device)
    finally:
        dist.destroy_process_group()


def main():
    """``python -m spotlight_tpu_torch.entry [N] [--cpu]``: the dry run on
    ``N`` ranks (8 by default), spawned here and joined over TCP on a free
    local port; a failed rank fails the run."""
    args = sys.argv[1:]
    cpu = '--cpu' in args
    args = [arg for arg in args if arg != '--cpu']
    n_devices = int(args[0]) if args else 8
    if cpu:
        backend, device = 'gloo', 'cpu'
    else:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device is available; pass --cpu to '
                               'run the ranks on the CPU')
        # NCCL takes one card a rank; ranks sharing a card go through gloo.
        backend = ('nccl' if n_devices <= torch.cuda.device_count()
                   else 'gloo')
        device = None
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.spawn(
        _dryrun_rank, args=(n_devices, 'tcp://localhost:{}'.format(port),
                            backend, device),
        nprocs=n_devices, join=True)
    print('dryrun_multichip OK')


if __name__ == '__main__':
    main()
