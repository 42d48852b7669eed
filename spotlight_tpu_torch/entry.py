"""Single-device entry point: a forward step of the flagship model.

Counterpart of ``entry()`` in the repository's ``__graft_entry__.py``: an
``LSTMNet`` over 2,048 items (D=64) scoring every step of a ``(128, 64)``
batch of item sequences, and the whole catalogue from each sequence's final
state (the training path's forward and the serving path's scores).  The
multi-device dry run waits for the distributed layer.

Usage::

    from spotlight_tpu_torch.entry import entry
    fn, args = entry()                  # on the card
    predictions, catalog = fn(*args)    # (128, 64), (128, 2048)
"""

from __future__ import annotations

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
