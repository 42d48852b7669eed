"""Spotlight's ``ImplicitSequenceModel`` over a ``MixtureLSTMNet``.

Weights are the fused item table ``item_embeddings.weight``
``(N, D + 1)`` (row 0 the zero padding row), the LSTM's ``(D, 4D)``
products and biases and the mixture projection, made on the device from
the seed, one call a tensor.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import data
from benchmark.reference import sequence


def make_weights(cfg, seed, device):
    """Item factors N(0, 1) / D and biases N(0, 1) / D^1.5; the LSTM and
    the projection U(-1/sqrt(D), 1/sqrt(D)), torch's initialisation."""
    dim, mixtures = cfg['embedding_dim'], cfg['num_mixtures']
    generator = data.device_generator(seed, 'weights', device)
    table = torch.randn(cfg['num_items'], dim + 1, generator=generator,
                        device=device) / dim
    table[:, dim] *= dim ** -0.5
    table[0] = 0.0
    bound = 1.0 / math.sqrt(dim)
    shapes = {'lstm.w_ih': (dim, 4 * dim), 'lstm.w_hh': (dim, 4 * dim),
              'lstm.b_ih': (4 * dim,), 'lstm.b_hh': (4 * dim,),
              'projection.weight': (dim, 2 * mixtures * dim),
              'projection.bias': (2 * mixtures * dim,)}
    out = {'item_embeddings.weight': table}
    for name, shape in shapes.items():
        out[name] = (torch.rand(shape, generator=generator, device=device)
                     * 2 - 1) * bound
    return out


def build(cfg, weights, device, seed, n_iter):
    """The port's estimator around ``weights``, through its public
    constructor: a ``MixtureLSTMNet`` as ``representation`` with the
    weights copied in.  Not yet fitted."""
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel
    from spotlight_tpu_torch.sequence.representations import MixtureLSTMNet

    net = MixtureLSTMNet(cfg['num_items'], cfg['embedding_dim'],
                         num_mixtures=cfg['num_mixtures'],
                         sparse=cfg['sparse'], device=device)
    with torch.no_grad():
        for name, parameter in net.named_parameters():
            parameter.copy_(weights[name])
    return ImplicitSequenceModel(
        loss=cfg['loss'], representation=net,
        embedding_dim=cfg['embedding_dim'], n_iter=n_iter,
        batch_size=cfg['batch_size'], l2=cfg['l2'],
        learning_rate=cfg['learning_rate'], sparse=cfg['sparse'],
        random_state=np.random.RandomState(data.subseed(seed, 'model')
                                           % 2 ** 32),
        device=device)


def sequences(cfg, rows):
    from spotlight_tpu_torch.data import SequenceInteractions

    return SequenceInteractions(rows, num_items=cfg['num_items'])


def reference_scores(cfg, weights, rows, precision='float32'):
    """(B, N) reference scores of the next item after sequences ``rows``
    (B, L) (a device tensor)."""
    final = sequence.final_representation(weights, rows, precision)
    return sequence.catalogue_scores(weights, final, precision)


def serving(run):
    """Set-up of the ranking entries: the sequences, the port's model
    around the weights (initialised by a ``fit`` of no epochs on one batch
    of sequences), and the calls: ``rows_per_call`` sequences each, every
    one ranked on its last item after the rest."""
    cfg, device, traffic = run.cfg, run.device, run.traffic
    rows_all = data.sequences(cfg, run.seed, device)
    run.set_up_data()
    model = build(cfg, make_weights(cfg, run.seed, device), device,
                  run.seed, n_iter=0)
    model.fit(sequences(cfg, rows_all[:cfg['batch_size']]))
    pool = data.call_rows(np.arange(len(rows_all)),
                          np.ones(len(rows_all), np.int64),
                          traffic['rows_per_call'], traffic['pool_calls'],
                          run.seed)
    inputs = [sequences(cfg, rows_all[rows]) for rows in pool]
    shapes = [{'batch': len(rows), 'targets': 1,
               'num_items': cfg['num_items'], 'dim': cfg['embedding_dim'],
               'mixtures': cfg['num_mixtures']} for rows in pool]
    weights = {}

    def score_rows(rows, precision):
        if not weights:
            weights.update(make_weights(cfg, run.seed, device))
        prefixes = torch.as_tensor(rows_all[rows, :-1], device=device)
        return reference_scores(cfg, weights, prefixes, precision)

    return SimpleNamespace(
        model=model, pool=pool, inputs=inputs, shapes=shapes,
        targets_of=lambda row: rows_all[row, -1:],
        score_rows=score_rows,
        block_rows=max(1, min(4096, 2 ** 29 // (
            cfg['num_items'] * 2 * cfg['num_mixtures']))))
