"""SASRec (Kang and McAuley, arXiv:1808.09781) in Spotlight's
``ImplicitSequenceModel``, over the port's ``SelfAttentionNet``.

The data are the configuration's users' histories: each user's count of
actions from a fixed profile (``data.activity_counts``; which user has
which count is drawn from the seed), the last ``sequence_length`` of them
kept and left-padded with the padding id 0, items uniform in
``[1, num_items)``.  Weights are the fused item table
``item_embeddings.weight`` ``(N, D + 1)`` (row 0 zero), the positions and
each block's LayerNorms, products and feed-forward biases, made on the
device from the seed, one call a tensor.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import data
from benchmark.reference import sasrec
# Imported with the family, so that a port without the network stops the
# cell at once.
from spotlight_tpu_torch.sequence.representations import SelfAttentionNet

BLOCK_PRODUCTS = ('w_q', 'w_k', 'w_v', 'w_1', 'w_2')


def make_weights(cfg, seed, device):
    """Item factors N(0, 1) / D and biases N(0, 1) / D^1.5; positions
    N(0, 1) / D; LayerNorm gains 1 + U(-0.1, 0.1) and offsets
    U(-0.1, 0.1); products and feed-forward biases U(-1/sqrt(D),
    1/sqrt(D))."""
    dim = cfg['embedding_dim']
    generator = data.device_generator(seed, 'weights', device)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator, device=device)
                * 2 - 1) * bound

    table = torch.randn(cfg['num_items'], dim + 1, generator=generator,
                        device=device) / dim
    table[:, dim] *= dim ** -0.5
    table[0] = 0.0
    out = {'item_embeddings.weight': table,
           'position_embeddings': torch.randn(
               cfg['max_sequence_length'], dim, generator=generator,
               device=device) / dim}
    bound = 1.0 / math.sqrt(dim)
    norms = ['output_norm.']
    for b in range(cfg['num_blocks']):
        stem = 'blocks.{}.'.format(b)
        for name in BLOCK_PRODUCTS:
            out[stem + name] = uniform((dim, dim), bound)
        for name in ('b_1', 'b_2'):
            out[stem + name] = uniform((dim,), bound)
        norms += [stem + 'norm_a_', stem + 'norm_f_']
    for stem in norms:
        out[stem + 'weight'] = 1.0 + uniform((dim,), 0.1)
        out[stem + 'bias'] = uniform((dim,), 0.1)
    return out


def build(cfg, weights, device, seed, n_iter):
    """The port's estimator around ``weights``, through its public
    constructor: a ``SelfAttentionNet`` as ``representation`` with the
    weights copied in.  Not yet fitted."""
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    net = SelfAttentionNet(cfg['num_items'], cfg['embedding_dim'],
                           num_blocks=cfg['num_blocks'],
                           max_sequence_length=cfg['max_sequence_length'],
                           dropout=cfg['dropout'], device=device)
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


def histories(cfg, seed, device):
    """(rows, lengths): ``num_sequences`` histories as a host int64
    ``(num_sequences, sequence_length)`` array, each user's last
    ``min(count, sequence_length)`` items right-aligned after padding
    ids, and those lengths."""
    users, window = cfg['num_sequences'], cfg['sequence_length']
    counts = data.activity_counts(users, cfg['num_actions'],
                                  cfg['min_actions'], cfg['max_actions'],
                                  cfg['activity_exponent'])
    generator = data.device_generator(seed, 'sequences', device)
    owner = torch.randperm(users, generator=generator,
                           device=device).cpu().numpy()
    lengths = np.empty(users, np.int64)
    lengths[owner] = np.minimum(counts, window)
    items = torch.randint(1, cfg['num_items'], (users, window),
                          generator=generator, device=device)
    start = torch.as_tensor(window - lengths, device=device)
    kept = torch.arange(window, device=device)[None, :] >= start[:, None]
    return (items * kept).cpu().numpy(), lengths


def call_rows(lengths, rows_per_call, num_calls, seed):
    """The rows of ``num_calls`` calls of ``rows_per_call`` distinct users
    each, stratified by length over the whole population: the users,
    sorted by length (descending; ties in a seeded order), are cut into
    ``rows_per_call`` strata at evenly spaced bounds (so that strata of
    the larger and of the smaller count alternate along the lengths, and a
    call's mean length is the population's), and a call takes one user of
    each, a stratum handing its users to the calls in a seeded order, each
    once before any twice.  Each call's rows are sorted."""
    rs = np.random.RandomState(data.subseed(seed, 'calls') % 2 ** 32)
    order = np.lexsort((rs.random_sample(len(lengths)), -lengths))
    bounds = np.round(np.linspace(0, len(order),
                                  rows_per_call + 1)).astype(int)
    strata = [order[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    turns = [s[rs.permutation(len(s))] for s in strata]
    return [np.sort([t[c % len(t)] for t in turns])
            for c in range(num_calls)]


def sequences(cfg, rows):
    from spotlight_tpu_torch.data import SequenceInteractions

    return SequenceInteractions(rows, num_items=cfg['num_items'])


def reference_scores(cfg, weights, rows, precision='float32'):
    """(B, N) reference scores of the next item after sequences ``rows``
    (B, L) (a device tensor)."""
    final = sasrec.final_representation(weights, rows, cfg['num_blocks'],
                                        precision)
    return sasrec.catalogue_scores(weights, final, precision)


def serving(run):
    """Set-up of the ranking entries: the histories, the port's model
    around the weights (initialised by a ``fit`` of no epochs on one batch
    of histories), and the calls: ``rows_per_call`` histories each, every
    one ranked on its last item after the rest.  A call's shape carries
    each history's real steps in the network's window of the prefix (its
    length less the target), for the readers."""
    cfg, device, traffic = run.cfg, run.device, run.traffic
    rows_all, lengths = histories(cfg, run.seed, device)
    run.set_up_data()
    model = build(cfg, make_weights(cfg, run.seed, device), device,
                  run.seed, n_iter=0)
    model.fit(sequences(cfg, rows_all[:cfg['batch_size']]))
    pool = call_rows(lengths, traffic['rows_per_call'], traffic['pool_calls'],
                     run.seed)
    inputs = [sequences(cfg, rows_all[rows]) for rows in pool]
    shapes = [{'batch': len(rows), 'targets': 1,
               'num_items': cfg['num_items'], 'dim': cfg['embedding_dim'],
               'mixtures': None, 'blocks': cfg['num_blocks'],
               'real_steps': lengths[rows] - 1} for rows in pool]
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
        # A block's attention scores, (rows, L, L) float32, about 0.5 GB.
        block_rows=max(1, 2 ** 27 // cfg['sequence_length'] ** 2))
