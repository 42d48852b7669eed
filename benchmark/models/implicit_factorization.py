"""Spotlight's ``ImplicitFactorizationModel`` over a fused ``BilinearNet``.

Weights are two fused tables, ``user_embeddings.weight`` ``(U, D + 1)`` and
``item_embeddings.weight`` ``(N, D + 1)``, made on the device in one call
each from the seed.  Spotlight's four parameter groups (user factors, user
biases, item factors, item biases) are the leaves the training comparison
takes one by one.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark import data
from benchmark.reference import mf

TABLES = ('user_embeddings.weight', 'item_embeddings.weight')
#: Held-out pairs gathered at once when the ranking weights are made.
HELD_OUT_CHUNK = 1 << 22


def make_weights(cfg, seed, device, held_out=None):
    """The two fused tables: factors N(0, 1) / D (Spotlight's
    initialisation) and biases zero.  With ``held_out`` (``(users, items)``
    device tensors of the test pairs), the weights that the ranking cells
    serve: biases N(0, 1) / D^1.5 (the spread of a dot product of two
    factor rows) and each user's factors plus the sum of the factors of
    the user's held-out items, so that held-out items rank near the top, as
    under a well-fitted model, and their ranks are not all far down."""
    dim = cfg['embedding_dim']
    generator = data.device_generator(seed, 'weights', device)
    out = {}
    for name, rows in zip(TABLES, (cfg['num_users'], cfg['num_items'])):
        table = torch.randn(rows, dim + 1, generator=generator,
                            device=device) / dim
        if held_out is None:
            table[:, dim] = 0.0
        else:
            table[:, dim] *= dim ** -0.5
        out[name] = table
    if held_out is not None:
        users, items = held_out
        item_factors = out['item_embeddings.weight'][:, :dim]
        user_factors = out['user_embeddings.weight'][:, :dim]
        for start in range(0, users.numel(), HELD_OUT_CHUNK):
            part = slice(start, start + HELD_OUT_CHUNK)
            user_factors.index_add_(0, users[part],
                                    item_factors[items[part]])
    return out


def leaves(tables, dim):
    """Spotlight's four parameter groups of fused tables, by name."""
    user, item = tables
    return {'user_factors': user[:, :dim], 'user_biases': user[:, dim],
            'item_factors': item[:, :dim], 'item_biases': item[:, dim]}


def build(cfg, weights, device, seed, n_iter):
    """The port's estimator around ``weights``, through its public
    constructor: a ``BilinearNet`` as ``representation`` with the tables
    copied in, the configuration's loss, width, batch, rate and engine.
    Not yet fitted."""
    from spotlight_tpu_torch.factorization import (BilinearNet,
                                                   ImplicitFactorizationModel)

    net = BilinearNet(cfg['num_users'], cfg['num_items'],
                      cfg['embedding_dim'], sparse=cfg['sparse'],
                      device=device)
    with torch.no_grad():
        for name, parameter in net.named_parameters():
            parameter.copy_(weights[name])
    return ImplicitFactorizationModel(
        loss=cfg['loss'], embedding_dim=cfg['embedding_dim'], n_iter=n_iter,
        batch_size=cfg['batch_size'], l2=cfg['l2'],
        learning_rate=cfg['learning_rate'], representation=net,
        sparse=cfg['sparse'],
        random_state=np.random.RandomState(model_seed(seed)),
        device=device)


def interactions(cfg, user_ids, item_ids):
    from spotlight_tpu_torch.data import Interactions

    return Interactions(user_ids, item_ids, num_users=cfg['num_users'],
                        num_items=cfg['num_items'])


def reference_scores(cfg, weights, users, precision='float32'):
    """(B, N) reference scores of user ids ``users`` (a device tensor)."""
    return mf.catalogue_scores(weights['user_embeddings.weight'][users],
                               weights['item_embeddings.weight'], precision)


def _rows_of(indptr, items, users):
    """The concatenated item rows of ``users`` in a CSR layout, and their
    lengths."""
    starts = indptr[users]
    counts = indptr[users + 1] - starts
    offsets = (np.repeat(starts - np.cumsum(counts) + counts, counts)
               + np.arange(counts.sum()))
    return items[offsets], counts


def serving(run):
    """Set-up of the ranking entries: the test split, the port's model
    around the ranking weights (initialised by a ``fit`` of no epochs on one
    batch of train pairs), and the calls: ``rows_per_call`` users with test
    items each, with all their test items and no train mask."""
    cfg, device, traffic = run.cfg, run.device, run.traffic
    split = data.interactions(cfg, run.seed, device)
    indptr, items, population = data.test_rows(
        split.test_users, split.test_items, cfg['num_users'])
    first = slice(0, cfg['batch_size'])
    init = interactions(cfg, split.train_users[first].cpu().numpy(),
                        split.train_items[first].cpu().numpy())
    del split

    def weights_now():
        held_out = (torch.repeat_interleave(
            torch.arange(cfg['num_users'], device=device),
            torch.as_tensor(np.diff(indptr), device=device)),
            torch.as_tensor(items, device=device))
        return make_weights(cfg, run.seed, device, held_out)

    weights = weights_now()
    run.set_up_data()
    model = build(cfg, weights, device, run.seed, n_iter=0)
    weights.clear()
    model.fit(init)
    pool = data.call_rows(population, np.diff(indptr)[population],
                          traffic['rows_per_call'], traffic['pool_calls'],
                          run.seed)
    inputs, shapes = [], []
    for rows in pool:
        item_ids, counts = _rows_of(indptr, items, rows)
        inputs.append(interactions(cfg, np.repeat(rows, counts), item_ids))
        shapes.append({'batch': len(rows), 'targets': int(counts.max()),
                       'num_items': cfg['num_items'],
                       'dim': cfg['embedding_dim'], 'mixtures': None})

    def score_rows(users, precision):
        if not weights:
            weights.update(weights_now())
        return reference_scores(cfg, weights, torch.as_tensor(
            users, device=device), precision)

    return SimpleNamespace(
        model=model, pool=pool, inputs=inputs, shapes=shapes,
        targets_of=lambda user: items[indptr[user]:indptr[user + 1]],
        score_rows=score_rows,
        block_rows=max(1, min(4096, 2 ** 29 // (cfg['num_items']))))


def training(run):
    """Set-up of the training entry: the train split's first
    ``fit_interactions`` pairs (the window's fits) and the port's model
    around Spotlight's initial weights."""
    cfg, device = run.cfg, run.device
    split = data.interactions(cfg, run.seed, device)
    users = split.train_users[:cfg['fit_interactions']].cpu().numpy()
    items = split.train_items[:cfg['fit_interactions']].cpu().numpy()
    del split
    run.set_up_data()
    model = build(cfg, make_weights(cfg, run.seed, device), device,
                  run.seed, n_iter=1)
    return SimpleNamespace(model=model, users=users, items=items,
                           fit=interactions(cfg, users, items))


def initial_tables(run):
    weights = make_weights(run.cfg, run.seed, run.device)
    return [weights[name] for name in TABLES]


def program_tables(model):
    """The port's fused tables, as its estimator holds them."""
    params = dict(model._net.named_parameters())
    return [params[name].detach() for name in TABLES]


def program_first_grads(model):
    """The first step's gradients as the port's Adam got them, worked out
    from its first moments after one step (``mu = (1 - b1) g``)."""
    mu = model._opt_state['mu']
    one_minus_b1 = torch.tensor(1.0 - mf.B1, dtype=torch.float32)
    return [mu[name] / one_minus_b1.to(mu[name].device) for name in TABLES]


def step_batches(run, fits, draw_seed):
    """The steps of the ``fits`` (each ``(users, items)`` of one fit) as the
    port's ``fit`` draws them from its estimator's generator, worked out
    again: a CPU ``torch.Generator`` seeded by one ``randint(0, 2**31 - 1)``
    of the estimator's ``RandomState``; each fit pads its pairs with zeros
    to whole batches, draws the permutation of the padded rows, then one
    uniform negative item a padded row, ``(batches, 1, batch)``; a row of a
    batch counts when its permuted index is a pair's.  Returns the steps
    ``(users, items, negatives, mask)`` and the number of steps of each
    fit."""
    generator = torch.Generator()
    generator.manual_seed(int(np.random.RandomState(draw_seed).randint(
        0, 2 ** 31 - 1)))
    batch, to = run.cfg['batch_size'], run.device
    batches, steps = [], []
    for users, items in fits:
        n = len(users)
        count = -(-n // batch)
        padded = count * batch
        perm = torch.randperm(padded, generator=generator)
        negatives = torch.randint(0, run.cfg['num_items'], (count, 1, batch),
                                  generator=generator, dtype=torch.int64)
        columns = [torch.cat([torch.as_tensor(c, dtype=torch.int64),
                              torch.zeros(padded - n, dtype=torch.int64)])
                   for c in (users, items)]
        for b in range(count):
            rows = perm[b * batch:(b + 1) * batch]
            batches.append((columns[0][rows].to(to), columns[1][rows].to(to),
                            negatives[b, 0].to(to),
                            (rows < n).to(torch.float32).to(to)))
        steps.append(count)
    return batches, steps


def model_seed(seed):
    return data.subseed(seed, 'model') % 2 ** 32


def reference_steps(run, batches, dtype=torch.float32, keep=None):
    user, item = initial_tables(run)
    return mf.bpr_steps(user, item, batches, run.cfg['learning_rate'],
                        dtype=dtype, keep=keep)
