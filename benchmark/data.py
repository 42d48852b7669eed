"""The one general generator: data sets and the calls of a traffic mix,
made on the device from the seed and a configuration's sizes.

Every seed gets the same sizes: a user's interaction count comes from a
fixed profile (:func:`activity_counts`) and only which user gets which
count, which item has which popularity and which items are drawn change
with the seed.
"""

from __future__ import annotations

import zlib
from types import SimpleNamespace

import numpy as np
import torch


def subseed(seed, name):
    """A 63-bit seed for the stream ``name`` of a run's ``seed`` (any whole
    number, also past 32 bits)."""
    words = [int(seed) & 0xffffffff, (int(seed) >> 32) & 0xffffffff,
             zlib.crc32(name.encode())]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def device_generator(seed, name, device):
    generator = torch.Generator(device=device)
    generator.manual_seed(subseed(seed, name))
    return generator


def activity_counts(num_users, total, minimum, maximum, exponent):
    """Interaction counts of the users by rank, descending, summing to
    ``total``: ``minimum + A / (rank + q) ** exponent`` with ``A`` set so
    that the first user has ``maximum`` and ``q`` solved for the total, then
    floored, the remainder spread one each over the first users."""
    ranks = np.arange(1, num_users + 1, dtype=np.float64)
    spare = maximum - minimum

    def counts(q):
        return minimum + spare * ((1 + q) / (ranks + q)) ** exponent

    low, high = 0.0, float(num_users)
    if not counts(low).sum() <= total <= counts(high).sum():
        raise ValueError('no activity profile of {} users between {} and '
                         '{} sums to {}'.format(num_users, minimum, maximum,
                                                total))
    for _ in range(200):
        mid = 0.5 * (low + high)
        if counts(mid).sum() < total:
            low = mid
        else:
            high = mid
    out = np.floor(counts(low)).astype(np.int64)
    remainder = total - int(out.sum())
    if not 0 <= remainder <= num_users:
        raise ValueError('activity profile remainder {}'.format(remainder))
    out[:remainder] += 1
    return out


def zipf_cdf(num, exponent, device):
    """The cumulative distribution of Zipf popularity over ranks 1..num."""
    weights = torch.arange(1, num + 1, dtype=torch.float64,
                           device=device) ** -exponent
    cdf = torch.cumsum(weights, 0)
    return cdf / cdf[-1]


def _draw_ranks(cdf, count, generator):
    u = torch.rand(count, generator=generator, dtype=torch.float64,
                   device=cdf.device)
    return torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)


def distinct_pairs(users, num_items, cdf, item_of_rank, generator,
                   max_rounds=64):
    """Items drawn by popularity for each entry of ``users``, redrawn until
    no (user, item) pair repeats."""
    items = item_of_rank[_draw_ranks(cdf, users.numel(), generator)]
    for _ in range(max_rounds):
        keys = users * num_items + items
        order = torch.argsort(keys)
        sorted_keys = keys[order]
        repeats = order[1:][sorted_keys[1:] == sorted_keys[:-1]]
        if repeats.numel() == 0:
            return items
        items[repeats] = item_of_rank[_draw_ranks(cdf, repeats.numel(),
                                                  generator)]
    raise RuntimeError('pairs still repeat after {} rounds'.format(
        max_rounds))


def item_of_rank(cfg, seed, device):
    """Which item has which popularity rank: a seeded permutation."""
    return torch.randperm(cfg['num_items'],
                          generator=device_generator(seed, 'items', device),
                          device=device)


def interactions(cfg, seed, device):
    """The configuration's (user, item) triplets, shuffled and split as
    Spotlight's ``random_train_test_split`` splits them: the first
    ``1 - test_percentage`` of a random order is train, the rest test.

    Returns a namespace of device tensors ``train_users``, ``train_items``,
    ``test_users``, ``test_items``."""
    num_users, num_items = cfg['num_users'], cfg['num_items']
    total = cfg['num_interactions']
    counts = torch.as_tensor(activity_counts(
        num_users, total, cfg['min_user_interactions'],
        cfg['max_user_interactions'], cfg['user_activity_exponent']),
        device=device)
    generator = device_generator(seed, 'interactions', device)
    user_of_rank = torch.randperm(num_users, generator=generator,
                                  device=device)
    per_user = torch.empty_like(counts)
    per_user[user_of_rank] = counts
    users = torch.repeat_interleave(
        torch.arange(num_users, device=device), per_user)
    cdf = zipf_cdf(num_items, cfg['item_popularity_exponent'], device)
    items = distinct_pairs(users, num_items, cdf,
                           item_of_rank(cfg, seed, device), generator)
    order = torch.randperm(total, generator=generator, device=device)
    cutoff = int((1.0 - cfg['test_percentage']) * total)
    train, test = order[:cutoff], order[cutoff:]
    return SimpleNamespace(train_users=users[train], train_items=items[train],
                           test_users=users[test], test_items=items[test])


def test_rows(users, items, num_users):
    """The test split as host CSR arrays ``(indptr, items)``, each user's
    items ascending, and the users that have test items."""
    order = torch.argsort(users * (int(items.max()) + 1) + items)
    sorted_items = items[order].cpu().numpy()
    counts = torch.bincount(users, minlength=num_users).cpu().numpy()
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return indptr, sorted_items, np.flatnonzero(counts)


def sequences(cfg, seed, device):
    """``num_sequences`` sequences of ``sequence_length`` item ids uniform in
    ``[1, num_items)`` (0 is the padding id), as the repository's analogue
    of Spotlight's bloom-embedding performance example draws them; host
    int64."""
    generator = device_generator(seed, 'sequences', device)
    return torch.randint(1, cfg['num_items'],
                         (cfg['num_sequences'], cfg['sequence_length']),
                         generator=generator, device=device).cpu().numpy()


def call_rows(population, sizes, rows_per_call, num_calls, seed):
    """The rows of ``num_calls`` calls of ``rows_per_call`` entries of
    ``population`` each: a uniform sample stratified by size, so that every
    seed's calls hold the same mix of sizes.  The population, sorted by
    ``sizes`` (descending; ties in a seeded order), is cut into
    ``rows_per_call`` strata of equal count (the smallest few entries past
    the last whole stratum are left out); a call takes one entry of each
    stratum, and a stratum hands its entries to the calls in a seeded
    order, each once before any twice.  Each call's rows are sorted."""
    if rows_per_call > len(population):
        raise ValueError('{} rows a call from a population of {}'.format(
            rows_per_call, len(population)))
    rs = np.random.RandomState(subseed(seed, 'calls') % 2 ** 32)
    order = np.lexsort((rs.random_sample(len(population)), -sizes))
    size = len(population) // rows_per_call
    strata = population[order[:size * rows_per_call]].reshape(
        rows_per_call, size)
    turns = np.argsort(rs.random_sample(strata.shape), axis=1)
    picks = np.take_along_axis(strata, turns, axis=1)
    return [np.sort(picks[:, c % size]) for c in range(num_calls)]


def check_sample(num_answers, count, seed, must=()):
    """``count`` answer indices out of ``num_answers``, drawn from the seed
    without replacement, with the indices in ``must`` always in."""
    rs = np.random.RandomState(subseed(seed, 'check') % 2 ** 32)
    chosen = rs.choice(num_answers, min(count, num_answers), replace=False)
    return np.unique(np.concatenate([chosen, np.asarray(must, np.int64)]))
