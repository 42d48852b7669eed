"""The generator: the same seed gives the same data and calls, another
seed other ones with the same sizes."""

import numpy as np
import torch

from benchmark import data
from benchmark.tests.conftest import TINY, tiny_spec


def _mf(seed):
    cfg = tiny_spec('mf-msd.mrr').cfg
    return data.interactions(cfg, seed, 'cpu'), cfg


def test_interactions_repeat_per_seed_and_differ_across_seeds():
    a, cfg = _mf(2 ** 33 + 5)
    b, _ = _mf(2 ** 33 + 5)
    c, _ = _mf(11)
    for name in ('train_users', 'train_items', 'test_users', 'test_items'):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert not torch.equal(a.test_items, c.test_items)
    total = cfg['num_interactions']
    assert a.train_users.numel() + a.test_users.numel() == total
    assert a.test_users.numel() == total - int(0.8 * total)


def test_pairs_are_distinct_and_counts_follow_the_profile():
    split, cfg = _mf(5)
    users = torch.cat([split.train_users, split.test_users])
    items = torch.cat([split.train_items, split.test_items])
    keys = users * cfg['num_items'] + items
    assert torch.unique(keys).numel() == keys.numel()
    counts = np.sort(torch.bincount(users).numpy())[::-1]
    profile = data.activity_counts(
        cfg['num_users'], cfg['num_interactions'],
        cfg['min_user_interactions'], cfg['max_user_interactions'],
        cfg['user_activity_exponent'])
    assert np.array_equal(counts, profile)
    # The remainder of the floored counts goes one each to the first users.
    assert profile[0] - cfg['max_user_interactions'] in (0, 1)
    assert profile[-1] >= cfg['min_user_interactions']


def test_calls_repeat_per_seed_with_the_same_sizes_across_seeds():
    population = np.arange(1000, 6000)
    sizes = np.repeat(np.arange(50, 0, -1), 100)
    one = data.call_rows(population, sizes, 50, 7, seed=3)
    again = data.call_rows(population, sizes, 50, 7, seed=3)
    other = data.call_rows(population, sizes, 50, 7, seed=4)
    assert all(np.array_equal(x, y) for x, y in zip(one, again))
    assert not all(np.array_equal(x, y) for x, y in zip(one, other))
    size_of = dict(zip(population, sizes))
    for a, b in zip(one, other):
        assert len(set(a)) == 50
        assert sorted(size_of[r] for r in a) == sorted(size_of[r]
                                                       for r in b)


def test_sequences_repeat_per_seed_and_skip_the_padding_id():
    cfg = dict(TINY['mixture_lstm_1e6'], sequence_length=50)
    a = data.sequences(cfg, 9, 'cpu')
    assert np.array_equal(a, data.sequences(cfg, 9, 'cpu'))
    assert not np.array_equal(a, data.sequences(cfg, 10, 'cpu'))
    assert a.shape == (cfg['num_sequences'], 50) and a.min() >= 1


def test_seeds_past_32_bits_give_distinct_streams():
    assert data.subseed(2 ** 31 + 1, 'x') != data.subseed(1, 'x')
    assert data.subseed(2 ** 32 + 1, 'x') != data.subseed(1, 'x')
    assert data.subseed(5, 'x') != data.subseed(5, 'y')
