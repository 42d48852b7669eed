"""The port's data layer against the JAX package's.

Splits drawn from the same ``RandomState`` must be byte-identical in both
packages, the host hash bit-identical, and the containers must validate and
convert alike.
"""

import numpy as np
import pytest

from spotlight_tpu.data import cross_validation as jax_cv
from spotlight_tpu.data.interactions import Interactions as JaxInteractions
from spotlight_tpu.ops.hashing import murmurhash3_32 as jax_murmurhash3_32
from spotlight_tpu.utils import training as jax_training
from spotlight_tpu_torch.data import (Interactions, cross_validation,
                                      random_train_test_split,
                                      shuffle_interactions,
                                      user_based_train_test_split)
from spotlight_tpu_torch.ops.hashing import murmurhash3_32
from spotlight_tpu_torch.utils.training import (generator_from_random_state,
                                                pad_array)

_FIELDS = ('user_ids', 'item_ids', 'ratings', 'timestamps', 'weights')


def _arrays(seed=0, n=2000, num_users=150, num_items=300):
    rs = np.random.RandomState(seed)
    return dict(user_ids=rs.randint(0, num_users, n).astype(np.int32),
                item_ids=rs.randint(0, num_items, n).astype(np.int32),
                ratings=rs.randint(1, 6, n).astype(np.float32),
                timestamps=rs.randint(0, 10 ** 6, n).astype(np.int64),
                weights=rs.rand(n).astype(np.float32),
                num_users=num_users, num_items=num_items)


def _assert_same(port, ref):
    assert (port.num_users, port.num_items) == (ref.num_users, ref.num_items)
    for name in _FIELDS:
        got, want = getattr(port, name), getattr(ref, name)
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize('split', ['random_train_test_split',
                                   'user_based_train_test_split'])
@pytest.mark.parametrize('test_percentage', [0.2, 0.5])
def test_splits_byte_identical(split, test_percentage):
    arrays = _arrays()
    port = getattr(cross_validation, split)(
        Interactions(**arrays), test_percentage=test_percentage,
        random_state=np.random.RandomState(11))
    ref = getattr(jax_cv, split)(
        JaxInteractions(**arrays), test_percentage=test_percentage,
        random_state=np.random.RandomState(11))
    for got, want in zip(port, ref):
        _assert_same(got, want)


def test_shuffle_byte_identical_and_state_advances_alike():
    arrays = _arrays(seed=3)
    rs_port, rs_ref = np.random.RandomState(5), np.random.RandomState(5)
    _assert_same(shuffle_interactions(Interactions(**arrays), rs_port),
                 jax_cv.shuffle_interactions(JaxInteractions(**arrays),
                                             rs_ref))
    # Both consumed the same draws: the states continue in step.
    assert rs_port.randint(0, 2 ** 31 - 1) == rs_ref.randint(0, 2 ** 31 - 1)


def test_user_based_split_keeps_users_whole():
    interactions = Interactions(**_arrays(seed=8))
    train, test = user_based_train_test_split(
        interactions, random_state=np.random.RandomState(2))
    assert len(train) + len(test) == len(interactions)
    assert not set(train.user_ids.tolist()) & set(test.user_ids.tolist())
    train, test = random_train_test_split(
        interactions, random_state=np.random.RandomState(2))
    assert len(test) == len(interactions) - int(0.8 * len(interactions))


@pytest.mark.parametrize('seed', [0, 42, 0x9747B28C])
@pytest.mark.parametrize('positive', [False, True])
def test_murmurhash3_32_bit_identical(seed, positive):
    keys = np.random.RandomState(seed % 1000).randint(
        -2 ** 31, 2 ** 31 - 1, size=4096).astype(np.int32)
    got = murmurhash3_32(keys, seed=seed, positive=positive)
    want = jax_murmurhash3_32(keys, seed=seed, positive=positive)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_interactions_views_match():
    arrays = _arrays(seed=4)
    port, ref = Interactions(**arrays), JaxInteractions(**arrays)
    assert len(port) == len(ref) and repr(port) == repr(ref)
    for view in ('tocoo', 'tocsr'):
        got, want = getattr(port, view)(), getattr(ref, view)()
        assert got.shape == want.shape
        assert (got != want).nnz == 0
    csr = port.tocsr()
    np.testing.assert_array_equal(csr.indptr, ref.tocsr().indptr)
    np.testing.assert_array_equal(csr.indices, ref.tocsr().indices)


def test_interactions_infers_sizes():
    port = Interactions(np.array([0, 4]), np.array([2, 9]))
    ref = JaxInteractions(np.array([0, 4]), np.array([2, 9]))
    assert (port.num_users, port.num_items) == (ref.num_users,
                                                ref.num_items) == (5, 10)


@pytest.mark.parametrize('case', ['length', 'user_max', 'item_max',
                                  'ratings_length', 'empty', 'int32'])
def test_interactions_validation_matches(case):
    users, items = np.array([0, 1, 2]), np.array([3, 4, 5])
    kwargs = dict(num_users=3, num_items=6)
    if case == 'length':
        items = items[:2]
    elif case == 'user_max':
        kwargs['num_users'] = 2
    elif case == 'item_max':
        kwargs['num_items'] = 5
    elif case == 'ratings_length':
        kwargs['ratings'] = np.ones(2)
    elif case == 'empty':
        users, items, kwargs = np.array([]), np.array([]), {}
    else:
        users = np.array([0, 1, 2 ** 31])
        kwargs['num_users'] = 2 ** 31 + 1
    with pytest.raises(ValueError) as port_error:
        Interactions(users, items, **kwargs)
    with pytest.raises(ValueError) as ref_error:
        JaxInteractions(users, items, **kwargs)
    assert str(port_error.value)[:40] == str(ref_error.value)[:40]


def test_generator_takes_the_same_draw_as_the_jax_key():
    """One randint(0, 2**31 - 1) draw, as key_from_random_state takes."""
    rs_port, rs_ref = np.random.RandomState(9), np.random.RandomState(9)
    generator = generator_from_random_state(rs_port)
    jax_training.key_from_random_state(rs_ref)
    assert rs_port.randint(0, 2 ** 31 - 1) == rs_ref.randint(0, 2 ** 31 - 1)
    assert generator.initial_seed() == np.random.RandomState(9).randint(
        0, 2 ** 31 - 1)


@pytest.mark.parametrize('shape,length', [((5,), 8), ((5, 3), 5),
                                          ((0, 2), 4)])
def test_pad_array_matches(shape, length):
    array = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got, want = pad_array(array, length), jax_training.pad_array(array,
                                                                 length)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
