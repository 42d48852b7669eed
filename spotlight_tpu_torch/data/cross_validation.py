"""Dataset splitting and shuffling.

Counterpart of ``spotlight_tpu/data/cross_validation.py``: interaction-level
random splits, and user-hash splits where a user's whole history lands on
one side (``murmurhash3_32(user_id) % 100 / 100 < pct``).  Both draw from the
caller's ``np.random.RandomState`` exactly as the JAX package does, so the
same state gives byte-identical splits in both packages.
"""

from __future__ import annotations

import numpy as np

from spotlight_tpu_torch.data.interactions import Interactions
from spotlight_tpu_torch.ops.hashing import murmurhash3_32


def _index_or_none(array, index):
    return None if array is None else array[index]


def _subset(interactions, index):
    return Interactions(
        interactions.user_ids[index],
        interactions.item_ids[index],
        ratings=_index_or_none(interactions.ratings, index),
        timestamps=_index_or_none(interactions.timestamps, index),
        weights=_index_or_none(interactions.weights, index),
        num_users=interactions.num_users,
        num_items=interactions.num_items)


def shuffle_interactions(interactions, random_state=None):
    """Shuffle interactions.

    Parameters
    ----------
    interactions : :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    random_state : np.random.RandomState, optional

    Returns
    -------
    :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    """
    if random_state is None:
        random_state = np.random.RandomState()

    shuffle_indices = np.arange(len(interactions.user_ids))
    random_state.shuffle(shuffle_indices)
    return _subset(interactions, shuffle_indices)


def random_train_test_split(interactions, test_percentage=0.2,
                            random_state=None):
    """Randomly split interactions between training and testing.

    Parameters
    ----------
    interactions : :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    test_percentage : float, optional
        Fraction of interactions to place in the test set.
    random_state : np.random.RandomState, optional

    Returns
    -------
    (train, test) : tuple of :class:`Interactions`
    """
    interactions = shuffle_interactions(interactions,
                                        random_state=random_state)
    cutoff = int((1.0 - test_percentage) * len(interactions))
    return (_subset(interactions, slice(None, cutoff)),
            _subset(interactions, slice(cutoff, None)))


def user_based_train_test_split(interactions, test_percentage=0.2,
                                random_state=None):
    """Split interactions by user id, so that a given user's entire history
    is either in the train or the test set.

    Parameters
    ----------
    interactions : :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    test_percentage : float, optional
        Fraction of users to place in the test set.
    random_state : np.random.RandomState, optional

    Returns
    -------
    (train, test) : tuple of :class:`Interactions`
    """
    if random_state is None:
        random_state = np.random.RandomState()

    minint = np.iinfo(np.uint32).min
    maxint = np.iinfo(np.uint32).max
    seed = random_state.randint(minint, maxint, dtype=np.int64)

    hashed = murmurhash3_32(
        interactions.user_ids.astype(np.int32), seed=int(seed), positive=True)
    in_test = (hashed % 100 / 100.0) < test_percentage
    in_train = np.logical_not(in_test)

    return _subset(interactions, in_train), _subset(interactions, in_test)
