"""Containers for user-item interaction data.

PyTorch-port counterpart of ``spotlight_tpu/data/interactions.py``: the same
COO-style arrays (optional ratings, timestamps and weights) with the same
validation, the same sparse-matrix views and the same sequence conversion
(:meth:`Interactions.to_sequence`, :class:`SequenceInteractions`).  The data
layer is host-side numpy in both packages; this copy exists so that the port
never imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

PADDING_IDX = 0


class Interactions:
    """COO-style interactions dataset.

    Contains (at a minimum) a pair of user-item interaction arrays, optionally
    enriched with ratings, timestamps, and interaction weights.

    Parameters
    ----------
    user_ids : array of int
    item_ids : array of int
    ratings : array of float, optional
    timestamps : array of int, optional
    weights : array of float, optional
    num_users : int, optional
        Must be larger than the maximum user id.
    num_items : int, optional
        Must be larger than the maximum item id.
    """

    def __init__(self, user_ids, item_ids,
                 ratings=None,
                 timestamps=None,
                 weights=None,
                 num_users=None,
                 num_items=None):
        user_ids = np.asarray(user_ids)
        item_ids = np.asarray(item_ids)

        if len(user_ids) != len(item_ids):
            raise ValueError('user_ids and item_ids must have equal length '
                             '({} vs {})'.format(len(user_ids), len(item_ids)))
        if len(user_ids) == 0 and (num_users is None or num_items is None):
            raise ValueError('Cannot infer num_users/num_items from an empty '
                             'dataset; pass both explicitly.')

        self.num_users = int(num_users or user_ids.max() + 1)
        self.num_items = int(num_items or item_ids.max() + 1)

        self.user_ids = user_ids
        self.item_ids = item_ids
        self.ratings = None if ratings is None else np.asarray(ratings)
        self.timestamps = None if timestamps is None else np.asarray(timestamps)
        self.weights = None if weights is None else np.asarray(weights)

        self._check()

    def __repr__(self):
        return ('<Interactions dataset ({num_users} users x {num_items} items '
                'x {num_interactions} interactions)>'
                .format(num_users=self.num_users,
                        num_items=self.num_items,
                        num_interactions=len(self)))

    def __len__(self):
        return len(self.user_ids)

    def _check(self):
        if len(self.user_ids) == 0:
            return
        # Ids are int32 on the device; larger ids would wrap silently.
        if (int(self.user_ids.max()) > 2 ** 31 - 1 or
                int(self.item_ids.max()) > 2 ** 31 - 1):
            raise ValueError('ids exceed int32 range; remap to a contiguous '
                             'range first')
        if self.user_ids.max() >= self.num_users:
            raise ValueError('Maximum user id greater '
                             'than declared number of users.')
        if self.item_ids.max() >= self.num_items:
            raise ValueError('Maximum item id greater '
                             'than declared number of items.')

        num_interactions = len(self.user_ids)
        for name, value in (('item IDs', self.item_ids),
                            ('ratings', self.ratings),
                            ('timestamps', self.timestamps),
                            ('weights', self.weights)):
            if value is None:
                continue
            if len(value) != num_interactions:
                raise ValueError('Invalid {} dimensions: length '
                                 'must be equal to number of interactions'
                                 .format(name))

    def tocoo(self):
        """Transform to a scipy.sparse COO matrix."""
        data = (self.ratings if self.ratings is not None
                else np.ones(len(self)))
        return sp.coo_matrix((data, (self.user_ids, self.item_ids)),
                             shape=(self.num_users, self.num_items))

    def tocsr(self):
        """Transform to a scipy.sparse CSR matrix."""
        return self.tocoo().tocsr()

    def to_sequence(self, max_sequence_length=10, min_sequence_length=None,
                    step_size=None):
        """Transform to sequence form.

        Interactions are sorted by (user, timestamp) and cut into left-padded
        sliding windows of up to ``max_sequence_length`` items, moving
        right-to-left through each user's history with stride ``step_size``
        (default: ``max_sequence_length``, i.e. non-overlapping windows).

        For a user who interacted with items ``[1, 2, 3, 4, 5]``, the windows
        at length 5 / step 1 are::

            [[1, 2, 3, 4, 5],
             [0, 1, 2, 3, 4],
             [0, 0, 1, 2, 3],
             [0, 0, 0, 1, 2],
             [0, 0, 0, 0, 1]]

        and at step 2::

            [[1, 2, 3, 4, 5],
             [0, 0, 1, 2, 3],
             [0, 0, 0, 0, 1]]

        Item id 0 is reserved as the padding value.  Window extraction is a
        single vectorized gather: for every (window, position) pair the
        source index into the time-sorted item array is computed, and
        out-of-window positions are set to padding.

        Parameters
        ----------
        max_sequence_length : int, optional
        min_sequence_length : int, optional
            Drop windows with fewer than this many real (non-padding) items.
        step_size : int, optional

        Returns
        -------
        :class:`SequenceInteractions`
        """
        if self.timestamps is None:
            raise ValueError('Cannot convert to sequences, '
                             'timestamps not available.')
        if 0 in self.item_ids:
            raise ValueError('0 is used as an item id, conflicting '
                             'with the sequence padding value.')
        if step_size is None:
            step_size = max_sequence_length

        # Sort by user, then timestamp (stable within equal keys).
        sort_indices = np.lexsort((self.timestamps, self.user_ids))
        user_ids = self.user_ids[sort_indices]
        item_ids = self.item_ids[sort_indices].astype(np.int32)

        uniq_users, starts, counts = np.unique(
            user_ids, return_index=True, return_counts=True)

        # Window j of a user with c interactions ends (exclusively) at local
        # offset c - j*step, for j = 0 .. ceil(c/step)-1.
        windows_per_user = -(-counts // step_size)  # ceil division
        num_windows = int(windows_per_user.sum())

        # Map each window to its user and its j-index within that user.
        window_user_idx = np.repeat(
            np.arange(len(uniq_users)), windows_per_user)
        window_offsets = np.repeat(
            np.cumsum(windows_per_user) - windows_per_user, windows_per_user)
        window_j = np.arange(num_windows) - window_offsets

        window_end = counts[window_user_idx] - window_j * step_size  # local
        window_start_global = starts[window_user_idx]

        # Source index for column k (k = 0 .. L-1, L = max_sequence_length):
        # the element at distance (L - k) from the window end.
        cols = np.arange(max_sequence_length)
        src_local = window_end[:, None] - (max_sequence_length - cols)[None, :]
        valid = src_local >= 0
        src_global = np.where(valid, window_start_global[:, None] + src_local, 0)

        sequences = np.where(valid, item_ids[src_global], PADDING_IDX)
        sequences = sequences.astype(np.int32)
        sequence_users = uniq_users[window_user_idx].astype(np.int32)

        if min_sequence_length is not None:
            long_enough = sequences[:, -min_sequence_length] != PADDING_IDX
            sequences = sequences[long_enough]
            sequence_users = sequence_users[long_enough]

        return SequenceInteractions(sequences,
                                    user_ids=sequence_users,
                                    num_items=self.num_items)


class SequenceInteractions:
    """Interactions encoded as a left-padded sequence matrix.

    Parameters
    ----------
    sequences : int array of shape (num_sequences, max_sequence_length)
        As produced by :meth:`Interactions.to_sequence`.
    user_ids : int array of shape (num_sequences,), optional
    num_items : int, optional
    """

    def __init__(self, sequences, user_ids=None, num_items=None):
        self.sequences = np.asarray(sequences)
        self.user_ids = user_ids
        self.max_sequence_length = self.sequences.shape[1]

        if num_items is None:
            if self.sequences.size == 0:
                raise ValueError('Cannot infer num_items from empty '
                                 'sequences; pass num_items explicitly.')
            self.num_items = int(self.sequences.max() + 1)
        else:
            self.num_items = num_items

    def __repr__(self):
        num_sequences, sequence_length = self.sequences.shape
        return ('<Sequence interactions dataset ({num_sequences} '
                'sequences x {sequence_length} sequence length)>'
                .format(num_sequences=num_sequences,
                        sequence_length=sequence_length))
