"""Containers for user-item interaction data.

PyTorch-port counterpart of ``spotlight_tpu/data/interactions.py``: the same
COO-style arrays (optional ratings, timestamps and weights) with the same
validation and the same sparse-matrix views.  The data layer is host-side
numpy in both packages; this copy exists so that the port never imports the
JAX package.  Sequence conversion (``to_sequence``) belongs to the sequence
slice of the port and is not here yet.
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
