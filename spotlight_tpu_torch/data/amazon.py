"""Amazon co-purchasing dataset fetcher.

Counterpart of ``spotlight_tpu/data/amazon.py``: the SNAP co-purchase set
with minimum-count filtering and a contiguous remap of the surviving ids.
"""

from __future__ import annotations

import numpy as np

from spotlight_tpu_torch.data.interactions import Interactions
from spotlight_tpu_torch.data.transport import fetch_hdf5_columns

_URL = ('https://github.com/maciejkula/recommender_datasets/'
        'releases/download/0.1.0/amazon_co_purchasing.hdf5')
_COLUMNS = ('/user_id', '/item_id', '/rating', '/timestamp',
            '/features_item_id', '/features_feature_id')


def _filter_by_count(elements, min_count):
    unique_elements, element_counts = np.unique(elements, return_counts=True)
    return unique_elements[element_counts >= min_count]


def get_amazon_dataset(min_user_interactions=10, min_item_interactions=10):
    """Download (or read from cache) the Amazon co-purchasing dataset.

    Users and items with fewer than the requested number of interactions are
    dropped (the two filters applied independently), and the surviving ids
    are remapped to a contiguous range starting at 1 (id 0 stays free for
    sequence padding).

    Returns
    -------
    :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    """
    user_ids, item_ids, ratings, timestamps, _, _ = fetch_hdf5_columns(
        _URL, 'amazon', 'amazon_co_purchasing.hdf5', _COLUMNS)

    retain_user_ids = _filter_by_count(user_ids, min_user_interactions)
    retain_item_ids = _filter_by_count(item_ids, min_item_interactions)

    retain = np.logical_and(np.isin(user_ids, retain_user_ids),
                            np.isin(item_ids, retain_item_ids))

    user_ids = user_ids[retain]
    item_ids = item_ids[retain]
    ratings = ratings[retain]
    timestamps = timestamps[retain]

    # The retained ids are sorted (np.unique), so searchsorted gives each
    # element its new id less one.
    user_ids = (np.searchsorted(retain_user_ids, user_ids) + 1).astype(
        user_ids.dtype)
    item_ids = (np.searchsorted(retain_item_ids, item_ids) + 1).astype(
        item_ids.dtype)

    return Interactions(user_ids,
                        item_ids,
                        ratings=ratings,
                        timestamps=timestamps,
                        num_users=len(retain_user_ids) + 1,
                        num_items=len(retain_item_ids) + 1)
