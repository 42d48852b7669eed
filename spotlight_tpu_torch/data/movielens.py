"""MovieLens dataset fetchers (100K, 1M, 10M, 20M).

Counterpart of ``spotlight_tpu/data/movielens.py``: the HDF5-packaged
MovieLens variants as :class:`~spotlight_tpu_torch.data.interactions.
Interactions`, from the same cache file.
"""

from __future__ import annotations

import os

from spotlight_tpu_torch.data.interactions import Interactions
from spotlight_tpu_torch.data.transport import fetch_hdf5_columns

VARIANTS = ('100K', '1M', '10M', '20M')

_RELEASE = ('https://github.com/maciejkula/recommender_datasets/'
            'releases/download/v0.2.0')
_COLUMNS = ('/user_id', '/item_id', '/rating', '/timestamp')


def get_movielens_dataset(variant='100K'):
    """Download (or read from cache) one of the MovieLens datasets.

    Parameters
    ----------
    variant : str, one of ('100K', '1M', '10M', '20M')

    Returns
    -------
    :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    """
    if variant not in VARIANTS:
        raise ValueError('Variant must be one of {}, '
                         'got {}.'.format(VARIANTS, variant))

    # The cache file name carries its prefix twice, as the original
    # library names it.
    users, items, ratings, timestamps = fetch_hdf5_columns(
        '{}/movielens_{}.hdf5'.format(_RELEASE, variant),
        os.path.join('movielens', 'v0.2.0'),
        'movielens_movielens_{}.hdf5'.format(variant),
        _COLUMNS)
    return Interactions(users, items, ratings=ratings,
                        timestamps=timestamps)
