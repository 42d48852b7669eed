"""Goodbooks-10K dataset fetcher.

Counterpart of ``spotlight_tpu/data/goodbooks.py``.
"""

from __future__ import annotations

import numpy as np

from spotlight_tpu_torch.data.interactions import Interactions
from spotlight_tpu_torch.data.transport import fetch_hdf5_columns

_URL = ('https://github.com/zygmuntz/goodbooks-10k/'
        'releases/download/v1.0/goodbooks-10k.hdf5')


def get_goodbooks_dataset():
    """Download (or read from cache) the goodbooks-10k dataset.

    The file stores a single ``ratings`` matrix with (user, book, rating)
    columns; interaction order stands in for timestamps.

    Returns
    -------
    :class:`~spotlight_tpu_torch.data.interactions.Interactions`
    """
    (ratings_matrix,) = fetch_hdf5_columns(
        _URL, 'goodbooks', 'goodbooks.hdf5', ('ratings',))
    return Interactions(
        ratings_matrix[:, 0],
        ratings_matrix[:, 1],
        ratings=ratings_matrix[:, 2].astype(np.float32),
        timestamps=np.arange(len(ratings_matrix), dtype=np.int32))
