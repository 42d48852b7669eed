"""Alias for :mod:`spotlight_tpu_torch.data.movielens`."""

from spotlight_tpu_torch.data.movielens import (  # noqa: F401
    VARIANTS,
    get_movielens_dataset,
)
