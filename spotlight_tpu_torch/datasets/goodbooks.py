"""Alias for :mod:`spotlight_tpu_torch.data.goodbooks`."""

from spotlight_tpu_torch.data.goodbooks import (  # noqa: F401
    get_goodbooks_dataset,
)
