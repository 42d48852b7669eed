"""Alias for :mod:`spotlight_tpu_torch.data.amazon`."""

from spotlight_tpu_torch.data.amazon import get_amazon_dataset  # noqa: F401
