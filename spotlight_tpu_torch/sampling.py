"""Alias module of the original library's ``spotlight.sampling`` path."""

from spotlight_tpu_torch.ops.sampling import (  # noqa: F401
    sample_items,
    sample_items_device,
)
