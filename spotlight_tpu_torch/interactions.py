"""Alias module of the original library's ``spotlight.interactions`` path."""

from spotlight_tpu_torch.data.interactions import (  # noqa: F401
    Interactions,
    PADDING_IDX,
    SequenceInteractions,
)
