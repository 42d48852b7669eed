"""Alias module of the original library's ``spotlight.layers`` path."""

from spotlight_tpu_torch.ops.embeddings import (  # noqa: F401
    BloomEmbedding,
    PADDING_IDX,
    ScaledEmbedding,
    ScaledEmbeddingBag,
    ZeroEmbedding,
)
from spotlight_tpu_torch.ops.hashing import SEEDS  # noqa: F401
