"""Compute ops: embeddings, hashing, and the hand-written CUDA kernels."""

from spotlight_tpu_torch.ops.embeddings import (  # noqa: F401
    ScaledEmbedding,
    ZeroEmbedding,
)
