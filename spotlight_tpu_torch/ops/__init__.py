"""Compute ops: embeddings, losses, sampling, hashing, and the hand-written
CUDA kernels."""

from spotlight_tpu_torch.ops.embeddings import (  # noqa: F401
    BloomEmbedding,
    ScaledEmbedding,
    ScaledEmbeddingBag,
    ZeroEmbedding,
)
from spotlight_tpu_torch.ops.losses import (  # noqa: F401
    adaptive_hinge_loss,
    bpr_loss,
    hinge_loss,
    logistic_loss,
    pointwise_loss,
    poisson_loss,
    regression_loss,
)
from spotlight_tpu_torch.ops.sampling import (  # noqa: F401
    sample_items,
    sample_items_device,
)
