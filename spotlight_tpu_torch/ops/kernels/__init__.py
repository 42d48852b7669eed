"""Hand-written CUDA kernels of the evaluation path, with their plain
PyTorch versions.

- :func:`~spotlight_tpu_torch.ops.kernels.ranking.rank_weights`: fused
  catalogue scoring and combined average-tie rank weights (needs matched
  target scores, :func:`~spotlight_tpu_torch.ops.kernels.ranking.
  matched_target_scores`).
- :func:`~spotlight_tpu_torch.ops.kernels.topk.streaming_topk`: fused
  scoring and an exact top-k (the precision@k path).
"""

from spotlight_tpu_torch.ops.kernels.ranking import rank_weights  # noqa: F401
from spotlight_tpu_torch.ops.kernels.topk import streaming_topk  # noqa: F401
