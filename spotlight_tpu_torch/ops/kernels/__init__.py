"""Hand-written CUDA kernels, with their plain PyTorch versions.

- :func:`~spotlight_tpu_torch.ops.kernels.ranking.rank_weights`: fused
  catalogue scoring and combined average-tie rank weights, with dot or
  mixture-of-tastes scoring (needs matched scores of the targets,
  :func:`~spotlight_tpu_torch.ops.kernels.ranking.matched_target_scores`
  or :func:`~spotlight_tpu_torch.ops.kernels.ranking.
  matched_candidate_scores`).
- :func:`~spotlight_tpu_torch.ops.kernels.ranking.rank_counts`: separate
  greater and equal counts over the catalogue, the target excluded by id,
  and :func:`~spotlight_tpu_torch.ops.kernels.ranking.
  reciprocal_ranks_streaming` on top of it.
- :func:`~spotlight_tpu_torch.ops.kernels.topk.streaming_topk`: fused
  scoring and an exact top-k (the precision@k path), with dot or
  mixture-of-tastes scoring.
- :func:`~spotlight_tpu_torch.ops.kernels.bloom.bloom_gather_sum` and
  :func:`~spotlight_tpu_torch.ops.kernels.multihot.multihot_gather_sum`:
  the bloom gather-sum, each with a deterministic backward.
- :func:`~spotlight_tpu_torch.ops.kernels.row_update.row_adam`: Adam on the
  rows named by occurrence ids, in place (the lazy training engine's row
  update, through :func:`~spotlight_tpu_torch.ops.lazy_adam.
  sparse_adam_rows`).
"""

from spotlight_tpu_torch.ops.kernels.bloom import bloom_gather_sum  # noqa: F401
from spotlight_tpu_torch.ops.kernels.multihot import (  # noqa: F401
    multihot_gather_sum)
from spotlight_tpu_torch.ops.kernels.ranking import (  # noqa: F401
    rank_counts, rank_weights, reciprocal_ranks_streaming)
from spotlight_tpu_torch.ops.kernels.row_update import row_adam  # noqa: F401
from spotlight_tpu_torch.ops.kernels.topk import streaming_topk  # noqa: F401
