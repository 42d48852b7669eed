"""The distributed layer on ``torch.distributed``.

Counterpart of ``spotlight_tpu/parallel``, one process a rank (NCCL on
cards, gloo for CPU process groups), every rank making the same calls:

- :mod:`~spotlight_tpu_torch.parallel.mesh`: a ``(data, model)`` grid of
  ranks and its collectives;
- :mod:`~spotlight_tpu_torch.parallel.sharding`: the row layout of tables
  over the model axis, the row-sharded embedding layers
  (:class:`ShardedEmbedding`, :class:`ShardedBloomEmbedding`) and their
  three exchanges;
- :mod:`~spotlight_tpu_torch.parallel.training`: data-parallel training
  over the data axis, each rank holding its blocks of the tables and of
  their Adam moments: the dense engine's step, and the two helpers of the
  row-sparse (lazy) engines' steps (the role-ordered gather, the update of
  a rank's own rows);
- :mod:`~spotlight_tpu_torch.parallel.evaluation`: full-catalogue
  evaluation over a row-sharded catalogue, through the same kernels as one
  device;
- :mod:`~spotlight_tpu_torch.parallel.checkpoint`: sharded checkpoints
  (``torch.distributed.checkpoint``), each rank writing its blocks,
  restored onto any layout;
- :mod:`~spotlight_tpu_torch.parallel.multihost`: joining the process
  group (``initialize``), ``is_primary`` and the global batch of the ranks'
  slices.
"""

from spotlight_tpu_torch.parallel import checkpoint, multihost  # noqa: F401
from spotlight_tpu_torch.parallel.evaluation import (  # noqa: F401
    sharded_candidate_scores,
    sharded_rank_counts,
    sharded_rank_weights,
    sharded_topk,
)
from spotlight_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from spotlight_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardedBloomEmbedding,
    ShardedEmbedding,
    shard_params,
)
