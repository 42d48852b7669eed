"""The distributed layer on ``torch.distributed``.

Counterpart of ``spotlight_tpu/parallel``: a ``(data, model)`` mesh of
ranks (:mod:`~spotlight_tpu_torch.parallel.mesh`), the row layout of tables
over it (:mod:`~spotlight_tpu_torch.parallel.sharding`) and full-catalogue
evaluation over a row-sharded catalogue
(:mod:`~spotlight_tpu_torch.parallel.evaluation`), through the same kernels
as one device.  One process a rank: NCCL on cards, gloo for CPU process
groups.  Sharded embedding tables, distributed training, checkpoints and
the multi-host helpers are not ported yet (ROADMAP.md, Queue 1).
"""

from spotlight_tpu_torch.parallel.evaluation import (  # noqa: F401
    sharded_candidate_scores,
    sharded_rank_counts,
    sharded_rank_weights,
    sharded_topk,
)
from spotlight_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from spotlight_tpu_torch.parallel.sharding import shard_params  # noqa: F401
