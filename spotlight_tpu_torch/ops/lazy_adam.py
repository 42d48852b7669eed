"""Row-sparse (lazy) Adam: moments updated at the touched rows only.

Counterpart of ``spotlight_tpu/ops/lazy_adam.py``.  The index preparation
is one stable sort of the occurrence ids (torch's, as JAX's ``argsort``);
the segment sums and the update run through P1
(:mod:`spotlight_tpu_torch.ops.kernels.row_update`), which reads the sort's
output directly: the hand-written kernel on a CUDA tensor (one launch, no
readback), its plain version on a CPU tensor.  Tables and moments are
updated in place.

Semantics, as in the JAX package (torch's ``SparseAdam``): untouched rows'
moments do not decay between the steps that touch them; the bias
correction uses the global step count; ``l2`` adds the coupled weight decay
``l2 * row`` once per distinct row and only when ``l2 != 0``.  Every
occurrence counts, the padding rows' too: a padded example's ids carry a
zero gradient row, and their rows still take a momentum step (moments
decay, parameters move by ``m_hat / sqrt(v_hat)``), as in JAX.

One deliberate difference: an id outside ``[0, R)`` updates nothing.  JAX
drops ``R`` (its mesh engine's "not mine" sentinel) but wraps a negative id
onto row ``R + id``; no engine produces one.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.kernels import row_update
from spotlight_tpu_torch.utils.training import B1, B2, EPS


def lazy_adam_init(params):
    """Optimizer state: float32 moments shaped like each parameter
    (allocated once, touched sparsely; float32 even for a bfloat16 table)
    and the global step counter ``t``, a host int."""
    def zeros32(param):
        return torch.zeros(param.shape, dtype=torch.float32,
                           device=param.device)

    return {'mu': {name: zeros32(p) for name, p in params.items()},
            'nu': {name: zeros32(p) for name, p in params.items()},
            't': 0}


def sparse_adam_rows(ids, param, mu, nu, grad_rows, t, lr, l2=0.0, b1=B1,
                     b2=B2, eps=EPS):
    """Adam restricted to the rows named by ``ids``, in place.

    Parameters
    ----------
    ids : int tensor, any shape -- occurrence row ids, repeats allowed
    param : (num_rows, width) float32 or bfloat16 table
    mu, nu : (num_rows, width) float32 moments
    grad_rows : ``ids.shape + (width,)`` per-occurrence gradient rows
    t : int -- the global Adam step (1 for the first)

    Returns
    -------
    (param, mu, nu), the same tensors, updated.
    """
    sorted_ids, order = row_update.sort_occurrences(ids)
    grads = grad_rows.reshape(order.numel(), -1).to(
        torch.float32).contiguous()
    scalars = row_update.adam_scalars(t, lr, l2, b1, b2, eps)
    return row_update.row_adam(param, mu, nu, grads, sorted_ids, order,
                               scalars)
