"""Factorization models (implicit feedback)."""

from spotlight_tpu_torch.factorization.implicit import (  # noqa: F401
    ImplicitFactorizationModel,
)
from spotlight_tpu_torch.factorization.representations import (  # noqa: F401
    BilinearNet,
)
