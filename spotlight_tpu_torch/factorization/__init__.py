"""Factorization models (explicit and implicit feedback)."""

from spotlight_tpu_torch.factorization.explicit import (  # noqa: F401
    ExplicitFactorizationModel,
)
from spotlight_tpu_torch.factorization.implicit import (  # noqa: F401
    ImplicitFactorizationModel,
)
from spotlight_tpu_torch.factorization.representations import (  # noqa: F401
    BilinearNet,
)
