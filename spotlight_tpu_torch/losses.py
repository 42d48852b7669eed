"""Alias module of the original library's ``spotlight.losses`` path."""

from spotlight_tpu_torch.ops.losses import (  # noqa: F401
    adaptive_hinge_loss,
    bpr_loss,
    hinge_loss,
    logistic_loss,
    pointwise_loss,
    poisson_loss,
    regression_loss,
)
