"""Alias for :mod:`spotlight_tpu_torch.data.synthetic`."""

from spotlight_tpu_torch.data.synthetic import (  # noqa: F401
    generate_factorization,
    generate_sequential,
)
