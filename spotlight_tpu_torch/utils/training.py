"""Training helpers shared by the estimators.

Counterpart of the device-independent helpers of
``spotlight_tpu/utils/training.py``.  The training engine itself (optimizer,
epoch loop, loss drain) belongs to the training slice of the port.
"""

from __future__ import annotations

import numpy as np
import torch


def generator_from_random_state(random_state):
    """A ``torch.Generator`` seeded from a numpy RandomState.

    Counterpart of ``key_from_random_state``: one ``randint(0, 2**31 - 1)``
    draw seeds the generator, so the caller's RandomState advances exactly
    as it does in the JAX package.  The generator lives on the CPU;
    parameters are drawn there and then moved to their device, so the same
    seed gives the same initial values on every device.
    """
    generator = torch.Generator()
    generator.manual_seed(int(random_state.randint(0, 2 ** 31 - 1)))
    return generator


def pad_array(array, padded_length):
    """Pad the leading axis with zeros up to ``padded_length``."""
    pad = padded_length - array.shape[0]
    if pad == 0:
        return array
    pad_width = [(0, pad)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_width)
