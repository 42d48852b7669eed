"""Vectorized MurmurHash3 (32-bit) on the host.

Counterpart of ``murmurhash3_32`` in ``spotlight_tpu/ops/hashing.py``, copied
so that the port does not import the JAX module (which imports
``jax.numpy``).  Bit-compatible with ``sklearn.utils.murmurhash3_32`` on
int32 keys; user-based splits use it.  The in-graph hashes behind bloom
embeddings belong to the bloom slice of the port.
"""

from __future__ import annotations

import numpy as np

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def murmurhash3_32(keys, seed=0, positive=False):
    """MurmurHash3 32-bit hash of int32 keys (vectorized numpy, host-side).

    Parameters
    ----------
    keys : array-like of int32
    seed : int
    positive : bool
        If True, return uint32 values; otherwise int32 (two's complement).
    """
    k = np.asarray(keys).astype(np.uint32)
    with np.errstate(over='ignore'):
        k = (k * _C1) & 0xFFFFFFFF
        k = ((k << np.uint32(15)) | (k >> np.uint32(17))) & 0xFFFFFFFF
        k = (k * _C2) & 0xFFFFFFFF

        h = np.uint32(seed & 0xFFFFFFFF) ^ k
        h = ((h << np.uint32(13)) | (h >> np.uint32(19))) & 0xFFFFFFFF
        h = (h * np.uint32(5) + np.uint32(0xE6546B64)) & 0xFFFFFFFF

        # Finalization: fold in the key length (4 bytes) and avalanche.
        h ^= np.uint32(4)
        h ^= h >> np.uint32(16)
        h = (h * np.uint32(0x85EBCA6B)) & 0xFFFFFFFF
        h ^= h >> np.uint32(13)
        h = (h * np.uint32(0xC2B2AE35)) & 0xFFFFFFFF
        h ^= h >> np.uint32(16)

    if positive:
        return h
    return h.astype(np.int32)
