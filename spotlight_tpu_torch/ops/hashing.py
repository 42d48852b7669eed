"""Vectorized MurmurHash3 (32-bit): on the host with numpy, and on int
tensors with PyTorch, on the ids' device.

Counterpart of ``spotlight_tpu/ops/hashing.py``, copied so that the port
does not import the JAX module (which imports ``jax.numpy``).  Both are
bit-compatible with ``sklearn.utils.murmurhash3_32`` on int32 keys: the
numpy hash serves user-based splits, :func:`bloom_hash` the bloom
embeddings.

PyTorch's ``uint32`` has almost no arithmetic, so the tensor hash runs in
int64 holding 32-bit values.  A product of two such values can pass 2^63
(``0xFFFFFFFF * 0xCC9E2D51`` is about 1.5e19), so each multiply by a
constant is split into its 16-bit halves and every step is masked back to
32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

# The 24 fixed prime seeds of the reference's bloom embeddings.
SEEDS = (
    179424941, 179425457, 179425907, 179426369,
    179424977, 179425517, 179425943, 179426407,
    179424989, 179425529, 179425993, 179426447,
    179425003, 179425537, 179426003, 179426453,
    179425019, 179425559, 179426029, 179426491,
    179425027, 179425579, 179426081, 179426549,
)

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MASK = 0xFFFFFFFF


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


def _mul32(x, constant):
    """``x * constant`` modulo 2^32 for int64 ``x`` in [0, 2^32): each
    partial product stays below 2^49."""
    low = x * (constant & 0xFFFF)
    high = ((x * (constant >> 16)) & 0xFFFF) << 16
    return (low + high) & _MASK


def _rotl32(x, shift):
    return ((x << shift) | (x >> (32 - shift))) & _MASK


def murmurhash3_32_torch(keys, seed):
    """MurmurHash3 32-bit hash of int32 keys, on the keys' device.

    Parameters
    ----------
    keys : int tensor of any shape; cast to int32 first, as the JAX
        package casts them
    seed : int

    Returns
    -------
    int64 tensor of the unsigned 32-bit hashes, in [0, 2^32).
    """
    k = keys.to(torch.int32).to(torch.int64) & _MASK
    k = _mul32(k, _C1)
    k = _rotl32(k, 15)
    k = _mul32(k, _C2)

    h = (seed & _MASK) ^ k
    h = _rotl32(h, 13)
    h = (h * 5 + 0xE6546B64) & _MASK

    h = h ^ 4
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def bloom_hash(ids, num_hashes, compressed_size, padding_idx=0):
    """Map ids to ``num_hashes`` bloom rows each, on the ids' device.

    Id ``padding_idx`` maps to row 0 under every hash function; every other
    id to ``murmurhash3_32(id, SEEDS[j]) % compressed_size``, where the hash
    is the *signed* int32 value and ``%`` takes the divisor's sign (numpy's
    and ``jnp.mod``'s convention, ``torch.remainder`` here), as the
    reference's precomputed hash table has it.

    Parameters
    ----------
    ids : int tensor of any shape
    num_hashes : int
    compressed_size : int
    padding_idx : int or None

    Returns
    -------
    int32 tensor of shape ``ids.shape + (num_hashes,)``, as the JAX
    package's ``bloom_hash_jnp`` returns.
    """
    ids = ids.to(torch.int32)
    hashes = torch.stack(
        [murmurhash3_32_torch(ids, seed) for seed in SEEDS[:num_hashes]],
        dim=-1)
    signed = torch.where(hashes >= 2 ** 31, hashes - 2 ** 32, hashes)
    rows = torch.remainder(signed, compressed_size)
    if padding_idx is not None:
        rows = torch.where((ids == padding_idx)[..., None],
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device), rows)
    return rows.to(torch.int32)
