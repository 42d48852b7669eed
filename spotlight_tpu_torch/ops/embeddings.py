"""Embedding layers for recommender models.

Counterpart of ``spotlight_tpu/ops/embeddings.py`` as ``nn.Module``s:

- :class:`ScaledEmbedding`: init N(0, 1) / embedding_dim, as the JAX
  package draws it; optional padding row.
- :class:`ZeroEmbedding`: zero-initialized (bias tables).
- :class:`FusedBiasEmbedding`: factors and bias in one
  ``(num_embeddings, embedding_dim + 1)`` table, the bias in column D.
- :class:`ScaledEmbeddingBag`: a gather and a sum per bag.
- :class:`BloomEmbedding`: a compressed table; each id is hashed by
  ``num_hash_functions`` murmurhash seeds onto its rows, which are gathered
  and summed.

``padding_idx`` is applied at lookup time: the padding row reads as zeros
and so receives no gradient, as in the JAX package.  Parameters are drawn
on the CPU from the caller's ``torch.Generator`` and then moved to
``device``.

The bag and bloom lookups are a plain gather, mask and sum, as the JAX
package keeps them: its gather-sum kernels are separate entry points
(:mod:`spotlight_tpu_torch.ops.kernels.bloom`,
:mod:`spotlight_tpu_torch.ops.kernels.multihot`) that no layer calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from spotlight_tpu_torch.ops.hashing import SEEDS, bloom_hash

PADDING_IDX = 0


def _masked_gather(weight, ids, padding_idx):
    """Gather rows; rows of ``padding_idx`` read as zero vectors.

    ``F.embedding`` and not ``weight[ids]``: its backward sums each row's
    contributions without atomics (``index_put_``'s accumulation does not
    repeat its bits from run to run), so dense training is reproducible."""
    vectors = F.embedding(ids, weight)
    if padding_idx is not None:
        vectors = torch.where((ids == padding_idx)[..., None],
                              torch.zeros((), dtype=vectors.dtype,
                                          device=vectors.device),
                              vectors)
    return vectors


def _normal_factors(num_embeddings, embedding_dim, generator):
    return (torch.randn(num_embeddings, embedding_dim, generator=generator)
            / embedding_dim)


class ScaledEmbedding(nn.Module):
    """Embedding table initialized from N(0, 1) / embedding_dim.

    Parameters
    ----------
    num_embeddings : int
    embedding_dim : int
    padding_idx : int, optional
        If set, that row starts at zero and reads as zero at lookup.
    sparse : bool
        Accepted for API parity.
    """

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, generator=None, device='cpu',
                 dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        weight = _normal_factors(num_embeddings, embedding_dim, generator)
        if padding_idx is not None:
            weight[padding_idx] = 0.0
        self.weight = nn.Parameter(weight.to(device=device, dtype=dtype))

    def forward(self, ids):
        return _masked_gather(self.weight, ids, self.padding_idx)


class ZeroEmbedding(nn.Module):
    """Zero-initialized embedding table (used for bias terms)."""

    def __init__(self, num_embeddings, embedding_dim=1, padding_idx=None,
                 sparse=False, device='cpu', dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        self.weight = nn.Parameter(torch.zeros(
            num_embeddings, embedding_dim, device=device, dtype=dtype))

    def forward(self, ids):
        return _masked_gather(self.weight, ids, self.padding_idx)


class FusedBiasEmbedding(nn.Module):
    """Factor table with its bias packed into the last column.

    Columns ``[:D]`` are the N(0, 1) / D factors and column ``D`` the
    zero-initialized bias: one row gather serves both.
    """

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, generator=None, device='cpu',
                 dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.sparse = sparse
        weight = torch.cat(
            [_normal_factors(num_embeddings, embedding_dim, generator),
             torch.zeros(num_embeddings, 1)], dim=1)
        if padding_idx is not None:
            weight[padding_idx] = 0.0
        self.weight = nn.Parameter(weight.to(device=device, dtype=dtype))

    @property
    def table_width(self):
        return self.embedding_dim + 1

    def forward(self, ids):
        """Gather ``(..., embedding_dim + 1)`` rows (factors ++ bias) in
        float32, whatever the table dtype."""
        return self.apply_raw(ids).float()

    def apply_raw(self, ids):
        """Gather rows in the table's storage dtype (no upcast): a bf16
        table streams as bf16 through the evaluation kernels, whose
        in-tile upcast is value-exact."""
        return _masked_gather(self.weight, ids, self.padding_idx)


class ScaledEmbeddingBag(nn.Module):
    """Embedding table whose lookup sums a bag of rows (torch's
    ``nn.EmbeddingBag`` with ``mode='sum'``), initialised from
    N(0, 1) / embedding_dim.

    Parameters
    ----------
    num_embeddings : int
    embedding_dim : int
    mode : str
        Only ``'sum'``.
    sparse : bool
        Accepted for API parity.
    """

    def __init__(self, num_embeddings, embedding_dim, mode='sum',
                 sparse=False, generator=None, device='cpu',
                 dtype=torch.float32):
        super().__init__()
        if mode != 'sum':
            raise ValueError("Only mode='sum' is supported "
                             '(the reference uses no other mode).')
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.mode = mode
        self.sparse = sparse
        weight = _normal_factors(num_embeddings, embedding_dim, generator)
        self.weight = nn.Parameter(weight.to(device=device, dtype=dtype))

    def forward(self, ids, offsets=None):
        """Sum embedding rows per bag.

        Without ``offsets``, ``ids`` is ``(..., bag_size)`` and the rows are
        summed over its last axis.  With ``offsets`` (bag starts into the
        flat ``ids``), bag ``b`` covers ``ids[offsets[b]:offsets[b + 1]]``:
        each position belongs to the last offset at or before it, and
        positions before ``offsets[0]`` to no bag, as the JAX package's
        ``searchsorted`` and ``segment_sum`` have it.
        """
        if offsets is None:
            return self.weight[ids].sum(dim=-2)
        ids = ids.reshape(-1)
        offsets = offsets.reshape(-1)
        positions = torch.arange(ids.shape[0], device=ids.device)
        segments = torch.searchsorted(offsets, positions, right=True) - 1
        keep = segments >= 0
        out = torch.zeros(offsets.shape[0], self.embedding_dim,
                          dtype=self.weight.dtype, device=self.weight.device)
        return out.index_add(0, segments[keep], self.weight[ids[keep]])


class BloomEmbedding(nn.Module):
    """Bloom-filter-compressed embedding table.

    Each id is hashed by ``num_hash_functions`` murmurhash3 seeds onto
    ``int(compression_ratio * num_embeddings)`` rows; the hashed rows are
    gathered and summed (Serra & Karatzoglou, "Getting deep recommenders
    fit: Bloom embeddings for sparse binary input/output networks", 2017).

    With ``padding_idx`` set, row 0 starts at zero and every hashed row
    equal to 0 contributes a zero vector: the padding id hashes to row 0
    under every seed, and a real id that collides into row 0 contributes
    nothing there, as in the JAX package.

    Parameters
    ----------
    num_embeddings : int
    embedding_dim : int
    compression_ratio : float
    num_hash_functions : int, at most ``len(SEEDS)``
    padding_idx : int or None
    bag, sparse : bool
        Accepted for API parity.
    """

    def __init__(self, num_embeddings, embedding_dim, compression_ratio=0.2,
                 num_hash_functions=4, padding_idx=PADDING_IDX, bag=False,
                 sparse=False, generator=None, device='cpu',
                 dtype=torch.float32):
        super().__init__()
        if num_hash_functions > len(SEEDS):
            raise ValueError('Can use at most {} hash functions ({} requested)'
                             .format(len(SEEDS), num_hash_functions))
        if num_hash_functions < 1:
            raise ValueError('num_hash_functions must be >= 1 (got {})'
                             .format(num_hash_functions))
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.compression_ratio = compression_ratio
        self.num_hash_functions = num_hash_functions
        self.padding_idx = padding_idx
        self.bag = bag
        self.sparse = sparse
        rows = self.compressed_num_embeddings
        if rows < 1:
            raise ValueError(
                'compression_ratio {} of {} embeddings gives a compressed '
                'table of {} rows; need at least 1 (raise the ratio or the '
                'table size).'.format(compression_ratio, num_embeddings,
                                      rows))
        weight = _normal_factors(rows, embedding_dim, generator)
        if padding_idx is not None:
            weight[0] = 0.0
        self.weight = nn.Parameter(weight.to(device=device, dtype=dtype))

    @property
    def compressed_num_embeddings(self):
        return int(self.compression_ratio * self.num_embeddings)

    def hashed_rows(self, ids):
        """int32 row indices of shape ``ids.shape + (num_hash_functions,)``,
        on the ids' device."""
        return bloom_hash(ids, self.num_hash_functions,
                          self.compressed_num_embeddings,
                          padding_idx=self.padding_idx)

    def forward(self, ids):
        rows = self.hashed_rows(ids)
        vectors = self.weight[rows]
        if self.padding_idx is not None:
            # Row 0 is the padding row: zero contribution, no gradient.
            vectors = torch.where((rows == 0)[..., None],
                                  torch.zeros((), dtype=vectors.dtype,
                                              device=vectors.device),
                                  vectors)
        return vectors.sum(dim=-2)
