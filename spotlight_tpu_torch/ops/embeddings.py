"""Embedding layers for recommender models.

Counterpart of ``spotlight_tpu/ops/embeddings.py`` as ``nn.Module``s:

- :class:`ScaledEmbedding`: init N(0, 1) / embedding_dim, as the JAX
  package draws it; optional padding row.
- :class:`ZeroEmbedding`: zero-initialized (bias tables).
- :class:`FusedBiasEmbedding`: factors and bias in one
  ``(num_embeddings, embedding_dim + 1)`` table, the bias in column D.

``padding_idx`` is applied at lookup time: the padding row reads as zeros
and so receives no gradient, as in the JAX package.  Parameters are drawn
on the CPU from the caller's ``torch.Generator`` and then moved to
``device``.  Bag and bloom layers belong to the bloom slice of the port.
"""

from __future__ import annotations

import torch
from torch import nn

PADDING_IDX = 0


def _masked_gather(weight, ids, padding_idx):
    """Gather rows; rows of ``padding_idx`` read as zero vectors."""
    vectors = weight[ids]
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
