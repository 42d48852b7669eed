"""Latent representations for factorization models.

Counterpart of ``spotlight_tpu/factorization/representations.py``: the
:class:`BilinearNet` scores a (user, item) pair as the dot product of their
latent vectors plus per-user and per-item biases.

Two scoring paths, as in the JAX package:

- :meth:`BilinearNet.forward`: elementwise pair scoring (the JAX
  ``apply``; ``nn.Module.apply`` already names another method);
- :meth:`BilinearNet.score_catalog`: a batch of users against the whole
  catalogue as one matrix product.

With the default layers each side keeps one fused table of width
``embedding_dim + 1`` whose last column is the bias
(:class:`~spotlight_tpu_torch.ops.embeddings.FusedBiasEmbedding`);
``fused=False`` selects the four-table layout.  The training paths score
positives with sampled negatives (:meth:`BilinearNet.apply_with_negatives`)
or with in-batch negatives
(:meth:`BilinearNet.apply_with_inbatch_negatives`).
:meth:`BilinearNet.sharded` wraps the tables in the row-sharded layers of
:mod:`spotlight_tpu_torch.parallel.sharding` for training on a mesh; a
network whose tables are this rank's blocks scores the rank's block of the
catalogue (:meth:`BilinearNet.item_factors`) and gathers whole-catalogue
scores over the model axis (:meth:`BilinearNet.score_catalog`).
"""

from __future__ import annotations

import torch
from torch import nn

from spotlight_tpu_torch.ops.embeddings import (BloomEmbedding,
                                                FusedBiasEmbedding,
                                                ScaledEmbedding, ZeroEmbedding)
from spotlight_tpu_torch.parallel.sharding import (ShardedBloomEmbedding,
                                                   ShardedEmbedding,
                                                   holds_blocks,
                                                   network_specs)


class BilinearNet(nn.Module):
    """Bilinear factorization representation.

    Parameters
    ----------
    num_users : int
    num_items : int
    embedding_dim : int, optional
    user_embedding_layer, item_embedding_layer : nn.Module, optional
        Custom embedding layers; injecting any custom layer selects the
        four-table layout.
    sparse : bool
        Accepted for API parity.
    user_bias_layer, item_bias_layer : nn.Module, optional
    fused : bool, optional
        Force the fused-bias layout on (True) or off (False).  Default
        (None): fused exactly when no custom layers are injected.
    table_dtype : torch.dtype, optional
        Storage dtype of the fused tables (float32 or bfloat16).  Scores
        are always computed in float32.  Only the fused layout honours it.
    generator : torch.Generator, optional
        Source of the initial factors.
    device : str or torch.device
    """

    def __init__(self, num_users, num_items, embedding_dim=32,
                 user_embedding_layer=None, item_embedding_layer=None,
                 sparse=False, user_bias_layer=None, item_bias_layer=None,
                 fused=None, table_dtype=torch.float32, generator=None,
                 device='cpu'):
        super().__init__()
        if table_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError('table_dtype must be torch.float32 or '
                             'torch.bfloat16 (got {})'.format(table_dtype))
        self.num_users = num_users
        self.num_items = num_items
        self.embedding_dim = embedding_dim
        self.sparse = sparse
        self.table_dtype = table_dtype
        if fused is None:
            fused = (user_embedding_layer is None
                     and item_embedding_layer is None
                     and user_bias_layer is None
                     and item_bias_layer is None)
        self.fused = fused

        if fused:
            self.user_embeddings = user_embedding_layer or FusedBiasEmbedding(
                num_users, embedding_dim, generator=generator, device=device,
                dtype=table_dtype)
            self.item_embeddings = item_embedding_layer or FusedBiasEmbedding(
                num_items, embedding_dim, generator=generator, device=device,
                dtype=table_dtype)
            return

        self.user_embeddings = user_embedding_layer or ScaledEmbedding(
            num_users, embedding_dim, generator=generator, device=device)
        self.item_embeddings = item_embedding_layer or ScaledEmbedding(
            num_items, embedding_dim, generator=generator, device=device)
        self.user_biases = user_bias_layer or ZeroEmbedding(
            num_users, 1, device=device)
        self.item_biases = item_bias_layer or ZeroEmbedding(
            num_items, 1, device=device)

    def forward(self, user_ids, item_ids):
        """Score (user, item) pairs elementwise.

        ``user_ids`` and ``item_ids`` have the same shape; so has the
        result.
        """
        if self.fused:
            dim = self.embedding_dim
            u = self.user_embeddings(user_ids).float()
            i = self.item_embeddings(item_ids).float()
            return ((u[..., :dim] * i[..., :dim]).sum(dim=-1)
                    + u[..., dim] + i[..., dim])

        users = self.user_embeddings(user_ids)
        items = self.item_embeddings(item_ids)
        u_bias = self.user_biases(user_ids)[..., 0]
        i_bias = self.item_biases(item_ids)[..., 0]
        return (users * items).sum(dim=-1) + u_bias + i_bias

    def apply_with_negatives(self, user_ids, item_ids, negative_item_ids):
        """Score positives and sampled negatives with one user-row gather
        and one stacked item-row gather.

        Parameters
        ----------
        user_ids, item_ids : (B,) int
        negative_item_ids : (B,) or (n, B) int

        Returns
        -------
        (positive_scores, negative_scores), shaped (B,) and like
        ``negative_item_ids``.
        """
        stacked = negative_item_ids.dim() == item_ids.dim() + 1
        negatives = (negative_item_ids if stacked
                     else negative_item_ids[None])
        all_items = torch.cat([item_ids[None], negatives], dim=0)

        if self.fused:
            dim = self.embedding_dim
            u = self.user_embeddings(user_ids)
            iv = self.item_embeddings(all_items)
            dots = ((u[None, ..., :dim] * iv[..., :dim]).sum(dim=-1)
                    + u[None, ..., dim] + iv[..., dim])
        else:
            users = self.user_embeddings(user_ids)
            u_bias = self.user_biases(user_ids)[..., 0]
            vectors = self.item_embeddings(all_items)
            biases = self.item_biases(all_items)[..., 0]
            dots = (users[None] * vectors).sum(dim=-1) + biases + u_bias
        positive = dots[0]
        negative = dots[1:] if stacked else dots[1]
        return positive, negative

    def apply_with_inbatch_negatives(self, user_ids, item_ids,
                                     num_negatives=1):
        """Score positives against in-batch negatives: the negatives of
        example ``b`` are the positive items of the examples 1..n places
        before it (a circular shift of the gathered rows), so no negative
        row is gathered.

        Returns
        -------
        (positive, negative) : (B,) and ((B,) if ``num_negatives == 1``
            else (num_negatives, B)) scores.
        """
        if self.fused:
            dim = self.embedding_dim
            u = self.user_embeddings(user_ids)
            iv = self.item_embeddings(item_ids)
            uf, ub = u[..., :dim], u[..., dim]
            positive = (uf * iv[..., :dim]).sum(dim=-1) + ub + iv[..., dim]
            negatives = []
            for shift in range(1, num_negatives + 1):
                nv = torch.roll(iv, shift, dims=0)
                negatives.append(
                    (uf * nv[..., :dim]).sum(dim=-1) + ub + nv[..., dim])
        else:
            users = self.user_embeddings(user_ids)
            u_bias = self.user_biases(user_ids)[..., 0]
            items = self.item_embeddings(item_ids)
            i_bias = self.item_biases(item_ids)[..., 0]
            positive = (users * items).sum(dim=-1) + u_bias + i_bias
            negatives = []
            for shift in range(1, num_negatives + 1):
                nv = torch.roll(items, shift, dims=0)
                nb = torch.roll(i_bias, shift, dims=0)
                negatives.append((users * nv).sum(dim=-1) + u_bias + nb)
        if num_negatives == 1:
            return positive, negatives[0]
        return positive, torch.stack(negatives, dim=0)

    def sharded(self, axis='model', num_shards=1, exchange='psum', mesh=None):
        """A variant of this network with every embedding table row-sharded
        over the mesh axis ``axis`` of ``mesh``
        (:mod:`spotlight_tpu_torch.parallel.sharding`), holding the whole
        padded tables until the caller puts its blocks in their place.

        The fused layout shards its two fused tables (one exchange per
        side instead of two); the classic layout wraps each of its four
        tables, bloom layers through their compressed table
        (``ShardedBloomEmbedding``); other injected layers stay replicated.
        """
        def wrap(layer):
            kind = (ShardedBloomEmbedding if isinstance(layer, BloomEmbedding)
                    else ShardedEmbedding if isinstance(
                        layer, (ScaledEmbedding, ZeroEmbedding,
                                FusedBiasEmbedding))
                    else None)
            if kind is None:
                return layer
            return kind(layer, axis=axis, num_shards=num_shards,
                        exchange=exchange, mesh=mesh)

        layers = dict(user_embedding_layer=wrap(self.user_embeddings),
                      item_embedding_layer=wrap(self.item_embeddings))
        if not self.fused:
            layers.update(user_bias_layer=wrap(self.user_biases),
                          item_bias_layer=wrap(self.item_biases))
        return BilinearNet(self.num_users, self.num_items,
                           self.embedding_dim, sparse=self.sparse,
                           fused=self.fused, table_dtype=self.table_dtype,
                           **layers)

    def param_specs(self):
        """PartitionSpec of every parameter, by its name in
        ``named_parameters()``: sharded tables' rows over their axis, the
        rest replicated."""
        return network_specs(self)

    def _holds_blocks(self):
        """Whether the item table is this rank's block of the catalogue
        (trained on a mesh), not the whole padded table."""
        return holds_blocks(self.item_embeddings)

    def item_factors(self):
        """Dense ``(num_items, dim)`` factor matrix and ``(num_items,)``
        float32 bias vector: the inputs of catalogue scoring and of the
        evaluation kernels.  A bf16 fused table keeps its dtype here.

        On a network whose tables are this rank's blocks (trained on a
        mesh), this rank's block of the padded catalogue instead:
        ``rows_per_shard`` rows from ``model index x rows_per_shard``, the
        padded rows zero.  Every rank of the model axis calls alike."""
        if self._holds_blocks():
            rows = self.item_embeddings.block_rows()
            if self.fused:
                dim = self.embedding_dim
                return rows[:, :dim].contiguous(), rows[:, dim].float()
            bias = self.item_biases.block_rows()
            return rows, bias[:, 0]
        all_items = torch.arange(self.num_items,
                                 device=self.item_embeddings.weight.device)
        if self.fused:
            dim = self.embedding_dim
            raw = getattr(self.item_embeddings, 'apply_raw',
                          self.item_embeddings)
            rows = raw(all_items)
            return rows[:, :dim].contiguous(), rows[:, dim].float()
        matrix = self.item_embeddings(all_items)
        bias = self.item_biases(all_items)[..., 0]
        return matrix, bias

    def user_factors(self, user_ids):
        """``user_ids.shape + (dim,)`` user factor vectors.  The user bias
        is left out: it shifts every item's score alike and cannot change
        a rank."""
        if self.fused:
            return self.user_embeddings(user_ids).float()[
                ..., :self.embedding_dim]
        return self.user_embeddings(user_ids)

    def score_catalog(self, user_ids, item_matrix=None,
                      item_bias_vector=None):
        """Score a batch of users against the whole catalogue.

        Parameters
        ----------
        user_ids : int tensor (batch,)
        item_matrix, item_bias_vector : optional precomputed
            :meth:`item_factors`.

        Returns
        -------
        (batch, num_items) float32 tensor.  On a network holding this
        rank's blocks, each rank scores its block of the catalogue and the
        blocks' scores are gathered over the model axis: every rank of the
        axis calls alike and gets the whole, replicated.
        """
        gather = item_matrix is None and self._holds_blocks()
        if item_matrix is None:
            item_matrix, item_bias_vector = self.item_factors()

        if self.fused:
            dim = self.embedding_dim
            rows = self.user_embeddings(user_ids).float()
            users, u_bias = rows[..., :dim], rows[..., dim]
        else:
            users = self.user_embeddings(user_ids)
            u_bias = self.user_biases(user_ids)[..., 0]

        scores = torch.matmul(users, item_matrix.float().T)
        scores = scores + u_bias[:, None] + item_bias_vector[None, :]
        if gather:
            layer = self.item_embeddings
            scores = layer.mesh.all_gather(scores.T, layer.axis).T[
                :, :self.num_items]
        return scores
