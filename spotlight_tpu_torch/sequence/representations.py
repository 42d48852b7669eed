"""Sequence representations: users as functions of their interaction history.

Counterpart of ``spotlight_tpu/sequence/representations.py``:
:class:`PoolNet` (the causal running mean of the item embeddings),
:class:`LSTMNet`, :class:`CNNNet` (stacked causal, optionally dilated,
convolutions) and :class:`MixtureLSTMNet`.  :class:`SelfAttentionNet`
(SASRec's causal self-attention blocks) is the port's own and has no
counterpart in the JAX package.

Shared contract: ``user_representation(sequences)`` returns
``(per_step, final)`` where ``per_step[:, t]`` encodes the items *before*
position ``t`` and ``final`` the whole sequence.  The causal alignment
left-pads the embedded sequence with one zero step and drops the last output
step.  ``score(per_step, targets)`` scores target items at every step,
``score_inbatch_negatives(per_step, targets, n)`` the targets of other batch
rows (training's in-batch negatives); ``score_catalog(final)`` scores the
final representation against the whole catalogue (the materialize
evaluation path).

As in the JAX package, activations are ``(batch, time, features)``, and
with the default layers the item bias lives in column ``D`` of one fused
float32 ``(num_items, D + 1)`` table whose padding row 0 reads as zeros.
Injecting an ``item_embedding_layer`` or ``item_bias_layer`` (a
:class:`~spotlight_tpu_torch.ops.embeddings.BloomEmbedding`, say) selects the
classic layout: the item layer (default ``ScaledEmbedding``) beside a
``ZeroEmbedding(num_items, 1, padding_idx=0)`` bias layer; ``fused`` forces
either.  The LSTM keeps JAX's ``(D, 4D)`` weight
layout with gates in the order (i, f, g, o): one input-projection product for
all steps, then a Python loop over ``h @ w_hh``.  (``nn.LSTM`` is not used:
its layout is the transpose of JAX's, and cuDNN runs float32 RNNs in TF32 by
default.)  The CNN keeps JAX's ``(W, I, O)`` weight layout, a list of
layers, and runs each layer as one product per tap (``F.conv1d`` is not used:
cuDNN runs float32 convolutions in TF32 by default).  Parameters are drawn on
the CPU from the caller's ``torch.Generator`` (torch's initialisation: the
LSTM's U(-1/sqrt(D), 1/sqrt(D)), a convolution's U(-1/sqrt(fan_in),
1/sqrt(fan_in)) with fan_in = D x kernel width) and then moved to
``device``.

:class:`SelfAttentionNet` counts its attention's query rows in
:data:`ATTENTION_ROWS` and those at real (non-padding) steps in
:data:`ATTENTION_REAL_ROWS`, and names each block's host time with the
span ``spotlight.seq.block`` (``utils.profiling.span``).
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from spotlight_tpu_torch.ops.embeddings import (PADDING_IDX, BloomEmbedding,
                                                FusedBiasEmbedding,
                                                ScaledEmbedding, ZeroEmbedding)
from spotlight_tpu_torch.ops.kernels.layer_norm import layer_norm
from spotlight_tpu_torch.parallel.sharding import (ShardedBloomEmbedding,
                                                   ShardedEmbedding,
                                                   holds_blocks,
                                                   network_specs)
from spotlight_tpu_torch.utils.profiling import span

#: Query rows that :class:`SelfAttentionNet`'s attention computed, summed
#: over its blocks and forward passes.
ATTENTION_ROWS = 0
#: Of :data:`ATTENTION_ROWS`, those at a real step (an item id other than
#: the padding id).
ATTENTION_REAL_ROWS = 0


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2 - 1) * bound


def _to_tuple(value, num):
    """A per-layer setting: a tuple (or list) as given, an int repeated."""
    if isinstance(value, (tuple, list)):
        return tuple(value)
    return (value,) * num


class _ItemRepresentationBase(nn.Module):
    """The item layers and the scoring shared by the representations."""

    def __init__(self, num_items, embedding_dim, item_embedding_layer,
                 item_bias_layer, fused, generator, device,
                 table_dtype=torch.float32):
        super().__init__()
        self.num_items = num_items
        self.embedding_dim = embedding_dim
        if fused is None:
            fused = item_embedding_layer is None and item_bias_layer is None
        self.fused = fused
        self.table_dtype = table_dtype
        if fused:
            self.item_embeddings = item_embedding_layer or FusedBiasEmbedding(
                num_items, embedding_dim, padding_idx=PADDING_IDX,
                generator=generator, device=device, dtype=table_dtype)
            return
        self.item_embeddings = item_embedding_layer or ScaledEmbedding(
            num_items, embedding_dim, padding_idx=PADDING_IDX,
            generator=generator, device=device)
        self.item_biases = item_bias_layer or ZeroEmbedding(
            num_items, 1, padding_idx=PADDING_IDX, device=device)

    def _parameters_from(self, shapes, generator, device, fan_in=None):
        """A ``ParameterDict`` of U(-1/sqrt(fan_in), 1/sqrt(fan_in)) draws,
        ``fan_in`` D unless given."""
        bound = 1.0 / math.sqrt(fan_in or self.embedding_dim)
        return nn.ParameterDict({
            name: nn.Parameter(_uniform(shape, bound, generator).to(device))
            for name, shape in shapes.items()})

    def _target_rows(self, targets):
        """(vectors, bias) of target item ids in float32: one fused-row
        gather, or the item layer's vectors and the bias layer's column."""
        if not self.fused:
            return (self.item_embeddings(targets),
                    self.item_biases(targets)[..., 0])
        rows = self.item_embeddings(targets)
        return rows[..., :self.embedding_dim], rows[..., self.embedding_dim]

    def _embed(self, sequences):
        if not self.fused:
            return self.item_embeddings(sequences)
        return self._target_rows(sequences)[0]

    def user_representation(self, sequences):
        """(per_step, final) representations; see the module docstring."""
        return self._user_repr_from_emb(self._embed(sequences))

    @staticmethod
    def _causal_shift(emb):
        """Left-pad the embedded sequence by one zero step: output step t
        sees the items strictly before t."""
        return torch.cat([torch.zeros_like(emb[:, :1]), emb], dim=1)

    def score(self, user_representations, targets):
        """(B, T) scores of target ids (B, T) against per-step
        representations."""
        vectors, bias = self._target_rows(targets)
        return self._score_vectors(user_representations, vectors, bias)

    def _score_vectors(self, user_representations, vectors, bias):
        return (user_representations * vectors).sum(dim=-1) + bias

    def score_inbatch_negatives(self, user_representations, targets,
                                num_negatives=1):
        """Scores of in-batch negatives: the target rows of other batch
        rows (rolled by 1..n along the batch), reusing the rows gathered
        for the positives, so no negative is gathered and the rolled rows'
        gradients fold into the positives' rows.  A rolled padding
        position scores against the zero row.

        Returns (B, T) scores for ``num_negatives == 1``, else
        (num_negatives, B, T).
        """
        vectors, bias = self._target_rows(targets)
        outs = [self._score_vectors(user_representations,
                                    torch.roll(vectors, shift, dims=0),
                                    torch.roll(bias, shift, dims=0))
                for shift in range(1, num_negatives + 1)]
        if num_negatives == 1:
            return outs[0]
        return torch.stack(outs, dim=0)

    def sharded(self, axis='model', num_shards=1, exchange='psum',
                mesh=None):
        """A variant with the item tables row-sharded over the mesh axis
        ``axis`` of ``mesh`` (:mod:`spotlight_tpu_torch.parallel.sharding`):
        the fused table, or in the classic layout the item layer and the
        bias layer, a bloom layer through its compressed table
        (``ShardedBloomEmbedding``).  The tower (LSTM, mixture projection,
        convolutions) stays replicated and is shared with this network."""
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

        net = copy.copy(self)
        net._parameters = dict(self._parameters)
        net._buffers = dict(self._buffers)
        net._modules = dict(self._modules)
        net.item_embeddings = wrap(self.item_embeddings)
        if not self.fused:
            net.item_biases = wrap(self.item_biases)
        return net

    def param_specs(self):
        """PartitionSpec of every parameter, by its name in
        ``named_parameters()``: sharded item tables' rows over their axis,
        the tower replicated."""
        return network_specs(self)

    def _holds_blocks(self):
        """Whether the item table is this rank's block of the catalogue
        (trained on a mesh), not the whole padded table."""
        return holds_blocks(self.item_embeddings)

    def _catalog_matrix(self):
        """Dense ``(num_items, D)`` item matrix and ``(num_items,)`` bias:
        the inputs of catalogue scoring and of the evaluation kernels.  For
        a bloom item layer this is one lookup of the whole catalogue; the
        kernels score (and the matched scores gather from) this one matrix,
        so a target's ties stay exact whatever order the lookup sums in.

        On a network whose item tables are this rank's blocks (trained on a
        mesh), this rank's block of the padded catalogue instead, its
        padded rows' values unspecified; every rank of the model axis calls
        alike (a bloom block is looked up through the exchange)."""
        if self._holds_blocks():
            rows = self.item_embeddings.block_rows()
            if self.fused:
                rows = rows.float()
                dim = self.embedding_dim
                return rows[:, :dim].contiguous(), rows[:, dim].contiguous()
            bias = self.item_biases.block_rows()
            return rows.contiguous(), bias[:, 0].contiguous()
        all_items = torch.arange(self.num_items,
                                 device=self.item_embeddings.weight.device)
        vectors, bias = self._target_rows(all_items)
        return vectors.contiguous(), bias.contiguous()

    def _gathered_scores(self, scores):
        """(B, num_items) scores from this rank's (B, block) scores: the
        blocks' scores gathered over the model axis on a network holding
        blocks, else as they are."""
        if not self._holds_blocks():
            return scores
        layer = self.item_embeddings
        return layer.mesh.all_gather(scores.T, layer.axis).T[
            :, :self.num_items]

    def score_catalog(self, final_representations):
        """(B, num_items) scores of final representations (B, D).  On a
        network holding this rank's blocks, every rank of the model axis
        calls alike and gets the whole, replicated."""
        weight, bias = self._catalog_matrix()
        scores = torch.matmul(final_representations, weight.T)
        return self._gathered_scores(scores + bias[None, :])


class PoolNet(_ItemRepresentationBase):
    """Average pooling: the user at step t is the running mean of the
    embeddings of the items before t.

    The denominator is the running count of nonzero entries of each
    channel, plus one (the reference's cumulative-sum formulation), so
    padding positions, whose embeddings read as zeros, count for nothing.

    Parameters
    ----------
    num_items : int
    embedding_dim : int, optional
    item_embedding_layer : nn.Module, optional
        Custom item layer (a ``BloomEmbedding``, say); selects the classic
        layout.
    sparse : bool
        Accepted for API parity.
    item_bias_layer : nn.Module, optional
    fused : bool, optional
    table_dtype : torch.dtype, optional
        As :class:`LSTMNet` takes them.
    generator : torch.Generator, optional
    device : str or torch.device
    """

    def __init__(self, num_items, embedding_dim=32, item_embedding_layer=None,
                 sparse=False, item_bias_layer=None, fused=None,
                 table_dtype=torch.float32, generator=None, device='cpu'):
        super().__init__(num_items, embedding_dim, item_embedding_layer,
                         item_bias_layer, fused, generator, device,
                         table_dtype=table_dtype)
        self.sparse = sparse

    def _user_repr_from_emb(self, emb):
        shifted = self._causal_shift(emb)                    # (B, T+1, D)
        sums = torch.cumsum(shifted, dim=1)
        counts = torch.cumsum((shifted != 0).to(shifted.dtype), dim=1)
        representations = sums / (counts + 1.0)
        return representations[:, :-1], representations[:, -1]


class LSTMNet(_ItemRepresentationBase):
    """A single-layer LSTM over the (shifted) embedded sequence; the hidden
    state at each step is the user representation.

    Parameters
    ----------
    num_items : int
    embedding_dim : int, optional
    item_embedding_layer : nn.Module, optional
        Custom item layer (a ``BloomEmbedding``, say); selects the classic
        layout.
    sparse : bool
        Accepted for API parity.
    item_bias_layer : nn.Module, optional
        Custom ``(num_items, 1)`` bias layer; selects the classic layout.
    fused : bool, optional
        Force the fused layout on (True) or off (False).  Default (None):
        fused exactly when no custom layer is injected.
    table_dtype : torch.dtype, optional
        Storage dtype of the fused item table (float32 or bfloat16): rows
        are gathered in it and cast to float32, so the scores, the LSTM
        and the gradients compute in float32.  Only the fused layout
        honours it.
    generator : torch.Generator, optional
    device : str or torch.device
    """

    def __init__(self, num_items, embedding_dim=32, item_embedding_layer=None,
                 sparse=False, item_bias_layer=None, fused=None,
                 table_dtype=torch.float32, generator=None, device='cpu'):
        super().__init__(num_items, embedding_dim, item_embedding_layer,
                         item_bias_layer, fused, generator, device,
                         table_dtype=table_dtype)
        self.sparse = sparse
        dim = embedding_dim
        self.lstm = self._parameters_from(
            {'w_ih': (dim, 4 * dim), 'w_hh': (dim, 4 * dim),
             'b_ih': (4 * dim,), 'b_hh': (4 * dim,)}, generator, device)

    def _run_lstm(self, inputs):
        """inputs (B, T1, D) -> hidden states (B, T1, D)."""
        lstm = self.lstm
        dim = self.embedding_dim
        x_proj = (torch.einsum('btd,dg->btg', inputs, lstm['w_ih'])
                  + lstm['b_ih'] + lstm['b_hh'])
        h = c = torch.zeros_like(x_proj[:, 0, :dim])
        hidden = []
        for step in range(x_proj.shape[1]):
            gates = x_proj[:, step] + h @ lstm['w_hh']
            i = torch.sigmoid(gates[:, :dim])
            f = torch.sigmoid(gates[:, dim:2 * dim])
            g = torch.tanh(gates[:, 2 * dim:3 * dim])
            o = torch.sigmoid(gates[:, 3 * dim:])
            c = f * c + i * g
            h = o * torch.tanh(c)
            hidden.append(h)
        return torch.stack(hidden, dim=1)

    def _user_repr_from_emb(self, emb):
        hidden = self._run_lstm(self._causal_shift(emb))
        return hidden[:, :-1], hidden[:, -1]


class CNNNet(_ItemRepresentationBase):
    """Stacked causal (atrous) convolutions over the embedded sequence.

    Causality comes from left padding, as in the JAX package: the first
    layer pads by its whole receptive field ``kw + (kw - 1)(dil - 1)``,
    which gives T + 1 output steps (step 0 has seen nothing) and its
    residual is the input padded by one step; later layers pad by the
    receptive field less one (length-preserving).  Each layer is
    ``nonlinearity(sum_k x_pad[:, k dil : k dil + T + 1] @ W[k] + b)``, with
    ``W`` of shape ``(kernel width, D, D)`` (JAX's ``(W, I, O)``), plus the
    layer's input when ``residual_connections``.

    Parameters
    ----------
    num_items : int
    embedding_dim : int, optional
    kernel_width, dilation : int or tuple of one per layer, optional
    num_layers : int, optional
        The number of layers when ``kernel_width`` is an int; a tuple
        ``kernel_width`` gives one layer per entry.
    nonlinearity : 'tanh' or 'relu'
    residual_connections : bool
    sparse, benchmark : bool
        Accepted for API parity.
    item_embedding_layer, item_bias_layer, fused, table_dtype, generator,
    device : as :class:`LSTMNet` takes them.
    """

    def __init__(self, num_items, embedding_dim=32, kernel_width=3,
                 dilation=1, num_layers=1, nonlinearity='tanh',
                 residual_connections=True, sparse=False, benchmark=True,
                 item_embedding_layer=None, item_bias_layer=None, fused=None,
                 table_dtype=torch.float32, generator=None, device='cpu'):
        if nonlinearity not in ('tanh', 'relu'):
            raise ValueError('Nonlinearity must be one of (tanh, relu)')
        super().__init__(num_items, embedding_dim, item_embedding_layer,
                         item_bias_layer, fused, generator, device,
                         table_dtype=table_dtype)
        self.sparse = sparse
        self.benchmark = benchmark
        self.nonlinearity = nonlinearity
        self.residual_connections = residual_connections
        self.kernel_widths = _to_tuple(kernel_width, num_layers)
        self.dilations = _to_tuple(dilation, num_layers)
        dim = embedding_dim
        self.cnn_layers = nn.ModuleList(
            self._parameters_from({'weight': (kw, dim, dim), 'bias': (dim,)},
                                  generator, device, fan_in=dim * kw)
            for kw in self.kernel_widths)

    def _activation(self, x):
        return torch.tanh(x) if self.nonlinearity == 'tanh' else torch.relu(x)

    @staticmethod
    def _conv(x, layer, dilation, left_pad):
        """Causal 1-D convolution (B, T, D) -> (B, T + left_pad - (kw - 1)
        dilation, D): one product per tap."""
        x = F.pad(x, (0, 0, left_pad, 0))
        weight = layer['weight']
        length = x.shape[1] - (weight.shape[0] - 1) * dilation
        out = x[:, :length] @ weight[0]
        for k in range(1, weight.shape[0]):
            out = out + x[:, k * dilation:k * dilation + length] @ weight[k]
        return out + layer['bias']

    def _user_repr_from_emb(self, emb):
        layers = self.cnn_layers
        kw, dilation = self.kernel_widths[0], self.dilations[0]
        x = self._activation(self._conv(emb, layers[0], dilation,
                                        kw + (kw - 1) * (dilation - 1)))
        if self.residual_connections:
            x = x + F.pad(emb, (0, 0, 1, 0))
        for layer, kw, dilation in zip(layers[1:], self.kernel_widths[1:],
                                       self.dilations[1:]):
            residual = x
            x = self._activation(self._conv(x, layer, dilation,
                                            (kw - 1) * dilation))
            if self.residual_connections:
                x = x + residual
        return x[:, :-1], x[:, -1]


class MixtureLSTMNet(LSTMNet):
    """Mixture-of-tastes LSTM representation (Kula, "Mixture-of-tastes
    Models", 2017).

    The LSTM hidden state is projected (a per-step dense layer) to
    ``num_mixtures`` taste vectors and then ``num_mixtures`` attention
    vectors; a target item is scored against the softmax-weighted mixture
    of tastes, weighted by the item's affinity to each attention vector.

    Representation shapes: per-step ``(B, T, 2 * num_mixtures, D)``, final
    ``(B, 2 * num_mixtures, D)``.
    """

    def __init__(self, num_items, embedding_dim=32, num_mixtures=4,
                 item_embedding_layer=None, sparse=False,
                 item_bias_layer=None, fused=None, table_dtype=torch.float32,
                 generator=None, device='cpu'):
        super().__init__(num_items, embedding_dim,
                         item_embedding_layer=item_embedding_layer,
                         sparse=sparse, item_bias_layer=item_bias_layer,
                         fused=fused, table_dtype=table_dtype,
                         generator=generator, device=device)
        self.num_mixtures = num_mixtures
        out_dim = embedding_dim * num_mixtures * 2
        self.projection = self._parameters_from(
            {'weight': (embedding_dim, out_dim), 'bias': (out_dim,)},
            generator, device)

    def _user_repr_from_emb(self, emb):
        hidden = self._run_lstm(self._causal_shift(emb))     # (B, T+1, D)
        projected = (torch.einsum('btd,do->bto', hidden,
                                  self.projection['weight'])
                     + self.projection['bias'])
        batch, t1 = projected.shape[:2]
        projected = projected.reshape(batch, t1, 2 * self.num_mixtures,
                                      self.embedding_dim)
        return projected[:, :-1], projected[:, -1]

    def _score_vectors(self, user_representations, vectors, bias):
        m = self.num_mixtures
        components = user_representations[..., :m, :]       # (B, T, M, D)
        mixture_vectors = user_representations[..., m:, :]  # (B, T, M, D)
        attention = torch.einsum('btmd,btd->btm', mixture_vectors, vectors)
        weights = torch.softmax(attention, dim=-1)
        weighted = torch.einsum('btm,btmd->btd', weights, components)
        return (weighted * vectors).sum(dim=-1) + bias

    def score_catalog(self, final_representations):
        """(B, num_items) scores of final representations (B, 2M, D)."""
        m = self.num_mixtures
        components = final_representations[:, :m, :]        # (B, M, D)
        mixture_vectors = final_representations[:, m:, :]   # (B, M, D)
        weight, bias = self._catalog_matrix()
        taste_scores = torch.einsum('bmd,nd->bmn', components, weight)
        attention = torch.einsum('bmd,nd->bmn', mixture_vectors, weight)
        weights = torch.softmax(attention, dim=1)
        return self._gathered_scores(
            (weights * taste_scores).sum(dim=1) + bias[None, :])


class SelfAttentionNet(_ItemRepresentationBase):
    """Self-attentive sequential recommendation (SASRec: Kang and McAuley,
    "Self-Attentive Sequential Recommendation", ICDM 2018,
    arXiv:1808.09781): causal self-attention blocks over the item
    embeddings and learned positions.  The port's own; the JAX package has
    no counterpart.

    On the causally shifted sequence of ids (one padding step in front,
    :meth:`_causal_shift`; 0 is the padding id), left-padded to its
    window::

        E = Dropout(M[id] + P[pos]), zero at padding steps
        for each of num_blocks blocks:
            A = LN_a(F)
            S = F + Dropout(softmax(mask(A W_Q (A W_K)^T / sqrt(d))) A W_V)
            F = S + Dropout(ReLU(LN_f(S) W_1 + b_1) W_2 + b_2)
            F = F, zero at padding steps
        out = LN_out(F)

    ``pos`` is the step's place in a window of ``max_sequence_length``
    (n) steps, the newest step taking row n - 1 of P, as in the authors'
    code; a sequence has at most n items, and the one shifted-in step,
    padding, needs no row.  The mask is causal (a step attends to itself
    and the steps before it) and hides padding keys; a query row with no
    key left reads a zero attention output.  One head; products keep the
    port's ``x @ W`` layout with ``W`` of shape ``(D, D)``; dropout is
    active only in training mode (``fit`` sets it, the scoring paths set
    evaluation mode) and draws from torch's generator on the network's
    device.  The LayerNorms run
    :func:`~spotlight_tpu_torch.ops.kernels.layer_norm.layer_norm`: on the
    card a hand-written kernel, one warp a row.  ``per_step[:, t]`` is
    ``out`` at the step that holds the item before t, and ``final`` ``out``
    at the newest step; items score by their dot with it plus their bias
    (:meth:`score`, :meth:`_catalog_matrix`), the item embeddings shared
    between input and prediction.

    Departures from the paper: Spotlight's item bias column is added to
    the scores; the final LayerNorm and LayerNorm's eps of 1e-8 come from
    the authors' code (the paper gives neither); training takes the
    estimator's per-step Spotlight losses, not SASRec's binary
    cross-entropy.

    Initialisation (drawn on the CPU from ``generator``, then moved): the
    item table as the other representations' (N(0, 1) / D), P N(0, 1) / D,
    the LayerNorms' gains 1 and offsets 0, the products and the
    feed-forward biases U(-1/sqrt(D), 1/sqrt(D)).

    Parameters
    ----------
    num_items : int
    embedding_dim : int, optional
    num_blocks : int, optional
    max_sequence_length : int, optional
        n, the positions P holds: the longest sequence taken.
    dropout : float, optional
    fused, table_dtype, generator, device : as :class:`LSTMNet` takes them.
    """

    #: LayerNorm's epsilon, the authors' code's.
    EPS = 1e-8

    def __init__(self, num_items, embedding_dim=50, num_blocks=2,
                 max_sequence_length=200, dropout=0.2, fused=None,
                 table_dtype=torch.float32, generator=None, device='cpu'):
        super().__init__(num_items, embedding_dim, None, None, fused,
                         generator, device, table_dtype=table_dtype)
        dim = embedding_dim
        self.num_blocks = num_blocks
        self.max_sequence_length = max_sequence_length
        self.dropout = dropout
        self.position_embeddings = nn.Parameter(
            (torch.randn(max_sequence_length, dim, generator=generator)
             / dim).to(device))

        def gains():
            return nn.Parameter(torch.ones(dim, device=device))

        def offsets():
            return nn.Parameter(torch.zeros(dim, device=device))

        blocks = []
        for _ in range(num_blocks):
            block = self._parameters_from(
                {'w_q': (dim, dim), 'w_k': (dim, dim), 'w_v': (dim, dim),
                 'w_1': (dim, dim), 'b_1': (dim,), 'w_2': (dim, dim),
                 'b_2': (dim,)}, generator, device)
            block.update({'norm_a_weight': gains(), 'norm_a_bias': offsets(),
                          'norm_f_weight': gains(), 'norm_f_bias': offsets()})
            blocks.append(block)
        self.blocks = nn.ModuleList(blocks)
        self.output_norm = nn.ParameterDict({'weight': gains(),
                                             'bias': offsets()})

    def _layer_norm(self, x, weight, bias):
        return layer_norm(x, weight, bias, self.EPS)

    def user_representation(self, sequences):
        """(per_step, final) representations of item ids ``sequences``
        (B, L), L at most ``max_sequence_length``; see the class
        docstring."""
        global ATTENTION_ROWS, ATTENTION_REAL_ROWS
        length = sequences.shape[1]
        if length > self.max_sequence_length:
            raise ValueError(
                'SelfAttentionNet holds {} positions; got sequences of {} '
                'items'.format(self.max_sequence_length, length))
        real = self._causal_shift(sequences != PADDING_IDX)   # (B, L+1)
        # One read-back a forward pass, before the blocks are issued.
        ATTENTION_ROWS += self.num_blocks * real.numel()
        ATTENTION_REAL_ROWS += self.num_blocks * int(real.sum())
        # Row -1 (the zero row in front) is the shifted-in step's when the
        # sequence fills the window.
        positions = F.pad(self.position_embeddings, (0, 0, 1, 0))[
            self.max_sequence_length - length:]
        x = self._causal_shift(self._embed(sequences)) + positions
        keep = real[..., None].to(x.dtype)
        x = F.dropout(x, self.dropout, self.training) * keep
        steps = x.shape[1]
        causal = torch.ones(steps, steps, dtype=torch.bool,
                            device=x.device).tril()
        allowed = causal & real[:, None, :]                   # (B, q, k)
        has_key = allowed.any(dim=-1, keepdim=True)
        # A query with no key attends to every step, then reads zero.
        hidden = ~(allowed | ~has_key)
        has_key = has_key.to(x.dtype)
        for block in self.blocks:
            with span('spotlight.seq.block'):
                x = self._block(x, block, hidden, has_key) * keep
        out = self._layer_norm(x, self.output_norm['weight'],
                               self.output_norm['bias'])
        return out[:, :-1], out[:, -1]

    def _block(self, x, block, hidden, has_key):
        """One block on (B, T, D) with the mask's hidden pairs (B, T, T)
        and each query's ``has_key`` (B, T, 1)."""
        attend = self._layer_norm(x, block['norm_a_weight'],
                                  block['norm_a_bias'])
        scores = torch.matmul(attend @ block['w_q'],
                              (attend @ block['w_k']).transpose(1, 2))
        scores = (scores / math.sqrt(self.embedding_dim)).masked_fill(
            hidden, float('-inf'))
        weights = torch.softmax(scores, dim=-1) * has_key
        attended = torch.matmul(weights, attend @ block['w_v'])
        x = x + F.dropout(attended, self.dropout, self.training)
        inner = torch.relu(self._layer_norm(x, block['norm_f_weight'],
                                            block['norm_f_bias'])
                           @ block['w_1'] + block['b_1'])
        return x + F.dropout(inner @ block['w_2'] + block['b_2'],
                             self.dropout, self.training)
