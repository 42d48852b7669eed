"""Implicit-feedback sequence model.

Counterpart of ``spotlight_tpu/sequence/implicit.py``: construction,
parameters, training, ``predict`` and the factors the evaluation kernels
consume.

``fit`` trains on the dense engine (:mod:`spotlight_tpu_torch.utils.
training`: autograd through the whole representation, then Adam over every
parameter) or, with ``sparse=True`` where the JAX package takes it, on the
row-sparse sequence engine (:mod:`spotlight_tpu_torch.sequence.lazy`: lazy
Adam through the row-Adam kernel P1 on the item table, dense Adam on the
tower).  Each step scores every position's target (the sequence itself,
the representation being causal) against uniformly drawn negatives of the
same shape, or against the targets of other batch rows
(``negative_sampling='in_batch'``, importance-weighted back to the uniform
objective); the loss is masked at padding positions and padded rows.  Each
epoch draws its permutation and negatives from the estimator's CPU
generator in one go and reads its loss back one epoch late.  On a ``mesh=``
(:mod:`spotlight_tpu_torch.parallel`) the item tables are row-sharded over
the model axis and the batch over the data axis
(:mod:`spotlight_tpu_torch.parallel.training`; the lazy engine there under
the ``'psum'`` and ``'alltoall'`` exchanges), and the metrics score each
rank's block of the catalogue.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from spotlight_tpu_torch.data.interactions import PADDING_IDX
from spotlight_tpu_torch.factorization._base import (check_mesh_settings,
                                                     replicate_on_mesh,
                                                     resolve_device)
from spotlight_tpu_torch.ops.losses import IMPLICIT_LOSSES
from spotlight_tpu_torch.ops.sampling import (inbatch_importance_weight_table,
                                              inbatch_pair_weights,
                                              weighted_inbatch_elems)
from spotlight_tpu_torch.parallel import training as ptraining
from spotlight_tpu_torch.parallel.sharding import held_part
from spotlight_tpu_torch.sequence.lazy import (build_lazy_step,
                                               lazy_seq_adam_init,
                                               lazy_seq_opt_specs)
from spotlight_tpu_torch.sequence.representations import (CNNNet, LSTMNet,
                                                          MixtureLSTMNet,
                                                          PoolNet,
                                                          SelfAttentionNet)
from spotlight_tpu_torch.utils import training
from spotlight_tpu_torch.utils.profiling import span
from spotlight_tpu_torch.utils.serialization import SerializableEstimatorMixin

_LOSSES = tuple(IMPLICIT_LOSSES)
#: Built with the JAX package's constructor defaults (the CNN: kernel width
#: 3, one layer, tanh, residual connections).
_REPRESENTATIONS = {'pooling': PoolNet, 'cnn': CNNNet, 'lstm': LSTMNet,
                    'mixture': MixtureLSTMNet}
#: The representations whose factors the streaming kernels take.
_STREAMED = (PoolNet, LSTMNet, CNNNet, SelfAttentionNet)


class ImplicitSequenceModel(SerializableEstimatorMixin):
    """Model for sequential recommendations using implicit feedback.

    Parameters
    ----------
    loss : str, one of ('pointwise', 'bpr', 'hinge', 'adaptive_hinge')
    representation : str or nn.Module
        'pooling', 'cnn', 'lstm' or 'mixture', or any module with the
        sequence-representation protocol (``user_representation``,
        ``score``, ``score_catalog``), such as a
        :class:`~spotlight_tpu_torch.sequence.representations.SelfAttentionNet`.
        ``fit`` puts the module in training mode and the scoring paths
        (``predict``, the metrics) in evaluation mode, which turns dropout
        on and off.
    embedding_dim : int, optional
    n_iter, batch_size, l2, learning_rate : optional
        Training settings; ``l2`` is Adam's coupled weight decay.
    optimizer_func : callable, optional
        Overrides ``l2`` and ``learning_rate``; see
        :func:`~spotlight_tpu_torch.utils.training.make_optimizer`.
    use_cuda : bool
        Accepted for API parity; ``device`` selects the device.
    sparse : bool
        Select the row-sparse sequence engine
        (:mod:`spotlight_tpu_torch.sequence.lazy`): lazy Adam on the item
        table, through P1, and dense Adam on the rest.  Needs a built-in
        representation in the fused layout, other than
        ``SelfAttentionNet``, and no custom optimizer; elsewhere it trains
        dense with the JAX package's RuntimeWarning.
    random_state : np.random.RandomState, optional
    num_negative_samples : int, optional
        Negatives per position for ``adaptive_hinge``.
    mesh : :class:`~spotlight_tpu_torch.parallel.mesh.Mesh`, optional
        Train and evaluate on a mesh of ranks (every rank calls alike): the
        item tables row-shard over the mesh's ``'model'`` axis, each rank
        holding its block of every table and of its Adam moments (the tower
        replicated), and the batch shards over ``'data'``
        (:mod:`spotlight_tpu_torch.parallel.training`; with
        ``sparse=True`` the lazy engine, P1 on each rank's rows, under
        ``'psum'`` and ``'alltoall'``, and the dense one with a
        RuntimeWarning under ``'alltoall_cf'``, as in JAX).  The metrics
        score each rank's block of the catalogue
        (:mod:`spotlight_tpu_torch.parallel.evaluation`); ``predict``
        returns the whole, replicated result.  A ``SelfAttentionNet`` runs
        on one device only: with a mesh, ``fit`` and the scoring paths
        raise.
    exchange : str, 'psum' (default), 'alltoall' or 'alltoall_cf'
        The collective of sharded table lookups
        (:mod:`spotlight_tpu_torch.parallel.sharding`); checked as the JAX
        package checks it.
    negative_sampling : str, 'uniform' (default) or 'in_batch'
        'in_batch' scores each position against the same position's
        target in the batch rows 1..n before it, each pair weighted by
        :func:`~spotlight_tpu_torch.ops.sampling.
        inbatch_importance_weight_table` (the padding id weighs 0).
    device : str or torch.device, optional
        ``None`` (the default) means ``cuda`` and raises when no card is
        present; pass ``'cpu'`` to run on the CPU.
    """

    def __init__(self,
                 loss='pointwise',
                 representation='pooling',
                 embedding_dim=32,
                 n_iter=10,
                 batch_size=256,
                 l2=0.0,
                 learning_rate=1e-2,
                 optimizer_func=None,
                 use_cuda=False,
                 sparse=False,
                 random_state=None,
                 num_negative_samples=5,
                 mesh=None,
                 exchange='psum',
                 negative_sampling='uniform',
                 device=None):
        if loss not in _LOSSES:
            raise ValueError('loss must be one of {} (got {!r})'
                             .format(_LOSSES, loss))
        if negative_sampling not in ('uniform', 'in_batch'):
            raise ValueError("negative_sampling must be 'uniform' or "
                             "'in_batch' (got {!r})".format(negative_sampling))
        if isinstance(representation, str) and (
                representation not in _REPRESENTATIONS):
            raise ValueError('unknown representation {!r}'.format(
                representation))
        check_mesh_settings(mesh, exchange, batch_size)
        del use_cuda

        self._loss = loss
        self._representation = representation
        self._embedding_dim = embedding_dim
        self._n_iter = n_iter
        self._batch_size = batch_size
        self._l2 = l2
        self._learning_rate = learning_rate
        self._optimizer_func = optimizer_func
        self._sparse = sparse
        self._random_state = random_state or np.random.RandomState()
        self._num_negative_samples = num_negative_samples
        self._mesh = mesh
        self._exchange = exchange
        self._negative_sampling = negative_sampling
        self._device = resolve_device(device, mesh)

        self._num_items = None
        self._net = None
        self._lazy = False
        self._optimizer = None
        self._opt_state = None
        self._param_specs = None
        self._opt_specs = None
        self._epoch_fn_cache = {}
        # Bumped whenever the parameters change; keys the item-factor cache.
        self._params_version = 0
        self._item_factor_cache = None
        self._shard_catalog_cache = None
        self._generator = training.generator_from_random_state(
            self._random_state)

    def __repr__(self):
        net_representation = ('[uninitialised]' if self._net is None
                              else repr(self._net))
        return '<{}: {}>'.format(self.__class__.__name__, net_representation)

    @property
    def _initialized(self):
        return self._net is not None

    def _lazy_fallback_reason(self):
        """Why ``sparse=True`` cannot take the row-sparse engine here, or
        None (the JAX package's conditions)."""
        net = self._net
        if isinstance(net, SelfAttentionNet):
            return ('SelfAttentionNet masks padding keys by item id, and '
                    'the row-sparse engine hands a tower only the gathered '
                    'rows')
        if not (hasattr(net, '_user_repr_from_emb')
                and getattr(net, 'fused', False)):
            return ('it requires a built-in representation with the fused '
                    'table layout')
        if self._optimizer_func is not None:
            return ('a custom optimizer_func is set (row-sparse lazy Adam '
                    'IS the item-table optimizer)')
        if self._mesh is not None and self._exchange == 'alltoall_cf':
            return ("mesh training uses exchange='alltoall_cf', which "
                    'shards the batch over the model axis — the sequence '
                    "tower would need model-axis replication (the 'psum' "
                    "and 'alltoall' exchanges compose with the lazy "
                    'engine)')
        return None

    def _use_lazy_engine(self):
        """Whether ``sparse=True`` selects the row-sparse engine; where a
        configuration cannot use it, it trains dense with the JAX package's
        warning."""
        if not self._sparse:
            return False
        reason = self._lazy_fallback_reason()
        if reason is not None:
            warnings.warn(
                'sparse=True falls back to the dense engine because {} — '
                'training remains correct; above ~1M-item catalogs the '
                'lazy engine would be faster.'.format(reason),
                RuntimeWarning, stacklevel=3)
            return False
        return True

    def _check_one_device(self):
        """A ``SelfAttentionNet`` is held against one device only; on a
        mesh it raises."""
        if self._mesh is not None and isinstance(
                self._net if self._initialized else self._representation,
                SelfAttentionNet):
            raise ValueError(
                'SelfAttentionNet trains and scores on one device: its '
                'mesh path is not held against one device\'s; build the '
                'model without mesh=')

    def _initialize(self, interactions):
        self._num_items = interactions.num_items
        mesh = self._mesh
        # On a mesh the tables are drawn whole on the CPU, as one device
        # draws them, and only the rank's blocks go to its device.
        build_device = 'cpu' if mesh is not None else self._device
        if isinstance(self._representation, str):
            self._net = _REPRESENTATIONS[self._representation](
                self._num_items, self._embedding_dim, sparse=self._sparse,
                generator=self._generator, device=build_device)
        else:
            self._net = self._representation.to(build_device)
        self._lazy = self._use_lazy_engine()
        if mesh is not None:
            self._net, self._param_specs = ptraining.shard_network(
                self._net, mesh, self._exchange, self._device)
        self._optimizer = training.make_optimizer(
            self._learning_rate, self._l2, self._optimizer_func)
        if self._lazy:
            # On a mesh, the moments of the rank's block of the table.
            self._opt_state = lazy_seq_adam_init(self._net, self._optimizer)
            if mesh is not None:
                self._opt_specs = lazy_seq_opt_specs(
                    self._opt_state, dict(self._net.named_parameters()),
                    self._param_specs)
        else:
            params = dict(self._net.named_parameters())
            self._opt_state = self._optimizer.init(params)
            if mesh is not None:
                self._opt_specs = ptraining.opt_specs_like(
                    self._opt_state, params, self._param_specs)
        self._epoch_fn_cache = {}
        self._params_version += 1

    def _load_params(self, state):
        """Install a ``state_dict`` (for example one made by
        :func:`~spotlight_tpu_torch.utils.convert.params_from_jax`) into the
        initialized network.  On a mesh, a whole table (padded or not)
        gives the rank its block."""
        if not self._initialized:
            raise RuntimeError('call _initialize before loading parameters')
        self._net.load_state_dict({
            name: held_part(self._net, name, value)
            for name, value in state.items()})
        self._params_version += 1

    def _check_input(self, item_ids):
        if not self._initialized:
            raise RuntimeError(
                'Model has not been fitted; call fit() first.')
        if isinstance(item_ids, (int, np.integer)):
            item_id_max = item_ids
        else:
            item_id_max = np.asarray(item_ids).max()
        if item_id_max >= self._num_items:
            raise ValueError('Maximum item id greater '
                             'than number of items in model.')

    @property
    def _num_step_negatives(self):
        """Negatives per position a step scores: ``num_negative_samples``
        for ``adaptive_hinge``, else 1."""
        if self._loss == 'adaptive_hinge':
            return self._num_negative_samples
        return 1

    def _elems_fn(self):
        """The dense engine's ``elems_fn(batch, negatives) -> (elementwise
        loss, mask)``: ``negatives`` is ``(B, T)``, ``(n, B, T)`` for
        ``adaptive_hinge``, None in-batch.  The mask is the targets'
        non-padding positions of the batch's valid rows."""
        net = self._net
        loss = self._loss
        loss_func = IMPLICIT_LOSSES[loss]
        adaptive = loss == 'adaptive_hinge'
        n_neg = self._num_step_negatives
        in_batch = self._negative_sampling == 'in_batch'
        if in_batch and not hasattr(net, 'score_inbatch_negatives'):
            raise ValueError(
                "negative_sampling='in_batch' needs a representation with "
                'score_inbatch_negatives (the built-in representations '
                'have it).')

        def elems_fn(batch, negatives):
            sequences = batch['sequences']
            user_representations, _ = net.user_representation(sequences)
            positive = net.score(user_representations, sequences)
            if in_batch:
                negative = net.score_inbatch_negatives(
                    user_representations, sequences, num_negatives=n_neg)
            elif adaptive:
                negative = torch.stack([
                    net.score(user_representations, items)
                    for items in negatives], dim=0)
            else:
                negative = net.score(user_representations, negatives)
            mask = ((sequences != PADDING_IDX)
                    & (batch['mask'][:, None] > 0))
            elems = loss_func(positive, negative, reduce=False)
            if in_batch:
                pair_weight = inbatch_pair_weights(batch['negative_weight'],
                                                   negative, n_neg)
                elems = weighted_inbatch_elems(loss, elems, negative,
                                               pair_weight)
            return elems, mask

        return elems_fn

    def _step_fn(self):
        """``step(batch, negatives) -> loss`` of the engine in use, on the
        estimator's own parameters and optimizer state."""
        if self._lazy:
            step = build_lazy_step(
                self._net, self._loss, self._learning_rate, self._l2,
                self._num_negative_samples, self._optimizer,
                self._negative_sampling, mesh=self._mesh,
                exchange=self._exchange)
        else:
            step = ptraining.dense_step(self, self._elems_fn())
        return lambda batch, negatives: step(self._opt_state, batch,
                                             negatives)

    def _epoch_fn(self, num_batches, length):
        """``epoch_fn(data, n_valid) -> device loss``: one epoch's draws
        from the estimator's generator (negatives ``(num_batches, B, T)``,
        ``(num_batches, n, B, T)`` for ``adaptive_hinge``, none in-batch),
        then the steps."""
        key = (num_batches, length)
        if key not in self._epoch_fn_cache:
            negatives_shape = None
            if self._negative_sampling != 'in_batch':
                negatives_shape = (num_batches, self._batch_size, length)
                if self._loss == 'adaptive_hinge':
                    negatives_shape = (num_batches,
                                       self._num_negative_samples,
                                       self._batch_size, length)
            # A batch's negatives are (B, T), or (n, B, T).
            shard = None if self._mesh is None else (ptraining.batch_rows(
                self._mesh, self._batch_size, self._exchange),
                len(negatives_shape or ()) - 3)
            self._epoch_fn_cache[key] = training.make_epoch_fn(
                self._step_fn(), self._generator, num_batches,
                self._batch_size, negatives_shape, self._num_items,
                self._device, shard=shard)
        return self._epoch_fn_cache[key]

    def _epoch_data(self, interactions):
        """(device data, n, num_batches): the padded sequences (padding
        rows are all the padding id) and, for in-batch negatives, their
        weight column, placed on the device at each ``fit``."""
        sequences = np.asarray(interactions.sequences).astype(np.int64)
        self._check_input(sequences)
        n = len(sequences)
        padded, num_batches = training.pad_to_batches(n, self._batch_size)
        arrays = {'sequences': training.pad_array(sequences, padded)}
        in_batch = self._negative_sampling == 'in_batch'
        if in_batch:
            # Only the (num_items,) table crosses to the device; the
            # (rows, T) column is one gather there.  The padding id, and so
            # every padded row, weighs 0.
            arrays['_weight_table'] = inbatch_importance_weight_table(
                sequences, self._num_items, padding_idx=PADDING_IDX)
        data = training.place_data(arrays, self._device)
        if in_batch:
            data['negative_weight'] = data.pop('_weight_table')[
                data['sequences']]
        return data, n, num_batches

    def fit(self, interactions, verbose=False):
        """Fit the model.

        The loss is taken at every position of the sequences: for a row
        ``[1, 2, 3]`` it sums the losses of predicting 1 from nothing, 2
        from ``[1]`` and 3 from ``[1, 2]``.  When called repeatedly,
        fitting resumes from the previous state (parameters, optimizer
        state and the random stream).

        Parameters
        ----------
        interactions : :class:`~spotlight_tpu_torch.data.SequenceInteractions`
        verbose : bool
            Print each epoch's loss (read back one epoch late).

        Returns
        -------
        self
        """
        with span('spotlight.fit'):
            self._check_one_device()
            if not self._initialized:
                self._initialize(interactions)
            replicate_on_mesh(self)
            self._net.train()
            with span('spotlight.fit.epoch_data'):
                data, n, num_batches = self._epoch_data(interactions)
            epoch_fn = self._epoch_fn(num_batches, data['sequences'].shape[1])
            self._params_version += 1
            # The last epoch's loss, on the host (the verbose print's value).
            self._last_epoch_loss = training.fit_epochs(
                epoch_fn, data, n, self._n_iter, verbose)
        return self

    def _sequences(self, sequences):
        # numpy lays the rows out contiguously (a metric hands prefixes, a
        # strided view); torch's own copy of a strided view runs on its
        # intra-op threads, which on a shared host take milliseconds, and
        # unevenly, for a batch of 2,048 x 199 ids.
        return torch.as_tensor(
            np.ascontiguousarray(np.atleast_2d(sequences), dtype=np.int64),
            device=self._device)

    def _rank_factor_shape(self):
        """``(dim, num_mixtures)`` of the factors that
        ``_rank_factors_sequences`` gives the streaming kernels
        (``num_mixtures`` None for dot scoring), or None for a
        representation they do not take (a custom one): the metrics then
        score its catalogue."""
        net = self._net
        if not isinstance(net, _STREAMED):
            return None
        return net.embedding_dim, (net.num_mixtures
                                   if isinstance(net, MixtureLSTMNet)
                                   else None)

    @torch.no_grad()
    def _rank_factors_sequences(self, prefix_batch):
        """(final_reprs, item_matrix, item_bias, num_mixtures) for the
        streaming kernels, of a model whose ``_rank_factor_shape`` is not
        None.  ``num_mixtures`` is None for dot scoring.

        A mixture's final representation (B, 2M, D) is flattened to
        (B, 2M * D), tastes first, then attentions.  The item matrix is
        cached per parameter version, so a metric pays the catalogue gather
        once, not once per batch.  On a mesh-trained model it is this
        rank's block of the catalogue (``_catalog_matrix``), and the
        sequences' rows come through the exchange: every rank calls
        alike."""
        net = self._net
        self._check_one_device()
        net.eval()
        cache = self._item_factor_cache
        if cache is None or cache[0] != self._params_version:
            cache = (self._params_version, *net._catalog_matrix())
            self._item_factor_cache = cache
        _, final = net.user_representation(self._sequences(prefix_batch))
        final = final.reshape(final.shape[0], -1).contiguous()
        return final, cache[1], cache[2], self._rank_factor_shape()[1]

    @torch.no_grad()
    def _score_catalog_sequences(self, sequences):
        """(B, num_items) float32 next-item scores for a batch of
        sequences: the materialize evaluation path."""
        self._check_one_device()
        self._net.eval()
        _, final = self._net.user_representation(self._sequences(sequences))
        return self._net.score_catalog(final)

    def predict(self, sequences, item_ids=None):
        """Predict next-item scores given a sequence of interactions.

        Parameters
        ----------
        sequences : array of shape (max_sequence_length,)
            A single sequence.  A 2-d input is accepted only with one row;
            batches are scored by :meth:`_score_catalog_sequences`.
        item_ids : array, optional
            Item ids to score; all items if omitted.

        Returns
        -------
        np.ndarray of predicted scores
        """
        sequences = np.atleast_2d(np.asarray(sequences))
        if sequences.ndim != 2 or sequences.shape[0] != 1:
            raise ValueError(
                'predict() takes a single sequence (shape ({},)); got shape '
                '{}. For a batch of sequences, score them with '
                '_score_catalog_sequences(sequences).'.format(
                    sequences.shape[-1], sequences.shape))
        self._check_input(sequences)
        if item_ids is not None:
            self._check_input(item_ids)

        scores = self._score_catalog_sequences(sequences).cpu().numpy()
        scores = scores.flatten()
        if item_ids is not None:
            scores = scores[np.asarray(item_ids).flatten()]
        return scores
