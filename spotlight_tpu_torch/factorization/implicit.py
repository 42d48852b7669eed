"""Implicit-feedback matrix factorization.

Counterpart of ``spotlight_tpu/factorization/implicit.py``: classic MF
trained through negative sampling with the ``pointwise``, ``bpr``,
``hinge`` and ``adaptive_hinge`` ranking losses, on one device.

``fit`` runs one of two engines (:mod:`spotlight_tpu_torch.utils.training`):
the dense one (autograd through the embedding gathers, then Adam over whole
tables) by default, or with ``sparse=True`` the row-sparse lazy-Adam engine
(:mod:`spotlight_tpu_torch.factorization.lazy`), whose row update is the
hand-written kernel P1 on the card.  Each epoch draws its permutation and
negatives from the estimator's CPU generator in one go and reads its loss
back one epoch late.  On a ``mesh=`` (:mod:`spotlight_tpu_torch.parallel`)
either engine trains data-parallel with row-sharded tables, and the
metrics score each rank's block of the catalogue.
"""

from __future__ import annotations

import numpy as np
import torch

from spotlight_tpu_torch.factorization._base import _FactorizationBase
from spotlight_tpu_torch.factorization.lazy import build_lazy_step
from spotlight_tpu_torch.ops.losses import IMPLICIT_LOSSES
from spotlight_tpu_torch.ops.sampling import (inbatch_importance_weight_table,
                                              inbatch_pair_weights,
                                              weighted_inbatch_elems)
from spotlight_tpu_torch.parallel import training as ptraining
from spotlight_tpu_torch.utils import training

_LOSSES = tuple(IMPLICIT_LOSSES)


class ImplicitFactorizationModel(_FactorizationBase):
    """An implicit feedback matrix factorization model.

    Parameters
    ----------
    loss : str, one of ('pointwise', 'bpr', 'hinge', 'adaptive_hinge')
    embedding_dim : int, optional
    n_iter : int, optional
    batch_size : int, optional
    l2 : float, optional
    learning_rate : float, optional
    optimizer_func : callable, optional
    use_cuda : bool
        Accepted for API parity; ``device`` selects the device.
    representation : nn.Module, optional
        Escape hatch: any network with the ``BilinearNet`` interface.
    sparse : bool
        Select the row-sparse (lazy) Adam engine, torch's ``SparseAdam``
        semantics: gradients are taken with respect to the gathered rows and
        the moments update only at the touched rows, through the row-Adam
        kernel P1.  Needs the default fused ``BilinearNet`` layout and no
        custom optimizer; elsewhere it trains dense with a RuntimeWarning.
    random_state : np.random.RandomState, optional
    num_negative_samples : int, optional
        Negatives per positive for ``adaptive_hinge``.
    negative_sampling : str, 'uniform' (default) or 'in_batch'
        'in_batch' scores each positive against the positive items of the
        examples 1..n places before it in the batch, each pair weighted
        back to the uniform objective
        (:func:`~spotlight_tpu_torch.ops.sampling.
        inbatch_importance_weight_table`).
    mesh : :class:`~spotlight_tpu_torch.parallel.mesh.Mesh`, optional
        Train and evaluate on a mesh of ranks (every rank calls alike): the
        embedding tables row-shard over the mesh's ``'model'`` axis, each
        rank holding its block of every table and of its Adam moments, and
        the batch shards over ``'data'``
        (:mod:`spotlight_tpu_torch.parallel.training`; with
        ``sparse=True`` the lazy engine, P1 on each rank's rows).  The
        metrics
        score each rank's block of the catalogue
        (:mod:`spotlight_tpu_torch.parallel.evaluation`); ``predict``
        returns the whole, replicated result.
    exchange : str, 'psum' (default), 'alltoall' or 'alltoall_cf'
        The collective of sharded table lookups
        (:mod:`spotlight_tpu_torch.parallel.sharding`); checked as the JAX
        package checks it.
    device : str or torch.device, optional
        ``None`` (the default) means ``cuda`` and raises when no card is
        present; pass ``'cpu'`` to run on the CPU.
    """

    def __init__(self,
                 loss='pointwise',
                 embedding_dim=32,
                 n_iter=10,
                 batch_size=256,
                 l2=0.0,
                 learning_rate=1e-2,
                 optimizer_func=None,
                 use_cuda=False,
                 representation=None,
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
        del use_cuda
        super().__init__(embedding_dim, n_iter, batch_size, l2, learning_rate,
                         optimizer_func, representation, sparse, random_state,
                         mesh=mesh, exchange=exchange, device=device)
        self._loss = loss
        self._num_negative_samples = num_negative_samples
        self._negative_sampling = negative_sampling

    @property
    def _num_step_negatives(self):
        """Negatives per positive a step scores: ``num_negative_samples``
        for ``adaptive_hinge``, else 1."""
        if self._loss == 'adaptive_hinge':
            return self._num_negative_samples
        return 1

    def _elems_fn(self):
        """The dense engine's ``elems_fn(batch, negatives) -> (elementwise
        loss, mask)``; ``negatives`` is ``(n_neg, B)`` (None in-batch)."""
        net = self._net
        loss = self._loss
        loss_func = IMPLICIT_LOSSES[loss]
        adaptive = loss == 'adaptive_hinge'
        n_neg = self._num_step_negatives
        in_batch = self._negative_sampling == 'in_batch'
        fused = hasattr(net, 'apply_with_negatives')
        if in_batch and not hasattr(net, 'apply_with_inbatch_negatives'):
            raise ValueError(
                "negative_sampling='in_batch' needs a representation with "
                'apply_with_inbatch_negatives (BilinearNet has it).')

        def elems_fn(batch, negatives):
            users, items = batch['user_ids'], batch['item_ids']
            if in_batch:
                positive, negative = net.apply_with_inbatch_negatives(
                    users, items, num_negatives=n_neg)
                elems = loss_func(positive, negative, reduce=False)
                pair_weight = inbatch_pair_weights(
                    batch['negative_weight'], negative, n_neg)
                return (weighted_inbatch_elems(loss, elems, negative,
                                               pair_weight),
                        batch['mask'])
            negative_items = negatives if adaptive else negatives[0]
            if fused:
                positive, negative = net.apply_with_negatives(
                    users, items, negative_items)
            else:
                positive = net(users, items)
                tiled = (users.expand_as(negative_items) if adaptive
                         else users)
                negative = net(tiled, negative_items)
            return loss_func(positive, negative, reduce=False), batch['mask']

        return elems_fn

    def _step_fn(self):
        """``step(batch, negatives) -> loss`` of the engine in use, on the
        estimator's own parameters and optimizer state."""
        if self._lazy:
            step = build_lazy_step(
                self._net, self._loss, self._learning_rate, self._l2,
                self._num_negative_samples, self._negative_sampling,
                mesh=self._mesh, exchange=self._exchange)
        else:
            step = ptraining.dense_step(self, self._elems_fn())
        return lambda batch, negatives: step(self._opt_state, batch,
                                             negatives)

    def _negatives_shape(self, num_batches):
        """The epoch's negatives, ``(num_batches, n_neg, B)``; None for
        in-batch negatives."""
        if self._negative_sampling == 'in_batch':
            return None
        return (num_batches, self._num_step_negatives, self._batch_size)

    def _epoch_data(self, interactions):
        """(device data, n, num_batches): the padded id columns (and the
        in-batch weight column, zero on the padding rows), placed on the
        device at each ``fit``."""
        user_ids = np.asarray(interactions.user_ids).astype(np.int64)
        item_ids = np.asarray(interactions.item_ids).astype(np.int64)
        self._check_input(user_ids, item_ids)
        n = len(user_ids)
        padded, num_batches = training.pad_to_batches(n, self._batch_size)
        arrays = {'user_ids': training.pad_array(user_ids, padded),
                  'item_ids': training.pad_array(item_ids, padded)}
        in_batch = self._negative_sampling == 'in_batch'
        if in_batch:
            # Only the (num_items,) table crosses to the device; the column
            # is one gather there.  Padding rows carry item 0, whose weight
            # is real, so their weight is zeroed: a padding row never serves
            # as a negative.
            arrays['_weight_table'] = inbatch_importance_weight_table(
                item_ids, self._num_items)

        data = training.place_data(arrays, self._device)
        if in_batch:
            table = data.pop('_weight_table')
            column = table[data['item_ids']]
            valid = torch.arange(padded, device=column.device) < n
            data['negative_weight'] = torch.where(
                valid, column, torch.zeros((), device=column.device))
        return data, n, num_batches

    def predict(self, user_ids, item_ids=None):
        """Predict recommendation scores.

        Parameters
        ----------
        user_ids : int or array
        item_ids : array, optional
            If omitted, score the full catalogue.

        Returns
        -------
        np.ndarray of predicted scores
        """
        self._check_input(user_ids, item_ids, allow_items_none=True)
        return self._raw_predictions(user_ids, item_ids)
