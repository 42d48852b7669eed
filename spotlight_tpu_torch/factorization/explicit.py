"""Explicit-feedback matrix factorization.

Counterpart of ``spotlight_tpu/factorization/explicit.py``: classic MF
(``BilinearNet`` dot products) trained on observed ratings with the
``regression``, ``poisson`` or ``logistic`` loss, on one device.

``fit`` runs the engines of the implicit estimator
(:mod:`spotlight_tpu_torch.utils.training`): the dense one by default, or
with ``sparse=True`` the row-sparse lazy-Adam engine
(:mod:`spotlight_tpu_torch.factorization.lazy`, its explicit branch:
positives only, no negative draw), whose row update is the kernel P1 on
the card.  A poisson model predicts ``exp`` of the pair score and a
logistic one its sigmoid, in training and in :meth:`predict` alike.
On a ``mesh=`` (:mod:`spotlight_tpu_torch.parallel`) either engine
trains data-parallel with row-sharded tables.
"""

from __future__ import annotations

import numpy as np
import torch

from spotlight_tpu_torch.factorization._base import _FactorizationBase
from spotlight_tpu_torch.factorization.lazy import build_lazy_step
from spotlight_tpu_torch.ops.losses import EXPLICIT_LOSSES
from spotlight_tpu_torch.parallel import training as ptraining
from spotlight_tpu_torch.utils import training

_LOSSES = tuple(EXPLICIT_LOSSES)


class ExplicitFactorizationModel(_FactorizationBase):
    """An explicit feedback matrix factorization model.

    Parameters
    ----------
    loss : str, one of ('regression', 'poisson', 'logistic')
    embedding_dim : int, optional
    n_iter : int, optional
    batch_size : int, optional
    l2 : float, optional
        Coupled weight decay, as in the implicit estimator.
    learning_rate : float, optional
    optimizer_func : callable, optional
        Overrides ``l2`` and ``learning_rate``; see
        :func:`~spotlight_tpu_torch.utils.training.make_optimizer`.
    use_cuda : bool
        Accepted for API parity; ``device`` selects the device.
    representation : nn.Module, optional
        Escape hatch: any network with the ``BilinearNet`` interface.
    sparse : bool
        Select the row-sparse (lazy) Adam engine (torch's ``SparseAdam``
        semantics, the row update P1).  Needs the default fused
        ``BilinearNet`` layout and no custom optimizer; elsewhere it trains
        dense with a RuntimeWarning.
    random_state : np.random.RandomState, optional
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
                 loss='regression',
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
                 mesh=None,
                 exchange='psum',
                 device=None):
        if loss not in _LOSSES:
            raise ValueError('loss must be one of {} (got {!r})'
                             .format(_LOSSES, loss))
        del use_cuda
        super().__init__(embedding_dim, n_iter, batch_size, l2, learning_rate,
                         optimizer_func, representation, sparse, random_state,
                         mesh=mesh, exchange=exchange, device=device)
        self._loss = loss

    def _elems_fn(self):
        """The dense engine's ``elems_fn(batch, negatives) -> (elementwise
        loss, mask)``; ``negatives`` is None (no negative is drawn)."""
        net = self._net
        loss_func = EXPLICIT_LOSSES[self._loss]
        poisson = self._loss == 'poisson'

        def elems_fn(batch, negatives):
            del negatives
            predictions = net(batch['user_ids'], batch['item_ids'])
            if poisson:
                predictions = torch.exp(predictions)
            return (loss_func(batch['ratings'], predictions, reduce=False),
                    batch['mask'])

        return elems_fn

    def _step_fn(self):
        """``step(batch, negatives) -> loss`` of the engine in use, on the
        estimator's own parameters and optimizer state."""
        if self._lazy:
            step = build_lazy_step(self._net, self._loss,
                                   self._learning_rate, self._l2, 0,
                                   explicit=True, mesh=self._mesh,
                                   exchange=self._exchange)
        else:
            step = ptraining.dense_step(self, self._elems_fn())
        return lambda batch, negatives: step(self._opt_state, batch,
                                             negatives)

    def _epoch_data(self, interactions):
        """(device data, n, num_batches): the padded user and item id
        columns and the float32 ratings, placed on the device at each
        ``fit``."""
        if interactions.ratings is None:
            raise ValueError('explicit factorization needs ratings')
        user_ids = np.asarray(interactions.user_ids).astype(np.int64)
        item_ids = np.asarray(interactions.item_ids).astype(np.int64)
        ratings = np.asarray(interactions.ratings).astype(np.float32)
        self._check_input(user_ids, item_ids)
        n = len(user_ids)
        padded, num_batches = training.pad_to_batches(n, self._batch_size)
        data = training.place_data(
            {'user_ids': training.pad_array(user_ids, padded),
             'item_ids': training.pad_array(item_ids, padded),
             'ratings': training.pad_array(ratings, padded)}, self._device)
        return data, n, num_batches

    def predict(self, user_ids, item_ids=None):
        """Predict ratings: the pair score, through ``exp`` for a poisson
        model and the sigmoid for a logistic one.

        Parameters
        ----------
        user_ids : int or array
            If an int, predict for that user over ``item_ids`` (or the
            whole catalogue); if an array, for the (user, item) pairs.
        item_ids : array, optional

        Returns
        -------
        np.ndarray of predicted ratings
        """
        self._check_input(user_ids, item_ids, allow_items_none=True)
        out = self._raw_predictions(user_ids, item_ids)
        if self._loss == 'poisson':
            out = np.exp(out)
        elif self._loss == 'logistic':
            out = 1.0 / (1.0 + np.exp(-out))
        return out
