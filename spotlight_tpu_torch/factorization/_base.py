"""Shared plumbing for the factorization estimators.

Counterpart of ``spotlight_tpu/factorization/_base.py``: representation
construction, the choice of training engine and its optimizer state, input
validation, prediction id broadcasting, and the catalogue factors the
evaluation kernels consume.  PyTorch runs eagerly, so the JAX package's jit
caches and bucket padding have no counterpart here; the results are the
same.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from spotlight_tpu_torch.factorization.representations import BilinearNet
from spotlight_tpu_torch.ops.lazy_adam import lazy_adam_init
from spotlight_tpu_torch.utils import training


def resolve_device(device):
    """The device the estimator runs on: ``cuda`` unless the caller names
    another.  Without a card the default raises; it never drops to the
    CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run on '
                'the CPU')
        return torch.device('cuda')
    return torch.device(device)


def _repr_model(model):
    net_representation = ('[uninitialised]' if model._net is None
                          else repr(model._net))
    return '<{}: {}>'.format(model.__class__.__name__, net_representation)


class _FactorizationBase:
    """State shared by the factorization estimators."""

    def __init__(self, embedding_dim, n_iter, batch_size, l2, learning_rate,
                 optimizer_func, representation, sparse, random_state,
                 device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                'mesh= is not ported yet: the distributed layer is the last '
                'item of the port (ROADMAP.md, Queue 1). Train on one device.')
        self._embedding_dim = embedding_dim
        self._n_iter = n_iter
        self._batch_size = batch_size
        self._l2 = l2
        self._learning_rate = learning_rate
        self._optimizer_func = optimizer_func
        self._representation = representation
        self._sparse = sparse
        self._random_state = random_state or np.random.RandomState()
        self._device = resolve_device(device)

        self._num_users = None
        self._num_items = None
        self._net = None
        self._lazy = False
        self._optimizer = None
        self._opt_state = None
        self._epoch_fn_cache = {}
        # Bumped whenever the parameters change; keys the item-factor cache.
        self._params_version = 0
        self._item_factor_cache = None
        self._generator = training.generator_from_random_state(
            self._random_state)

    def __repr__(self):
        return _repr_model(self)

    @property
    def _initialized(self):
        return self._net is not None

    def _lazy_fallback_reason(self):
        """Why ``sparse=True`` cannot use the lazy engine here, or None."""
        if not (isinstance(self._net, BilinearNet) and self._net.fused):
            return ('it requires the default fused BilinearNet layout '
                    '(custom representations / injected embedding layers '
                    'use the dense engine)')
        if self._optimizer_func is not None:
            return ('a custom optimizer_func is set (row-sparse lazy Adam '
                    'IS the optimizer)')
        return None

    def _use_lazy_engine(self):
        """``sparse=True`` selects the row-sparse (lazy) Adam engine
        (:mod:`spotlight_tpu_torch.factorization.lazy`); where a
        configuration cannot use it (a custom representation or optimizer)
        ``sparse`` trains dense, with the JAX package's warning, never
        silently."""
        if not self._sparse:
            return False
        reason = self._lazy_fallback_reason()
        if reason is not None:
            warnings.warn(
                'sparse=True falls back to the dense engine because {} — '
                'training remains correct; above ~0.5M-row tables the '
                'lazy engine would be faster.'.format(reason),
                RuntimeWarning, stacklevel=3)
            return False
        return True

    def _initialize(self, interactions):
        self._num_users = interactions.num_users
        self._num_items = interactions.num_items

        if self._representation is not None:
            self._net = self._representation.to(self._device)
        else:
            self._net = BilinearNet(self._num_users,
                                    self._num_items,
                                    self._embedding_dim,
                                    sparse=self._sparse,
                                    generator=self._generator,
                                    device=self._device)
        self._lazy = self._use_lazy_engine()
        params = dict(self._net.named_parameters())
        if self._lazy:
            self._opt_state = lazy_adam_init(params)
        else:
            self._optimizer = training.make_optimizer(
                self._learning_rate, self._l2, self._optimizer_func)
            self._opt_state = self._optimizer.init(params)
        self._epoch_fn_cache = {}
        self._params_version += 1

    def _load_params(self, state):
        """Install a ``state_dict`` (for example one made by
        :func:`~spotlight_tpu_torch.utils.convert.params_from_jax`) into the
        initialized network."""
        if not self._initialized:
            raise RuntimeError('call _initialize before loading parameters')
        self._net.load_state_dict(state)
        self._params_version += 1

    def _check_input(self, user_ids, item_ids, allow_items_none=False):
        if not self._initialized:
            raise RuntimeError(
                'Model has not been fitted; call fit() first.')
        if isinstance(user_ids, (int, np.integer)):
            user_id_max = user_ids
        else:
            user_id_max = np.asarray(user_ids).max()
        if user_id_max >= self._num_users:
            raise ValueError('Maximum user id greater '
                             'than number of users in model.')

        if allow_items_none and item_ids is None:
            return

        if isinstance(item_ids, (int, np.integer)):
            item_id_max = item_ids
        else:
            item_id_max = np.asarray(item_ids).max()
        if item_id_max >= self._num_items:
            raise ValueError('Maximum item id greater '
                             'than number of items in model.')

    def _ids(self, ids):
        return torch.as_tensor(np.asarray(ids, dtype=np.int64),
                               device=self._device)

    @torch.no_grad()
    def _rank_factors_users(self, user_batch):
        """(user_reprs, item_matrix, item_bias, None) for the streaming
        kernels (None: dot scoring, no mixture), or None when the
        representation is not a dot product.

        The user bias is dropped (it cannot change a rank).  The dense item
        matrix is cached per parameter version, so a metric pays the
        catalogue gather once, not once per batch."""
        if not isinstance(self._net, BilinearNet):
            return None
        cache = self._item_factor_cache
        if cache is None or cache[0] != self._params_version:
            matrix, bias = self._net.item_factors()
            cache = (self._params_version, matrix.contiguous(),
                     bias.contiguous())
            self._item_factor_cache = cache
        reprs = self._net.user_factors(self._ids(user_batch))
        return reprs.float().contiguous(), cache[1], cache[2], None

    @torch.no_grad()
    def _score_catalog(self, user_batch):
        """(B, num_items) float32 scores for a batch of user ids."""
        return self._net.score_catalog(self._ids(user_batch))

    @torch.no_grad()
    def _raw_predictions(self, user_ids, item_ids):
        """Reference ``_predict_process_ids`` semantics: a scalar user with no
        items scores the catalogue; otherwise ids broadcast pairwise."""
        if item_ids is None and np.isscalar(user_ids):
            scores = self._score_catalog([int(user_ids)])
            return scores.cpu().numpy().flatten()

        if item_ids is None:
            item_ids = np.arange(self._num_items, dtype=np.int64)
        item_ids = np.atleast_1d(np.asarray(item_ids, dtype=np.int64)).ravel()
        if np.isscalar(user_ids):
            user_ids = np.full_like(item_ids, int(user_ids))
        else:
            user_ids = np.atleast_1d(
                np.asarray(user_ids, dtype=np.int64)).ravel()
            if len(user_ids) != len(item_ids):
                user_ids = np.broadcast_to(user_ids, item_ids.shape)

        out = self._net(self._ids(user_ids), self._ids(item_ids))
        return out.cpu().numpy().flatten()
