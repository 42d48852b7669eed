"""Shared plumbing for the factorization estimators.

Counterpart of ``spotlight_tpu/factorization/_base.py``: representation
construction, the choice of training engine and its optimizer state, the
epoch loop of ``fit``, input validation, prediction id broadcasting, the
catalogue factors the evaluation kernels consume, and pickling.  PyTorch
runs eagerly, so the JAX package's jit caches and bucket padding have no
counterpart here; the results are the same.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from spotlight_tpu_torch.factorization.lazy import lazy_opt_specs
from spotlight_tpu_torch.factorization.representations import BilinearNet
from spotlight_tpu_torch.ops.lazy_adam import lazy_adam_init
from spotlight_tpu_torch.parallel import training as ptraining
from spotlight_tpu_torch.parallel.sharding import held_part, replicated_like
from spotlight_tpu_torch.utils import training
from spotlight_tpu_torch.utils.profiling import span
from spotlight_tpu_torch.utils.serialization import SerializableEstimatorMixin


def resolve_device(device, mesh=None):
    """The device the estimator runs on: the caller's, else this rank's
    device of ``mesh``, else ``cuda``.  Without a card the default raises;
    it never drops to the CPU on its own."""
    if device is None and mesh is not None:
        return torch.device(mesh.device)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run on '
                'the CPU')
        return torch.device('cuda')
    return torch.device(device)


def check_mesh_settings(mesh, exchange, batch_size):
    """The JAX package's checks of ``exchange`` and, on a mesh, of the batch
    size against the batch-shard count."""
    if exchange not in ('psum', 'alltoall', 'alltoall_cf'):
        raise ValueError(
            "exchange must be one of 'psum', 'alltoall', 'alltoall_cf'"
            ' (got {!r})'.format(exchange))
    if mesh is not None:
        shards = mesh.shape['data']
        if exchange == 'alltoall_cf':
            # The capacity-factored exchange shards the batch over the
            # model axis too.
            shards *= mesh.shape['model']
        if batch_size % shards:
            raise ValueError(
                'batch_size ({}) must be divisible by the batch-shard '
                'count ({})'.format(batch_size, shards))


def replicate_on_mesh(model):
    """Replicated training for a model on a mesh that holds whole tables
    (initialized without the mesh, or loaded from a file), as the JAX
    package trains it: every parameter and optimizer leaf replicated
    (``PartitionSpec()``), the batch sharded over the batch axes of its
    exchange, gradients summed over them (``parallel.training.build_step``;
    on the lazy engines every rank owns every row).  The batch size is
    checked against the mesh as the constructor checks it."""
    if model._mesh is None or model._param_specs is not None:
        return
    check_mesh_settings(model._mesh, model._exchange, model._batch_size)
    model._param_specs = replicated_like(dict(model._net.named_parameters()))
    model._opt_specs = replicated_like(model._opt_state)
    model._epoch_fn_cache = {}


def _repr_model(model):
    net_representation = ('[uninitialised]' if model._net is None
                          else repr(model._net))
    return '<{}: {}>'.format(model.__class__.__name__, net_representation)


class _FactorizationBase(SerializableEstimatorMixin):
    """State shared by the factorization estimators (picklable: see
    :mod:`spotlight_tpu_torch.utils.serialization`)."""

    def __init__(self, embedding_dim, n_iter, batch_size, l2, learning_rate,
                 optimizer_func, representation, sparse, random_state,
                 mesh=None, exchange='psum', device=None):
        check_mesh_settings(mesh, exchange, batch_size)
        self._embedding_dim = embedding_dim
        self._n_iter = n_iter
        self._batch_size = batch_size
        self._l2 = l2
        self._learning_rate = learning_rate
        self._optimizer_func = optimizer_func
        self._representation = representation
        self._sparse = sparse
        self._random_state = random_state or np.random.RandomState()
        self._mesh = mesh
        self._exchange = exchange
        self._device = resolve_device(device, mesh)

        self._num_users = None
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
        if (self._mesh is not None and self._exchange == 'alltoall_cf'
                and getattr(self, '_negative_sampling',
                            'uniform') == 'in_batch'):
            return ("exchange='alltoall_cf' shards the batch over the "
                    'model axis too, which would change the in-batch '
                    'negative roll width (use the psum/alltoall exchanges '
                    "with negative_sampling='in_batch')")
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

        mesh = self._mesh
        # On a mesh the tables are drawn whole on the CPU, as one device
        # draws them, and only the rank's blocks go to its device.
        build_device = 'cpu' if mesh is not None else self._device
        if self._representation is not None:
            self._net = self._representation.to(build_device)
        else:
            self._net = BilinearNet(self._num_users,
                                    self._num_items,
                                    self._embedding_dim,
                                    sparse=self._sparse,
                                    generator=self._generator,
                                    device=build_device)
        self._lazy = self._use_lazy_engine()
        if mesh is not None:
            self._net, self._param_specs = ptraining.shard_network(
                self._net, mesh, self._exchange, self._device)
        params = dict(self._net.named_parameters())
        if self._lazy:
            # On a mesh, the moments of the rank's blocks.
            self._opt_state = lazy_adam_init(params)
            if mesh is not None:
                self._opt_specs = lazy_opt_specs(self._param_specs)
        else:
            self._optimizer = training.make_optimizer(
                self._learning_rate, self._l2, self._optimizer_func)
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

    def _negatives_shape(self, num_batches):
        """The shape of an epoch's sampled negatives, or None when the
        steps draw none."""
        return None

    def _epoch_fn(self, num_batches):
        """``epoch_fn(data, n_valid) -> device loss``: one epoch's draws
        from the estimator's generator, then the steps of
        ``self._step_fn()``, on a mesh each on the rank's slice of the
        batch (its negatives, ``(n_neg, B)`` a batch, along their axis
        1)."""
        if num_batches not in self._epoch_fn_cache:
            shard = None if self._mesh is None else (ptraining.batch_rows(
                self._mesh, self._batch_size, self._exchange), 1)
            self._epoch_fn_cache[num_batches] = training.make_epoch_fn(
                self._step_fn(), self._generator, num_batches,
                self._batch_size, self._negatives_shape(num_batches),
                self._num_items, self._device, shard=shard)
        return self._epoch_fn_cache[num_batches]

    def fit(self, interactions, verbose=False):
        """Fit the model.

        When called repeatedly, fitting resumes from the previous state
        (parameters, optimizer state and the random stream).

        Parameters
        ----------
        interactions : :class:`~spotlight_tpu_torch.data.Interactions`
            With ratings, for the explicit estimator.
        verbose : bool
            Print each epoch's loss (read back one epoch late).

        Returns
        -------
        self
        """
        with span('spotlight.fit'):
            if not self._initialized:
                self._initialize(interactions)
            replicate_on_mesh(self)
            with span('spotlight.fit.epoch_data'):
                data, n, num_batches = self._epoch_data(interactions)
            epoch_fn = self._epoch_fn(num_batches)
            self._params_version += 1
            # The last epoch's loss, on the host (the verbose print's value).
            self._last_epoch_loss = training.fit_epochs(
                epoch_fn, data, n, self._n_iter, verbose)
        return self

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

    def _rank_factor_shape(self):
        """``(dim, None)`` of the factors that ``_rank_factors_users``
        gives the streaming kernels (None: dot scoring, no mixture), or
        None when the representation is not a ``BilinearNet``: the metrics
        then score its catalogue."""
        if isinstance(self._net, BilinearNet):
            return self._net.embedding_dim, None
        return None

    @torch.no_grad()
    def _rank_factors_users(self, user_batch):
        """(user_reprs, item_matrix, item_bias, None) for the streaming
        kernels (None: dot scoring, no mixture), of a model whose
        ``_rank_factor_shape`` is not None.

        The user bias is dropped (it cannot change a rank).  The dense item
        matrix is cached per parameter version, so a metric pays the
        catalogue gather once, not once per batch.  On a mesh-trained model
        it is this rank's block of the catalogue (``item_factors``), and
        the user rows come through the exchange: every rank calls alike."""
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
