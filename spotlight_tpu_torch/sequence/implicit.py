"""Implicit-feedback sequence model.

Counterpart of ``spotlight_tpu/sequence/implicit.py``.  This module carries
the serving side: construction, parameters, ``predict`` and the factors the
evaluation kernels consume.  Training belongs to a later slice of the port,
listed in ROADMAP.md; until then ``fit`` raises rather than pretend to
train.
"""

from __future__ import annotations

import numpy as np
import torch

from spotlight_tpu_torch.factorization._base import resolve_device
from spotlight_tpu_torch.sequence.representations import (LSTMNet,
                                                          MixtureLSTMNet)
from spotlight_tpu_torch.utils import training

_LOSSES = ('pointwise', 'bpr', 'hinge', 'adaptive_hinge')
_REPRESENTATIONS = {'lstm': LSTMNet, 'mixture': MixtureLSTMNet}


class ImplicitSequenceModel:
    """Model for sequential recommendations using implicit feedback.

    Parameters
    ----------
    loss : str, one of ('pointwise', 'bpr', 'hinge', 'adaptive_hinge')
    representation : str or nn.Module
        'lstm' or 'mixture', or any module with the sequence-representation
        protocol (``user_representation``, ``score``, ``score_catalog``).
        'pooling' and 'cnn' are not ported yet and raise.
    embedding_dim : int, optional
    n_iter, batch_size, l2, learning_rate, optimizer_func : optional
        Training settings, kept for the training slice of the port.
    use_cuda : bool
        Accepted for API parity; ``device`` selects the device.
    sparse : bool
    random_state : np.random.RandomState, optional
    num_negative_samples : int, optional
    mesh : optional
        Distributed training is not ported yet; anything but None raises.
    exchange : str, 'psum' (default), 'alltoall' or 'alltoall_cf'
    negative_sampling : str, 'uniform' (default) or 'in_batch'
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
        if exchange not in ('psum', 'alltoall', 'alltoall_cf'):
            raise ValueError(
                "exchange must be one of 'psum', 'alltoall', 'alltoall_cf'"
                ' (got {!r})'.format(exchange))
        if isinstance(representation, str) and (
                representation not in _REPRESENTATIONS):
            if representation in ('pooling', 'cnn'):
                raise NotImplementedError(
                    'the {!r} representation is not ported yet (ROADMAP.md, '
                    'Queue 1); use lstm or mixture'.format(representation))
            raise ValueError('unknown representation {!r}'.format(
                representation))
        if mesh is not None:
            raise NotImplementedError('distributed training is not ported '
                                      'yet (ROADMAP.md, Queue 1)')
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
        self._exchange = exchange
        self._negative_sampling = negative_sampling
        self._device = resolve_device(device)

        self._num_items = None
        self._net = None
        # Bumped whenever the parameters change; keys the item-factor cache.
        self._params_version = 0
        self._item_factor_cache = None
        self._generator = training.generator_from_random_state(
            self._random_state)

    def __repr__(self):
        net_representation = ('[uninitialised]' if self._net is None
                              else repr(self._net))
        return '<{}: {}>'.format(self.__class__.__name__, net_representation)

    @property
    def _initialized(self):
        return self._net is not None

    def _initialize(self, interactions):
        self._num_items = interactions.num_items
        if isinstance(self._representation, str):
            self._net = _REPRESENTATIONS[self._representation](
                self._num_items, self._embedding_dim, sparse=self._sparse,
                generator=self._generator, device=self._device)
        else:
            self._net = self._representation.to(self._device)
        self._params_version += 1

    def _load_params(self, state):
        """Install a ``state_dict`` (for example one made by
        :func:`~spotlight_tpu_torch.utils.convert.params_from_jax`) into the
        initialized network."""
        if not self._initialized:
            raise RuntimeError('call _initialize before loading parameters')
        self._net.load_state_dict(state)
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

    def fit(self, interactions, verbose=False):
        """Training is not ported yet (see ROADMAP.md, Queue 1)."""
        raise NotImplementedError(
            'ImplicitSequenceModel.fit is not ported yet: sequence training '
            'is a later slice of the port (ROADMAP.md, Queue 1). Load fitted '
            'parameters with utils.convert.params_from_jax instead.')

    def _sequences(self, sequences):
        return torch.as_tensor(
            np.atleast_2d(np.asarray(sequences, dtype=np.int64)),
            device=self._device)

    @torch.no_grad()
    def _rank_factors_sequences(self, prefix_batch):
        """(final_reprs, item_matrix, item_bias, num_mixtures) for the
        streaming kernels, or None for a custom representation.
        ``num_mixtures`` is None for dot scoring.

        A mixture's final representation (B, 2M, D) is flattened to
        (B, 2M * D), tastes first, then attentions.  The item matrix is
        cached per parameter version, so a metric pays the catalogue gather
        once, not once per batch."""
        net = self._net
        if not isinstance(net, LSTMNet):
            return None
        cache = self._item_factor_cache
        if cache is None or cache[0] != self._params_version:
            cache = (self._params_version, *net._catalog_matrix())
            self._item_factor_cache = cache
        _, final = net.user_representation(self._sequences(prefix_batch))
        final = final.reshape(final.shape[0], -1).contiguous()
        mixtures = (net.num_mixtures if isinstance(net, MixtureLSTMNet)
                    else None)
        return final, cache[1], cache[2], mixtures

    @torch.no_grad()
    def _score_catalog_sequences(self, sequences):
        """(B, num_items) float32 next-item scores for a batch of
        sequences: the materialize evaluation path."""
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
