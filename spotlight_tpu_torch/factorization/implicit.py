"""Implicit-feedback matrix factorization.

Counterpart of ``spotlight_tpu/factorization/implicit.py``.  This module
carries the serving side: construction, parameters and ``predict``.
Training (negative sampling, the losses and the optimizer loop) belongs to
the next slice of the port, listed in ROADMAP.md; until then ``fit``
raises rather than pretend to train.
"""

from __future__ import annotations

from spotlight_tpu_torch.factorization._base import _FactorizationBase

_LOSSES = ('pointwise', 'bpr', 'hinge', 'adaptive_hinge')


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
    random_state : np.random.RandomState, optional
    num_negative_samples : int, optional
    negative_sampling : str, 'uniform' (default) or 'in_batch'
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
                         device=device)
        self._loss = loss
        self._num_negative_samples = num_negative_samples
        self._negative_sampling = negative_sampling

    def fit(self, interactions, verbose=False):
        """Training is not ported yet (see ROADMAP.md, Queue 1)."""
        raise NotImplementedError(
            'ImplicitFactorizationModel.fit is not ported yet: training is '
            'the next slice of the port (ROADMAP.md, Queue 1). Load fitted '
            'parameters with utils.convert.params_from_jax instead.')

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
