"""Estimator serialization.

Counterpart of ``spotlight_tpu/utils/serialization.py``: a whole estimator is
pickled, with its parameters, its optimizer state (either engine's, the
step count included) and its random stream, so that a loaded model scores
exactly as the saved one did and training resumes where it stopped.

- Tensors pickle as themselves and come back on the device they were saved
  from: a model saved from the card needs a card to load (loading raises
  without one; nothing moves to the CPU on its own).
- The ``torch.Generator`` of the random stream travels as its
  ``get_state()``.
- The optimizer (a closure when ``optimizer_func`` made it), the cached
  epoch functions and the cached item factors are dropped and rebuilt.
- The mesh is dropped: a loaded model has ``_mesh`` None, as in the JAX
  package.

Usage::

    from spotlight_tpu_torch.utils import serialization
    serialization.save(model, 'model.pkl')
    model = serialization.load('model.pkl')

Unpickling runs code named in the file: load only files this program wrote.
"""

from __future__ import annotations

import pickle

import torch

from spotlight_tpu_torch.utils import training

#: Runtime artefacts that are rebuilt rather than pickled.  The mesh holds
#: this process's ``torch.distributed`` groups: a loaded model has none
#: (as in the JAX package); set ``_mesh`` again to evaluate on a new one.
_DROPPED_FIELDS = ('_optimizer', '_epoch_fn_cache', '_item_factor_cache',
                   '_shard_catalog_cache', '_mesh')


class SerializableEstimatorMixin:
    """Pickle support for the estimators (see the module docstring)."""

    def __getstate__(self):
        state = {key: value for key, value in self.__dict__.items()
                 if key not in _DROPPED_FIELDS}
        state['_had_optimizer'] = self.__dict__.get('_optimizer') is not None
        state['_generator'] = self._generator.get_state()
        return state

    def __setstate__(self, state):
        state = dict(state)
        had_optimizer = state.pop('_had_optimizer')
        generator = torch.Generator()
        generator.set_state(state.pop('_generator'))
        self.__dict__.update(state)
        self._generator = generator
        self._epoch_fn_cache = {}
        self._item_factor_cache = None
        self._shard_catalog_cache = None
        self._mesh = None
        self._optimizer = None
        if had_optimizer:
            self._optimizer = training.make_optimizer(
                self._learning_rate, self._l2, self._optimizer_func)


def save(model, path_or_file):
    """Serialize a fitted (or unfitted) estimator to a path or a writable
    binary file."""
    if hasattr(path_or_file, 'write'):
        pickle.dump(model, path_or_file)
    else:
        with open(path_or_file, 'wb') as fh:
            pickle.dump(model, fh)


def load(path_or_file):
    """Load an estimator written by :func:`save` from a path or a readable
    binary file."""
    if hasattr(path_or_file, 'read'):
        return pickle.load(path_or_file)
    with open(path_or_file, 'rb') as fh:
        return pickle.load(fh)
