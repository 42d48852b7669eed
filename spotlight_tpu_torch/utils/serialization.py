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
- A model trained on a mesh holds its ranks' blocks of the tables:
  :func:`save` (every rank calls it alike) gathers them over the model axis
  into the whole padded tables and moments, as the JAX package's pickle
  holds its global arrays, so the file loads on one device, whose sharded
  layers then look up by plain gathers.

Usage::

    from spotlight_tpu_torch.utils import serialization
    serialization.save(model, 'model.pkl')
    model = serialization.load('model.pkl')

Unpickling runs code named in the file: load only files this program wrote.
"""

from __future__ import annotations

import copy
import pickle

import torch

from spotlight_tpu_torch.parallel.sharding import gather_params, holds_blocks
from spotlight_tpu_torch.utils import training

#: Runtime artefacts that are rebuilt rather than pickled.  The mesh holds
#: this process's ``torch.distributed`` groups: a loaded model has none
#: (as in the JAX package), nor the specs of its state on it; set ``_mesh``
#: again to evaluate on a new one, or to train there with its whole tables
#: replicated (``factorization._base.replicate_on_mesh``).
#: ``parallel.checkpoint`` restores a state onto another layout.
_DROPPED_FIELDS = ('_optimizer', '_epoch_fn_cache', '_item_factor_cache',
                   '_shard_catalog_cache', '_mesh', '_param_specs',
                   '_opt_specs')


class SerializableEstimatorMixin:
    """Pickle support for the estimators (see the module docstring)."""

    def __getstate__(self):
        if _holds_blocks(self):
            raise RuntimeError(
                'a model trained on a mesh holds its blocks of the tables; '
                'save it with serialization.save, which gathers them')
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
        self._mesh = self._param_specs = self._opt_specs = None
        self._optimizer = None
        if had_optimizer:
            self._optimizer = training.make_optimizer(
                self._learning_rate, self._l2, self._optimizer_func)


def _holds_blocks(model):
    """Whether a sharded table of the model's network holds this rank's
    block (``sharding.holds_blocks``)."""
    net = model.__dict__.get('_net')
    return net is not None and holds_blocks(net)


def _gathered(model):
    """A copy of a mesh-trained estimator that holds the whole padded
    tables and Adam moments, gathered over the model axis (every rank
    calls alike), and no mesh."""
    mesh = model._mesh
    net = copy.deepcopy(model._net)     # sharded layers copy without mesh
    whole = gather_params({name: p.detach() for name, p in
                           model._net.named_parameters()},
                          model._param_specs, mesh)
    with torch.no_grad():
        for name, param in net.named_parameters():
            param.data = whole[name]
    gathered = object.__new__(type(model))
    gathered.__dict__.update(model.__dict__)
    gathered._net = net
    gathered._opt_state = gather_params(model._opt_state, model._opt_specs,
                                        mesh)
    gathered._mesh = gathered._param_specs = gathered._opt_specs = None
    gathered._item_factor_cache = gathered._shard_catalog_cache = None
    gathered._epoch_fn_cache = {}
    return gathered


def save(model, path_or_file):
    """Serialize a fitted (or unfitted) estimator to a path or a writable
    binary file.  A model trained on a mesh is saved whole: every rank
    calls alike and writes the same model (write from one rank)."""
    if _holds_blocks(model):
        model = _gathered(model)
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
