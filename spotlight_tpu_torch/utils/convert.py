"""Parameters of the JAX package, carried into the port.

The JAX estimators keep their parameters as a tree of arrays.  Given that
tree as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, model._params)``),
:func:`params_from_jax` returns the port's ``state_dict`` for a
:class:`~spotlight_tpu_torch.factorization.representations.BilinearNet` or
a sequence representation
(:class:`~spotlight_tpu_torch.sequence.representations.PoolNet`,
:class:`~spotlight_tpu_torch.sequence.representations.LSTMNet`,
:class:`~spotlight_tpu_torch.sequence.representations.CNNNet`,
:class:`~spotlight_tpu_torch.sequence.representations.MixtureLSTMNet`), so
both packages can score with the same numbers.  :func:`opt_state_from_jax`
carries an optimizer state across the same way (the lazy engine's
``{'mu', 'nu', 't'}``, the sequence lazy engine's hybrid state or the dense
engine's optax Adam state), so a training step can be compared from one
starting point.  A port parameter's dotted name is its path in the JAX tree
(``cnn_layers.0.weight`` is ``tree['cnn_layers'][0]['weight']``); every
layout is JAX's, so no leaf changes shape.  A network trained on a mesh
holds this rank's block of each sharded table: of JAX's global padded
table (and of its Adam moments) it takes that block
(``parallel.sharding.held_part``).  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from spotlight_tpu_torch.parallel.sharding import held_part

#: The fused item table, which the sequence lazy engine updates row-sparsely.
TABLE = 'item_embeddings.weight'


def _tensor(array, dtype):
    array = np.asarray(array)
    if array.dtype.name == 'bfloat16':
        # numpy has no bfloat16 of its own: carry the raw bits across.
        bits = torch.from_numpy(np.array(array).view(np.int16))
        return bits.view(torch.bfloat16).to(dtype)
    return torch.from_numpy(np.array(array)).to(dtype)


def _leaf(tree, name):
    """The leaf of a JAX tree (dicts, and lists of layers) at a port
    parameter's dotted name."""
    for part in name.split('.'):
        tree = tree[int(part)] if isinstance(tree, (list, tuple)) else tree[
            part]
    return tree


def _leaf_names(tree, prefix=''):
    """The dotted names of a JAX parameter tree's leaves."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [prefix[:-1]]
    return [name for key, child in items
            for name in _leaf_names(child, '{}{}.'.format(prefix, key))]


def params_from_jax(net, params_numpy):
    """The port's ``state_dict`` for ``net`` from a JAX parameter tree.

    Parameters
    ----------
    net : BilinearNet, PoolNet, LSTMNet, CNNNet or MixtureLSTMNet
    params_numpy : dict
        A tree whose leaves are named as the network's parameters.
        ``BilinearNet``'s fused layout is ``{'user_embeddings':
        {'weight': (U, D+1)}, 'item_embeddings': {'weight': (N, D+1)}}``;
        ``fused=False`` adds ``'user_biases'`` and ``'item_biases'``
        ``(., 1)`` tables beside ``(., D)`` embedding tables.
        ``LSTMNet``'s is ``{'item_embeddings': {'weight': (N, D+1)},
        'lstm': {'w_ih': (D, 4D), 'w_hh': (D, 4D), 'b_ih': (4D,), 'b_hh':
        (4D,)}}``; ``MixtureLSTMNet`` adds ``'projection': {'weight':
        (D, 2MD), 'bias': (2MD,)}``.  ``PoolNet`` has the item table alone;
        ``CNNNet`` adds ``'cnn_layers'``, a list of one ``{'weight':
        (kernel width, D, D), 'bias': (D,)}`` a layer.  A sequence network
        in the classic layout (an injected item layer, ``BloomEmbedding``
        say) has ``'item_embeddings': {'weight': (C, D)}`` (C the layer's
        rows: the compressed ones for bloom) and ``'item_biases':
        {'weight': (N, 1)}`` in place of the fused table; so has
        ``BilinearNet`` with bloom user or item layers.

    Returns
    -------
    dict of tensors, on ``net``'s device and in its dtypes, ready for
    ``net.load_state_dict``.
    """
    own = net.state_dict()
    names = sorted(_leaf_names(params_numpy))
    if names != sorted(own):
        raise ValueError('parameter tree has {} but the network expects {}'
                         .format(names, sorted(own)))
    state = {}
    for name, target in own.items():
        tensor = held_part(net, name, _tensor(_leaf(params_numpy, name),
                                          target.dtype))
        if tensor.shape != target.shape:
            raise ValueError('{}: shape {} does not match the network\'s {}'
                             .format(name, tuple(tensor.shape),
                                     tuple(target.shape)))
        state[name] = tensor.to(target.device)
    return state


def _find_adam_state(node):
    """The optax ``ScaleByAdamState`` inside a chain's state (any object
    with ``count``, ``mu`` and ``nu``), found by walking tuples."""
    if all(hasattr(node, name) for name in ('count', 'mu', 'nu')):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def _moment(name, array, param, dtype, net=None):
    tensor = _tensor(array, dtype)
    if net is not None:
        tensor = held_part(net, name, tensor)
    if tensor.shape != param.shape:
        raise ValueError('{}: moment shape {} does not match the '
                         'parameter\'s {}'.format(name, tuple(tensor.shape),
                                                  tuple(param.shape)))
    return tensor.to(param.device)


def _moments(params, tree, dtype_of, net=None):
    return {name: _moment(name, _leaf(tree, name), param, dtype_of(param),
                          net)
            for name, param in params.items()}


def opt_state_from_jax(net, opt_state_numpy):
    """The port's optimizer state for ``net`` from a JAX optimizer state
    whose arrays are numpy (``jax.tree_util.tree_map(np.asarray, state)``).

    - The lazy engine's ``{'mu': tree, 'nu': tree, 't': ()}`` becomes
      ``{'mu': {name: float32}, 'nu': {name: float32}, 't': int}``
      (:func:`~spotlight_tpu_torch.ops.lazy_adam.lazy_adam_init`'s layout).
    - The dense engine's optax chain state (``adam``, with or without
      ``add_decayed_weights``) becomes ``{'count': int, 'mu': {name:
      tensor}, 'nu': {name: tensor}}`` (:class:`~spotlight_tpu_torch.utils.
      training.Adam`'s layout), the moments in each parameter's dtype.
    - The sequence lazy engine's ``{'table': {'mu', 'nu'}, 'tower': optax
      chain state, 't': ()}`` becomes ``{'table': {'mu': float32, 'nu':
      float32}, 'tower': <the dense layout over every parameter but
      item_embeddings.weight>, 't': int}``
      (:func:`~spotlight_tpu_torch.sequence.lazy.lazy_seq_adam_init`'s).

    ``name`` is the parameter's name in ``net`` (``user_embeddings.weight``
    for the JAX tree's ``['user_embeddings']['weight']``).
    """
    params = dict(net.named_parameters())
    if isinstance(opt_state_numpy, dict) and set(opt_state_numpy) == {
            'mu', 'nu', 't'}:
        return {'mu': _moments(params, opt_state_numpy['mu'],
                               lambda p: torch.float32),
                'nu': _moments(params, opt_state_numpy['nu'],
                               lambda p: torch.float32),
                't': int(np.asarray(opt_state_numpy['t']))}
    if isinstance(opt_state_numpy, dict) and set(opt_state_numpy) == {
            'table', 'tower', 't'}:
        table = params.pop(TABLE)
        return {'table': {key: _moment(TABLE, opt_state_numpy['table'][key],
                                       table, torch.float32)
                          for key in ('mu', 'nu')},
                'tower': _adam_state(params, opt_state_numpy['tower']),
                't': int(np.asarray(opt_state_numpy['t']))}
    return _adam_state(params, opt_state_numpy, net)


def _adam_state(params, opt_state_numpy, net=None):
    """:class:`~spotlight_tpu_torch.utils.training.Adam`'s state over
    ``params`` (name -> parameter) from an optax chain state; the moments
    of ``net``'s sharded blocks are the blocks of JAX's global ones."""
    adam = _find_adam_state(opt_state_numpy)
    if adam is None:
        raise ValueError('no lazy state and no Adam state (count, mu, nu) '
                         'found in the optimizer state')
    return {'count': int(np.asarray(adam.count)),
            'mu': _moments(params, adam.mu, lambda p: p.dtype, net),
            'nu': _moments(params, adam.nu, lambda p: p.dtype, net)}
