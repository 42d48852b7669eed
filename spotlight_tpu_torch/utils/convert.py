"""Parameters of the JAX package, carried into the port.

The JAX estimators keep their parameters as a tree of arrays.  Given that
tree as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, model._params)``),
:func:`params_from_jax` returns the port's ``state_dict`` for a
:class:`~spotlight_tpu_torch.factorization.representations.BilinearNet`, so
both packages can score with the same numbers.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(array, dtype):
    array = np.asarray(array)
    if array.dtype.name == 'bfloat16':
        # numpy has no bfloat16 of its own: carry the raw bits across.
        bits = torch.from_numpy(np.array(array).view(np.int16))
        return bits.view(torch.bfloat16).to(dtype)
    return torch.from_numpy(np.array(array)).to(dtype)


def params_from_jax(net, params_numpy):
    """The port's ``state_dict`` for ``net`` from a JAX parameter tree.

    Parameters
    ----------
    net : BilinearNet
    params_numpy : dict
        The fused layout's tree is ``{'user_embeddings': {'weight': (U, D+1)},
        'item_embeddings': {'weight': (N, D+1)}}``; ``fused=False`` adds
        ``'user_biases'`` and ``'item_biases'`` ``(., 1)`` tables beside
        ``(., D)`` embedding tables.

    Returns
    -------
    dict of tensors, on ``net``'s device and in its dtypes, ready for
    ``net.load_state_dict``.
    """
    own = net.state_dict()
    names = {name.split('.')[0] for name in own}
    if set(params_numpy) != names:
        raise ValueError('parameter tree has {} but the network expects {}'
                         .format(sorted(params_numpy), sorted(names)))
    state = {}
    for name, target in own.items():
        table, leaf = name.split('.')
        tensor = _tensor(params_numpy[table][leaf], target.dtype)
        if tensor.shape != target.shape:
            raise ValueError('{}: shape {} does not match the network\'s {}'
                             .format(name, tuple(tensor.shape),
                                     tuple(target.shape)))
        state[name] = tensor.to(target.device)
    return state
