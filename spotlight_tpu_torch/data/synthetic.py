"""Synthetic datasets with known properties, for model testing.

Counterpart of ``spotlight_tpu/data/synthetic.py``'s
:func:`generate_factorization`: a low-rank latent-factor interaction sampler
giving implicit or explicit datasets with known learnable structure.  It is
numpy, so the port keeps its own copy; the same ``RandomState`` gives the
same arrays as the JAX package's.
"""

from __future__ import annotations

import numpy as np

from spotlight_tpu_torch.data.interactions import Interactions


def generate_factorization(num_users=1000,
                           num_items=1000,
                           num_interactions=30000,
                           rank=8,
                           noise=0.1,
                           explicit=False,
                           random_state=None):
    """Generate a low-rank interaction dataset with learnable structure.

    Users and items get latent factors of dimension ``rank``; each user
    interacts preferentially with high-affinity items via a softmax over
    noisy latent scores.  A matrix-factorization model should recover the
    structure (MRR well above the ~1/num_items chance level), while a random
    scorer cannot: the network-free stand-in for MovieLens in the learning
    gates.

    Parameters
    ----------
    explicit : bool
        If True, also attach ratings in [1, 5] derived from latent affinity.

    Returns
    -------
    :class:`~spotlight_tpu_torch.data.Interactions`
    """
    if random_state is None:
        random_state = np.random.RandomState()

    user_factors = random_state.randn(num_users, rank) / np.sqrt(rank)
    item_factors = random_state.randn(num_items, rank) / np.sqrt(rank)

    user_ids = random_state.randint(
        0, num_users, num_interactions).astype(np.int32)

    scores = user_factors[user_ids] @ item_factors.T  # (n, num_items)
    scores += noise * random_state.randn(*scores.shape)
    # Gumbel-max trick: one softmax sample per interaction, vectorized.
    gumbel = -np.log(-np.log(random_state.rand(*scores.shape)))
    item_ids = np.argmax(scores / max(noise, 1e-3) + gumbel,
                         axis=1).astype(np.int32)

    timestamps = np.arange(num_interactions, dtype=np.int32)

    if explicit:
        affinity = np.einsum('nd,nd->n',
                             user_factors[user_ids], item_factors[item_ids])
        affinity += noise * random_state.randn(num_interactions)
        ranks = affinity.argsort().argsort() / max(num_interactions - 1, 1)
        ratings = np.floor(ranks * 5).clip(0, 4).astype(np.float32) + 1.0
    else:
        ratings = np.ones(num_interactions, dtype=np.float32)

    return Interactions(user_ids,
                        item_ids,
                        ratings=ratings,
                        timestamps=timestamps,
                        num_users=num_users,
                        num_items=num_items)
