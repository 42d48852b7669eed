"""Synthetic datasets with known properties, for model testing.

Counterpart of ``spotlight_tpu/data/synthetic.py``:

- :func:`generate_sequential`: an ``order``-th order Markov chain over
  items with a doubly stochastic transition matrix drawn from a Dirichlet
  distribution; a low ``concentration_parameter`` gives predictable chains;
- :func:`generate_factorization`: a low-rank latent-factor interaction
  sampler giving implicit or explicit datasets with known learnable
  structure.

Both are numpy, so the port keeps its own copy; the same ``RandomState``
gives the same arrays as the JAX package's.  The Markov walk runs in
:mod:`spotlight_tpu_torch.native` (C++, built by ``g++`` at first use),
bit-identical to the Python loop it replaces, which runs where the library
cannot be built: one step at a time, a few seconds for 1e4 steps over 1e3
states.
"""

from __future__ import annotations

import numpy as np

from spotlight_tpu_torch.data.interactions import Interactions


def _build_transition_matrix(num_items, concentration_parameter, random_state,
                             atol=0.001):
    def _is_doubly_stochastic(matrix):
        return (np.all(np.abs(1.0 - matrix.sum(axis=0)) < atol) and
                np.all(np.abs(1.0 - matrix.sum(axis=1)) < atol))

    transition_matrix = random_state.dirichlet(
        np.repeat(concentration_parameter, num_items), num_items)

    # Sinkhorn-style alternating normalisation to doubly stochastic.
    for _ in range(100):
        if _is_doubly_stochastic(transition_matrix):
            break
        transition_matrix /= transition_matrix.sum(axis=0)
        transition_matrix /= transition_matrix.sum(axis=1)[:, np.newaxis]

    return transition_matrix


def _generate_sequences(num_steps, transition_matrix, order, random_state):
    """The walk: each step's row is the mean of the last ``order`` states'
    cumulative rows, searched for one uniform draw."""
    num_states = transition_matrix.shape[0]
    cumulative = np.cumsum(transition_matrix, axis=1)

    rvs = random_state.rand(num_steps)
    state = random_state.randint(num_states, size=order, dtype=np.int64)

    from spotlight_tpu_torch import native

    elements = native.markov_walk(cumulative, rvs, state)
    if elements is not None:
        return elements

    elements = np.empty(num_steps, dtype=np.int32)
    for step, rv in enumerate(rvs):
        row = cumulative[state].mean(axis=0)
        new_state = min(num_states - 1, int(np.searchsorted(row, rv)))
        state[:-1] = state[1:]
        state[-1] = new_state
        elements[step] = new_state

    return elements


def generate_sequential(num_users=100,
                        num_items=1000,
                        num_interactions=10000,
                        concentration_parameter=0.1,
                        order=3,
                        random_state=None):
    """Generate a dataset of interactions where sequential information
    matters.

    Interactions follow an ``order``-th order Markov chain with a uniform
    stationary distribution; the transition probabilities of higher orders
    are the mean of the last ``order`` states' rows.  A
    ``concentration_parameter`` closer to zero gives more predictable
    sequences.  Item 0 is never drawn: it is the sequences' padding id.

    Returns
    -------
    :class:`~spotlight_tpu_torch.data.Interactions`
    """
    if random_state is None:
        random_state = np.random.RandomState()

    transition_matrix = _build_transition_matrix(
        num_items - 1, concentration_parameter, random_state)

    user_ids = np.sort(random_state.randint(
        0, num_users, num_interactions, dtype=np.int32))
    item_ids = _generate_sequences(num_interactions, transition_matrix,
                                   order, random_state) + 1
    timestamps = np.arange(len(user_ids), dtype=np.int32)
    ratings = np.ones(len(user_ids), dtype=np.float32)

    return Interactions(user_ids,
                        item_ids,
                        ratings=ratings,
                        timestamps=timestamps,
                        num_users=num_users,
                        num_items=num_items)


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
