"""Deterministic stand-ins for the packaged datasets, made from a seed.

Counterpart of ``spotlight_tpu/data/fixtures.py``.  The generators are
numpy only, so the port keeps its own copy: the same seed gives the same
columns, bit for bit, as the JAX package's.  Each installer writes its
columns as the HDF5 cache file the matching loader reads (the same path,
the MovieLens file names with their prefix twice), marks the file as a
fixture, and never overwrites an existing file, so one installed cache
feeds both packages.

- ``generate_movielens_100k_like``: 943 users x 1,682 items, exactly
  100,000 ratings on a 1-5 scale, every user with at least 20; a Zipf-like
  item popularity, log-normal user activity, ratings from a low-rank
  affinity plus biases, and items chosen by a Gumbel top-k over popularity
  and affinity, so that both factorisation and ranking models have signal.
- ``generate_movielens_1m_like``: 6,040 users x 3,706 items x 1,000,209
  ratings with *sequential* structure: one order-1 Markov walk over items
  whose transition matrix is low-rank (``p(j | i) = softmax_j(beta z_i .
  w_j + pop_weight log pop_j)``, rank 24, a Zipf popularity tail), cut
  into users of log-normal activity in [20, 2314].  An oracle that knows
  the matrix reaches a single-step MRR of about 0.134, popularity alone
  about 0.0145: sequence models (LSTM, CNN) learn it, pooling sees
  popularity only.  Item ids start at 1; 0 is the sequences' padding id.
- ``generate_amazon_like``: a miniature of the SNAP co-purchase set (4,000
  users, 6,000 items, 80,000 ratings) with non-contiguous raw ids and long
  tails, so that the loader's count filters and remap have work to do.
- ``generate_goodbooks_like``: a miniature goodbooks-10k ratings matrix
  (1,500 users, 800 books, 60,000 ratings), ids from 1.
"""

from __future__ import annotations

import os

import numpy as np

NUM_USERS = 943
NUM_ITEMS = 1682
NUM_RATINGS = 100_000
GLOBAL_MEAN = 3.53
LATENT_DIM = 8

FIXTURE_SEED = 20260818


def generate_movielens_100k_like(seed=FIXTURE_SEED):
    """Generate the ML-100K stand-in's columns.

    Returns
    -------
    dict with keys 'user_id', 'item_id', 'rating', 'timestamp'
        int32/float32 arrays of length ``NUM_RATINGS``.  Ids are 0-based,
        as in the packaged file.
    """
    rs = np.random.RandomState(seed)

    # Latent structure: low-rank affinity + biases.
    user_factors = rs.normal(0, 1.0 / np.sqrt(LATENT_DIM),
                             (NUM_USERS, LATENT_DIM))
    item_factors = rs.normal(0, 1.0 / np.sqrt(LATENT_DIM),
                             (NUM_ITEMS, LATENT_DIM))
    user_bias = rs.normal(0, 0.35, NUM_USERS)
    item_bias = rs.normal(0, 0.45, NUM_ITEMS)
    affinity = user_factors @ item_factors.T  # (U, I)

    # Item popularity: Zipf-ish tail, tilted toward well-liked items.
    ranks = np.arange(1, NUM_ITEMS + 1, dtype=np.float64)
    zipf = 1.0 / ranks ** 0.9
    rs.shuffle(zipf)
    log_pop = np.log(zipf) + 0.8 * item_bias

    # Per-user rating counts: log-normal in [20, 737], total exactly 100K.
    counts = np.exp(rs.normal(4.2, 0.75, NUM_USERS))
    counts = np.clip(counts, 20, 737)
    counts = np.floor(counts * (NUM_RATINGS / counts.sum())).astype(np.int64)
    counts = np.clip(counts, 20, NUM_ITEMS - 1)
    deficit = NUM_RATINGS - counts.sum()
    # Distribute the rounding deficit over users with headroom.
    order = rs.permutation(NUM_USERS)
    for u in np.tile(order, 10):
        if deficit == 0:
            break
        step = 1 if deficit > 0 else -1
        new = counts[u] + step
        if 20 <= new <= NUM_ITEMS - 1:
            counts[u] = new
            deficit -= step
    if counts.sum() != NUM_RATINGS:
        raise RuntimeError('ML-100K stand-in: {} ratings'.format(
            counts.sum()))

    users = np.repeat(np.arange(NUM_USERS, dtype=np.int32), counts)
    items = np.empty(NUM_RATINGS, dtype=np.int32)
    timestamps = np.empty(NUM_RATINGS, dtype=np.int32)

    base_time = 874_000_000  # the real dataset's epoch-seconds era
    offset = 0
    for u in range(NUM_USERS):
        n_u = counts[u]
        # Distinct items via Gumbel-top-k over popularity + affinity.
        gumbel = rs.gumbel(size=NUM_ITEMS)
        scores = log_pop + 1.2 * affinity[u] + gumbel
        chosen = np.argpartition(-scores, n_u)[:n_u].astype(np.int32)
        items[offset:offset + n_u] = chosen
        start = base_time + rs.randint(0, 20_000_000)
        timestamps[offset:offset + n_u] = (
            start + np.sort(rs.randint(0, 5_000_000, n_u)))
        offset += n_u

    noise = rs.normal(0, 0.8, NUM_RATINGS)
    raw = (GLOBAL_MEAN + user_bias[users] + item_bias[items]
           + affinity[users, items] + noise)
    ratings = np.clip(np.rint(raw), 1, 5).astype(np.float32)

    return {
        'user_id': users,
        'item_id': items,
        'rating': ratings,
        'timestamp': timestamps,
    }


def _install(subdirectory, filename, data_directory, seed, make_columns):
    """Write a fixture's cache file unless it exists: ``make_columns()``
    gives ``{HDF5 path: array}``, written to a temporary file marked as a
    fixture with its seed, which then takes the final name.  Returns the
    path."""
    import h5py

    from spotlight_tpu_torch.data import transport

    directory = os.path.join(
        os.path.abspath(data_directory or transport.data_dir()),
        subdirectory)
    transport.create_data_dir(directory)
    path = os.path.join(directory, filename)
    if os.path.isfile(path):
        return path

    tmp_path = path + '.tmp'
    with h5py.File(tmp_path, 'w') as f:
        for name, values in make_columns().items():
            f[name] = values
        f.attrs['synthetic_fixture'] = True
        f.attrs['generator_seed'] = seed
    os.replace(tmp_path, path)
    return path


def _rooted(columns):
    return {'/' + name: values for name, values in columns.items()}


def install_movielens_100k_fixture(data_directory=None, seed=FIXTURE_SEED):
    """Write the ML-100K stand-in as the cached '100K' HDF5 file (the path
    ``get_movielens_dataset('100K')`` reads).  An existing file is never
    overwritten.  Returns the file path."""
    return _install(
        os.path.join('movielens', 'v0.2.0'), 'movielens_movielens_100K.hdf5',
        data_directory, seed,
        lambda: _rooted(generate_movielens_100k_like(seed)))


ML1M_NUM_USERS = 6040
ML1M_NUM_ITEMS = 3706          # distinct rated movies in the real ML-1M
ML1M_NUM_RATINGS = 1_000_209
ML1M_RANK = 24                 # latent rank of the transition structure
ML1M_BETA = 10.0               # sequential-signal strength (softmax scale)
ML1M_POP_WEIGHT = 0.5          # popularity weight inside the softmax
ML1M_POP_EXPONENT = 0.85       # Zipf exponent of the popularity tail
ML1M_SEED = FIXTURE_SEED + 1


def generate_movielens_1m_like(seed=ML1M_SEED):
    """Generate the ML-1M stand-in's columns (sequential structure; see the
    module docstring).  The walk is :mod:`spotlight_tpu_torch.native`'s
    where it builds, else the Python loop, with the same result.

    Returns
    -------
    dict with keys 'user_id', 'item_id', 'rating', 'timestamp'
    """
    from spotlight_tpu_torch.data.synthetic import _generate_sequences

    rs = np.random.RandomState(seed)

    # Low-rank transition structure + popularity tail, in float32: the walk
    # needs CDF-grade precision only.
    context = rs.normal(0, 1, (ML1M_NUM_ITEMS, ML1M_RANK))
    target = rs.normal(0, 1, (ML1M_NUM_ITEMS, ML1M_RANK))
    context = (context / np.sqrt(ML1M_RANK)).astype(np.float32)
    target = (target / np.sqrt(ML1M_RANK)).astype(np.float32)
    zipf = 1.0 / np.arange(1, ML1M_NUM_ITEMS + 1) ** ML1M_POP_EXPONENT
    rs.shuffle(zipf)
    log_pop = np.log(zipf / zipf.sum()).astype(np.float32)

    logits = np.float32(ML1M_BETA) * (context @ target.T)
    logits += np.float32(ML1M_POP_WEIGHT) * log_pop[None, :]
    logits -= logits.max(axis=1, keepdims=True)
    transition_matrix = np.exp(logits)
    transition_matrix /= transition_matrix.sum(axis=1, keepdims=True)

    # Per-user activity: log-normal, clipped to the real [20, 2314] range,
    # renormalized to sum to exactly 1,000,209.
    counts = np.exp(rs.normal(4.75, 0.85, ML1M_NUM_USERS))
    counts = np.clip(counts, 20, 2314)
    counts = np.floor(
        counts * (ML1M_NUM_RATINGS / counts.sum())).astype(np.int64)
    counts = np.clip(counts, 20, 2314)
    deficit = ML1M_NUM_RATINGS - counts.sum()
    order = rs.permutation(ML1M_NUM_USERS)
    for u in np.tile(order, 20):
        if deficit == 0:
            break
        step = 1 if deficit > 0 else -1
        new = counts[u] + step
        if 20 <= new <= 2314:
            counts[u] = new
            deficit -= step
    if counts.sum() != ML1M_NUM_RATINGS:
        raise RuntimeError('ML-1M stand-in: {} ratings'.format(counts.sum()))

    users = np.repeat(np.arange(ML1M_NUM_USERS, dtype=np.int32), counts)
    # One global order-1 walk segmented per user; +1 keeps id 0 free for
    # sequence padding, as in the packaged real file.
    items = (_generate_sequences(ML1M_NUM_RATINGS, transition_matrix,
                                 1, rs) + 1).astype(np.int32)
    base_time = 956_700_000  # the real dataset's epoch-seconds era
    timestamps = base_time + np.arange(ML1M_NUM_RATINGS, dtype=np.int64)
    ratings = np.clip(np.rint(rs.normal(3.58, 0.95, ML1M_NUM_RATINGS)),
                      1, 5).astype(np.float32)

    return {
        'user_id': users,
        'item_id': items,
        'rating': ratings,
        'timestamp': timestamps.astype(np.int64),
    }


def install_movielens_1m_fixture(data_directory=None, seed=ML1M_SEED,
                                 columns=None):
    """Write the ML-1M stand-in as the cached '1M' HDF5 file.  An existing
    file is never overwritten.  Pass pre-generated ``columns`` to skip the
    generation.  Returns the file path."""
    return _install(os.path.join('movielens', 'v0.2.0'),
                    'movielens_movielens_1M.hdf5', data_directory, seed,
                    lambda: _rooted(columns if columns is not None
                                    else generate_movielens_1m_like(seed)))


AMAZON_NUM_USERS = 4000        # fixture scale (real set: ~1.6M users)
AMAZON_NUM_ITEMS = 6000        # real set: ~550K products
AMAZON_NUM_RATINGS = 80_000    # real set: ~8M ratings
AMAZON_SEED = FIXTURE_SEED + 2

GOODBOOKS_NUM_USERS = 1500     # real set: 53,424 users
GOODBOOKS_NUM_BOOKS = 800      # real set: 10,000 books
GOODBOOKS_NUM_RATINGS = 60_000  # real set: ~6M ratings
GOODBOOKS_SEED = FIXTURE_SEED + 3


def generate_amazon_like(seed=AMAZON_SEED):
    """Generate the Amazon stand-in's columns: raw ids drawn without
    replacement from a space ten times larger (unsorted in the ratings),
    log-normal user and Zipf item activity, so that a good share of each
    falls under the loader's default ``min_*_interactions=10``, and the
    auxiliary ``features_*`` columns the real file carries.

    Returns
    -------
    dict with keys 'user_id', 'item_id', 'rating', 'timestamp',
    'features_item_id', 'features_feature_id'
    """
    rs = np.random.RandomState(seed)

    raw_user_ids = np.sort(rs.choice(
        np.arange(1, AMAZON_NUM_USERS * 10, dtype=np.int32),
        AMAZON_NUM_USERS, replace=False))
    raw_item_ids = np.sort(rs.choice(
        np.arange(1, AMAZON_NUM_ITEMS * 10, dtype=np.int32),
        AMAZON_NUM_ITEMS, replace=False))

    # Long-tail sampling weights: ~25-35% of users and ~40-50% of items
    # fall under 10 interactions.
    user_w = rs.lognormal(0.0, 1.2, AMAZON_NUM_USERS)
    item_w = 1.0 / np.arange(1, AMAZON_NUM_ITEMS + 1) ** 1.05
    rs.shuffle(item_w)

    users = rs.choice(AMAZON_NUM_USERS, AMAZON_NUM_RATINGS,
                      p=user_w / user_w.sum())
    items = rs.choice(AMAZON_NUM_ITEMS, AMAZON_NUM_RATINGS,
                      p=item_w / item_w.sum())

    ratings = np.clip(np.rint(rs.normal(4.2, 1.0, AMAZON_NUM_RATINGS)),
                      1, 5).astype(np.float32)
    timestamps = np.sort(
        rs.randint(1_000_000_000, 1_100_000_000,
                   AMAZON_NUM_RATINGS)).astype(np.int64)

    n_features = 5000
    return {
        'user_id': raw_user_ids[users],
        'item_id': raw_item_ids[items],
        'rating': ratings,
        'timestamp': timestamps,
        'features_item_id': rs.choice(raw_item_ids,
                                      n_features).astype(np.int32),
        'features_feature_id': rs.randint(
            0, 1000, n_features).astype(np.int32),
    }


def install_amazon_fixture(data_directory=None, seed=AMAZON_SEED):
    """Write the Amazon stand-in as the cached co-purchasing HDF5 file
    (``<cache>/amazon/amazon_co_purchasing.hdf5``).  An existing file is
    never overwritten.  Returns the file path."""
    return _install('amazon', 'amazon_co_purchasing.hdf5', data_directory,
                    seed, lambda: _rooted(generate_amazon_like(seed)))


def generate_goodbooks_like(seed=GOODBOOKS_SEED):
    """Generate the goodbooks stand-in: one ``(n, 3)`` int32 matrix of
    (user_id, book_id, rating) rows, ids from 1, ratings skewed positive,
    no timestamps (as the real file)."""
    rs = np.random.RandomState(seed)

    user_w = rs.lognormal(0.0, 0.8, GOODBOOKS_NUM_USERS)
    book_w = 1.0 / np.arange(1, GOODBOOKS_NUM_BOOKS + 1) ** 0.9
    rs.shuffle(book_w)

    users = rs.choice(GOODBOOKS_NUM_USERS, GOODBOOKS_NUM_RATINGS,
                      p=user_w / user_w.sum()) + 1
    books = rs.choice(GOODBOOKS_NUM_BOOKS, GOODBOOKS_NUM_RATINGS,
                      p=book_w / book_w.sum()) + 1
    ratings = np.clip(np.rint(rs.normal(3.9, 1.0, GOODBOOKS_NUM_RATINGS)),
                      1, 5)

    return np.stack([users, books, ratings], axis=1).astype(np.int32)


def install_goodbooks_fixture(data_directory=None, seed=GOODBOOKS_SEED):
    """Write the goodbooks stand-in as the cached goodbooks-10k HDF5 file
    (``<cache>/goodbooks/goodbooks.hdf5``).  An existing file is never
    overwritten.  Returns the file path."""
    return _install('goodbooks', 'goodbooks.hdf5', data_directory, seed,
                    lambda: {'ratings': generate_goodbooks_like(seed)})


def is_synthetic_fixture(path):
    """True when ``path`` is a fixture written by this module."""
    import h5py

    with h5py.File(path, 'r') as f:
        return bool(f.attrs.get('synthetic_fixture', False))
