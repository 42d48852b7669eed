"""The port's sharded functions on 4-rank gloo meshes of CPU processes.

``spotlight_tpu_torch.parallel`` runs one process a rank.  The ranks here
are spawned once for the module (``tests/torch_mesh_worker.py``, which
imports no JAX), join one gloo group through a ``file://`` store, and run
every case on two layouts of that world: data=1 x model=4 and data=2 x
model=2.  Their results are held:

- to each other: every rank returns the same, replicated, result;
- to one device: the sharded functions equal the single-device kernels
  (counts, weights and top-k ids exactly; scores bit for bit) on a
  catalogue of 203 items padded to 204, for dot and mixture scoring, on a
  batch that splits over the data axis and on one that does not;
- to the JAX package's sharded functions on a mesh of the same layout over
  the 8 virtual CPU devices: counts, weights and top-k ids exactly, scores
  within float32.

The metrics of mesh models are held in ``tests/test_torch_mesh_metrics.py``
with the helpers here; the mesh, the row layout and a one-rank group below.

The factorization tables and the functions' operands are dyadic (each
product and partial sum exact in float32), so ties are many and exact in
both packages; mixture scores take an ``exp`` and are held to JAX within
float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from spotlight_tpu import evaluation as jax_eval
from spotlight_tpu.data.interactions import (
    SequenceInteractions as JaxSequenceInteractions)
from spotlight_tpu.parallel import evaluation as jax_pe
from spotlight_tpu.parallel import make_mesh as jax_make_mesh
from spotlight_tpu.parallel import sharding as jax_sharding
from spotlight_tpu.sequence import ImplicitSequenceModel as JaxSequenceModel
from spotlight_tpu.sequence.representations import (
    MixtureLSTMNet as JaxMixtureLSTMNet)
from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions, SequenceInteractions
from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
from spotlight_tpu_torch.ops.kernels import ranking, topk
from spotlight_tpu_torch.parallel import make_mesh, sharding
from spotlight_tpu_torch.sequence import ImplicitSequenceModel
from spotlight_tpu_torch.sequence.representations import MixtureLSTMNet
from spotlight_tpu_torch.utils import serialization
from spotlight_tpu_torch.utils.convert import params_from_jax

from tests import torch_mesh_worker as worker
from tests.torch_mesh_worker import assert_same

LAYOUTS = ((1, 4), (2, 2))
USERS, NUM_ITEMS, DIM, TARGETS, K, MIXTURES = 64, 203, 8, 3, 5, 2
PADDED = 204                      # NUM_ITEMS padded to a multiple of 4
SEQ_LENGTH, SEQ_K = 10, 3
MRR_RTOL = 1e-6
#: Scores against JAX's: dyadic dots are exact in both packages; a mixture
#: score's exp and softmax differ by a few ulps, as in
#: tests/test_torch_sequence.py.
SCORE_RTOL = 1e-5
FLOAT_MAX = np.finfo(np.float32).max


def dyadic(rs, shape, levels=4, step=0.125):
    """Multiples of ``step`` in ``[-levels, levels] * step``."""
    return (rs.randint(-levels, levels + 1, shape) * step).astype(np.float32)


def padded_catalogue(items, bias):
    """The catalogue padded as the metrics pad it: zero rows, bias
    -FLOAT_MAX."""
    pad = PADDED - len(items)
    return (np.concatenate([items, np.zeros((pad, items.shape[1]),
                                            np.float32)]),
            np.concatenate([bias, np.full(pad, -FLOAT_MAX, np.float32)]))


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


# -- the operands of the sharded functions ------------------------------------

@functools.lru_cache(maxsize=None)
def catalogue():
    rs = np.random.RandomState(0)
    return padded_catalogue(dyadic(rs, (NUM_ITEMS, DIM)),
                            dyadic(rs, NUM_ITEMS, step=1 / 64))


@functools.lru_cache(maxsize=None)
def function_case():
    rs = np.random.RandomState(1)
    items, bias = catalogue()
    case = {'users': dyadic(rs, (USERS, DIM)),
            'mix_users': dyadic(rs, (USERS, 2 * MIXTURES * DIM)),
            'items': items, 'bias': bias, 'k': K, 'mixtures': MIXTURES,
            # Targets over the four shards; candidates reach the pad row.
            'target_ids': rs.randint(0, NUM_ITEMS, (USERS, TARGETS)),
            'candidates': rs.randint(0, PADDED, (USERS, 7))}
    case['target_ids'][0] = [0, 51, NUM_ITEMS - 1]
    for name, users, mixture in (('dot', case['users'], None),
                                 ('mixture', case['mix_users'], MIXTURES)):
        case['target_scores_' + name] = one_device_scores(
            users, case['target_ids'], mixture)
    return case


def one_device_scores(users, ids, mixture):
    """One device's matched scores of ``ids`` over the padded catalogue."""
    items, bias = catalogue()
    args = (_t(users), _t(items), _t(bias), _t(ids))
    if mixture is None:
        return ranking.matched_target_scores(*args).numpy()
    return ranking.matched_candidate_scores(*args, mixture).numpy()


# -- the models ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def model_cases():
    """The factorization and mixture sequence cases (parameters in the
    port's ``state_dict`` layout) and their JAX parameter trees."""
    rs = np.random.RandomState(2)
    num_users = 64
    test = (np.repeat(np.arange(num_users), 3),
            rs.randint(0, NUM_ITEMS, 3 * num_users))
    train_users = rs.randint(0, num_users, 600)
    train_items = rs.randint(0, NUM_ITEMS, 600)
    # A heavy user: 40 train items widen the top-k over-fetch.
    train = (np.concatenate([np.full(40, 5), train_users]),
             np.concatenate([rs.choice(NUM_ITEMS, 40, replace=False),
                             train_items]))
    mf_tree = {'user_embeddings': {'weight': dyadic(rs, (num_users,
                                                         DIM + 1))},
               'item_embeddings': {'weight': dyadic(rs, (NUM_ITEMS,
                                                         DIM + 1))}}
    mf = {'num_users': num_users, 'num_items': NUM_ITEMS, 'dim': DIM,
          'k': K, 'test': test, 'train': train}
    mf['state'] = {name: value.numpy() for name, value in params_from_jax(
        _bare(mf)._net, mf_tree).items()}

    sequences = rs.randint(1, NUM_ITEMS, (USERS, SEQ_LENGTH)).astype(
        np.int32)
    sequences[:8, :4] = 0                         # padded prefixes
    seq = {'num_items': NUM_ITEMS, 'dim': DIM, 'mixtures': MIXTURES,
           'k': SEQ_K, 'sequences': sequences}
    seq_tree = _jax_sequence_tree(sequences)
    seq['state'] = {name: value.numpy() for name, value in params_from_jax(
        _bare_sequence(seq)._net, seq_tree).items()}
    return mf, seq, mf_tree, seq_tree


def _bare(case):
    """The case's model with its freshly drawn parameters."""
    model = ImplicitFactorizationModel(embedding_dim=case['dim'],
                                       device='cpu')
    model._initialize(worker.interactions(case, 'train', Interactions))
    return model


def _bare_sequence(case):
    model = ImplicitSequenceModel(
        representation=MixtureLSTMNet(case['num_items'], case['dim'],
                                      num_mixtures=case['mixtures']),
        embedding_dim=case['dim'], device='cpu')
    model._initialize(SequenceInteractions(case['sequences'],
                                           num_items=case['num_items']))
    return model


def _jax_sequence_tree(sequences):
    """An untrained JAX mixture network's parameters with seeded item
    biases (its initial biases are zero)."""
    model = JaxSequenceModel(
        loss='bpr', representation=JaxMixtureLSTMNet(
            NUM_ITEMS, DIM, num_mixtures=MIXTURES),
        embedding_dim=DIM, random_state=np.random.RandomState(2))
    model._initialize(JaxSequenceInteractions(sequences,
                                              num_items=NUM_ITEMS))
    tree = jax.tree_util.tree_map(np.array, model._params)
    weight = tree['item_embeddings']['weight']
    weight[1:, DIM] = 0.1 * np.random.RandomState(3).randn(NUM_ITEMS - 1)
    return tree


@functools.lru_cache(maxsize=None)
def jax_mesh(layout):
    data, model = layout
    return jax_make_mesh(data=data, model=model, devices=jax.devices()[:4])


@functools.lru_cache(maxsize=None)
def one_device_metrics():
    mf, seq, _, _ = model_cases()
    return worker.metrics(worker.factorization_model(mf),
                          mf, worker.sequence_model(seq), seq)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Every rank's results of the sharded functions, one dict a layout:
    both layouts in one spawn."""
    cases = {'layouts': LAYOUTS, 'functions': function_case()}
    return worker.run_ranks(cases, tmp_path_factory.mktemp('mesh'))


# -- every rank alike --------------------------------------------------------------

@pytest.mark.parametrize('layout', LAYOUTS)
def test_every_rank_returns_the_same_result(ranks, layout):
    for other in ranks[1:]:
        assert_same(other[layout], ranks[0][layout])


# -- the sharded functions -------------------------------------------------------

SCORINGS = (('dot', None), ('mixture', MIXTURES))


def _operands(name, short=False):
    case = function_case()
    users = case['users' if name == 'dot' else 'mix_users']
    if short:
        users = users[:-1]
    return users, case['items'], case['bias']


@functools.lru_cache(maxsize=None)
def jax_functions(layout, name):
    """The JAX package's sharded functions on the layout's mesh, streaming
    (its kernels in interpret mode), each with its own matched target
    scores (as its metrics take them).  The port's streaming and plain
    results are both held to these."""
    case = function_case()
    mesh = jax_mesh(layout)
    mixture = None if name == 'dot' else MIXTURES
    users, items, bias = (jnp.asarray(a) for a in _operands(name))
    kwargs = dict(mixture=mixture, interpret=True)
    target_scores = jax_pe.sharded_candidate_scores(
        mesh, users, items, bias, jnp.asarray(case['target_ids']), **kwargs)
    out = {'scores': np.asarray(jax_pe.sharded_candidate_scores(
        mesh, users, items, bias, jnp.asarray(case['candidates']),
        **kwargs))}
    out['weights'] = np.asarray(jax_pe.sharded_rank_weights(
        mesh, users, items, bias, target_scores, **kwargs))
    out['topk'] = _numpy(jax_pe.sharded_topk(mesh, users, items, bias, K,
                                             **kwargs))
    out['counts'] = _numpy(jax_pe.sharded_rank_counts(
        mesh, users, items, bias, target_scores,
        jnp.asarray(case['target_ids']), **kwargs))
    short, _, _ = _operands(name, short=True)
    out['topk', 'short'] = _numpy(jax_pe.sharded_topk(
        mesh, jnp.asarray(short), items, bias, K, **kwargs))
    return out


def _numpy(arrays):
    return tuple(np.asarray(a) for a in arrays)


@pytest.mark.parametrize('streaming', [True, False, 'short'])
@pytest.mark.parametrize('name,mixture', SCORINGS)
@pytest.mark.parametrize('layout', LAYOUTS)
def test_sharded_topk_matches_jax_and_one_device(ranks, layout, name,
                                                 mixture, streaming):
    scores, ids = ranks[0][layout]['topk', name, streaming]
    users, items, bias = _operands(name, short=streaming == 'short')
    want_scores, want_ids = topk.streaming_topk(_t(users), _t(items),
                                                _t(bias), K, mixture)
    assert_same(ids, want_ids.numpy())
    assert_same(scores, want_scores.numpy())
    jax_scores, jax_ids = jax_functions(layout, name)[
        ('topk', 'short') if streaming == 'short' else 'topk']
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_allclose(scores, jax_scores, rtol=SCORE_RTOL, atol=0)


@pytest.mark.parametrize('streaming', [True, False])
@pytest.mark.parametrize('name,mixture', SCORINGS)
@pytest.mark.parametrize('layout', LAYOUTS)
def test_sharded_rank_counts_match_jax_and_one_device(ranks, layout, name,
                                                      mixture, streaming):
    case = function_case()
    greater, equal = ranks[0][layout]['counts', name, streaming]
    users, items, bias = _operands(name)
    want = ranking.rank_counts(
        _t(users), _t(items), _t(bias),
        _t(case['target_scores_' + name]), _t(case['target_ids']), mixture)
    assert_same((greater, equal), tuple(w.numpy() for w in want))
    jax_greater, jax_equal = jax_functions(layout, name)['counts']
    np.testing.assert_array_equal(greater, jax_greater)
    np.testing.assert_array_equal(equal, jax_equal)


@pytest.mark.parametrize('name,mixture', SCORINGS)
@pytest.mark.parametrize('layout', LAYOUTS)
def test_sharded_rank_weights_match_jax_and_one_device(ranks, layout, name,
                                                       mixture):
    case = function_case()
    got = ranks[0][layout]['weights', name]
    users, items, bias = _operands(name)
    want = ranking.rank_weights(_t(users), _t(items), _t(bias),
                                _t(case['target_scores_' + name]), mixture)
    assert_same(got, want.numpy())
    np.testing.assert_array_equal(got, jax_functions(layout, name)['weights'])
    # Each target ties itself: a half-integer weight at least.
    assert np.all(got >= 0.5)


@pytest.mark.parametrize('short', [False, True])
@pytest.mark.parametrize('name,mixture', SCORINGS)
@pytest.mark.parametrize('layout', LAYOUTS)
def test_sharded_candidate_scores_are_the_matched_scores(ranks, layout, name,
                                                         mixture, short):
    """Bit-equal to one device's matched scores (the pad rows' among
    them), and to JAX's within float32."""
    case = function_case()
    got = ranks[0][layout][('scores', name, 'short') if short
                           else ('scores', name)]
    users, _, _ = _operands(name, short=short)
    candidates = case['candidates'][:len(users)]
    assert_same(got, one_device_scores(users, candidates, mixture))
    if not short:
        np.testing.assert_allclose(got, jax_functions(layout, name)['scores'],
                                   rtol=SCORE_RTOL, atol=0)


# -- the layout, the mesh, and what a one-rank group shows ---------------------

class _Coordinates:
    """A mesh's shape and one rank's coordinates, without a group."""

    def __init__(self, layout, rank):
        self.shape = {'data': layout[0], 'model': layout[1]}
        self.data_index, self.model_index = divmod(rank, layout[1])

    def index(self, axis):
        return self.data_index if axis == 'data' else self.model_index


@pytest.mark.parametrize('layout', LAYOUTS)
def test_shard_params_are_the_blocks_jax_places(layout):
    """Each rank's block of a row-sharded table is the block JAX places on
    the device at that rank's place in the grid; replicated leaves whole."""
    P = sharding.PartitionSpec
    rs = np.random.RandomState(4)
    tree = {'items': rs.randn(PADDED, 3).astype(np.float32),
            'tower': {'w': rs.randn(4, 5).astype(np.float32)}}
    specs = {'items': P('model', None), 'tower': {'w': P()}}
    from jax.sharding import PartitionSpec as JaxP
    placed = jax_sharding.shard_params(
        tree, {'items': JaxP('model', None), 'tower': {'w': JaxP()}},
        jax_mesh(layout))
    grid = np.asarray(jax_mesh(layout).devices)
    for rank in range(4):
        device = grid.reshape(-1)[rank]
        got = sharding.shard_params(
            {'items': _t(tree['items']), 'tower': {'w': _t(tree['tower']['w'])}},
            specs, _Coordinates(layout, rank))
        want = {shard.device: np.asarray(shard.data)
                for shard in placed['items'].addressable_shards}[device]
        np.testing.assert_array_equal(got['items'].numpy(), want)
        np.testing.assert_array_equal(got['tower']['w'].numpy(),
                                      tree['tower']['w'])
    assert sharding.replicated_like(specs) == {
        'items': P(), 'tower': {'w': P()}}
    assert sharding.rows_per_shard(NUM_ITEMS, 4) == (
        jax_sharding.rows_per_shard(NUM_ITEMS, 4))


def test_catalogue_padding_matches_jax():
    rs = np.random.RandomState(5)
    items = rs.randn(NUM_ITEMS, DIM).astype(np.float32)
    bias = rs.randn(NUM_ITEMS).astype(np.float32)
    got = evaluation._pad_catalog_for_shards(_Coordinates((1, 4), 0),
                                             _t(items), _t(bias))
    want = jax_eval._pad_catalog_for_shards(jax_mesh((1, 4)),
                                            jnp.asarray(items),
                                            jnp.asarray(bias))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].shape == (PADDED, DIM)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match='process group'):
        make_mesh(devices=['cpu'])


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group('gloo', init_method='file://{}'.format(
        tmp_path / 'store'), world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_sizes_and_refusals_match_jax(one_rank_group):
    """JAX's size inference and ValueErrors, over a world of one rank
    (JAX's over one device)."""
    mesh = make_mesh(devices=['cpu'])
    assert mesh.shape == dict(jax_make_mesh(devices=jax.devices()[:1]).shape)
    assert (mesh.data_index, mesh.model_index, str(mesh.device)) == (
        0, 0, 'cpu')
    assert make_mesh(model=1, devices=['cpu']).shape == {'data': 1,
                                                         'model': 1}
    for kwargs in ({'model': 2}, {'data': 2}, {'data': 1, 'model': 2}):
        with pytest.raises(ValueError) as got:
            make_mesh(devices=['cpu'], **kwargs)
        with pytest.raises(ValueError) as want:
            jax_make_mesh(devices=jax.devices()[:1], **kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match='2 devices for a world of 1'):
        make_mesh(devices=['cpu', 'cpu'])


def test_one_rank_mesh_model_evaluates_fits_and_pickles(one_rank_group,
                                                        tmp_path):
    """On a mesh with one model rank the metrics take the single-device
    path (as JAX decides); ``fit`` trains on the mesh to the bits of one
    device (a one-rank group's collectives change no value), and so does
    ``sparse=True`` there, which takes the lazy engines (factorization and
    LSTM) on the mesh; a saved model comes back with ``_mesh`` None, as
    JAX's does."""
    mf, seq, _, _ = model_cases()
    mesh = make_mesh(devices=['cpu'])
    model = worker.factorization_model(mf, mesh)
    assert model._mesh is mesh and model._device == torch.device('cpu')
    test = worker.interactions(mf, 'test', Interactions)
    np.testing.assert_array_equal(evaluation.mrr_score(model, test),
                                  one_device_metrics()['mrr', None])
    train = worker.interactions(mf, 'train', Interactions)
    one = worker.factorization_model(mf)
    model._n_iter = one._n_iter = 1
    model.fit(train)
    one.fit(train)
    assert model._last_epoch_loss == one._last_epoch_loss
    for name, value in one._net.state_dict().items():
        assert torch.equal(model._net.state_dict()[name], value), name
    sequences = SequenceInteractions(seq['sequences'], num_items=NUM_ITEMS)
    for fit in (lambda mesh, device: ImplicitFactorizationModel(
                    sparse=True, mesh=mesh, n_iter=1, device=device,
                    random_state=np.random.RandomState(0)).fit(train),
                lambda mesh, device: ImplicitSequenceModel(
                    representation='lstm', sparse=True, mesh=mesh, n_iter=1,
                    device=device, random_state=np.random.RandomState(0)
                ).fit(sequences)):
        lazy, lazy_one = fit(mesh, None), fit(None, 'cpu')
        assert lazy._lazy and lazy._opt_specs is not None
        assert lazy._last_epoch_loss == lazy_one._last_epoch_loss
        for name, value in lazy_one._net.state_dict().items():
            assert torch.equal(lazy._net.state_dict()[name], value), name
    serialization.save(model, str(tmp_path / 'model.pkl'))
    loaded = serialization.load(str(tmp_path / 'model.pkl'))
    assert loaded._mesh is None and loaded._shard_catalog_cache is None
    np.testing.assert_array_equal(evaluation.mrr_score(loaded, test),
                                  evaluation.mrr_score(one, test))
