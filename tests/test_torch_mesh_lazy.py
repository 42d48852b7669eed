"""The row-sparse (lazy) engines on 4-rank gloo meshes of CPU processes.

The ranks (``tests/torch_mesh_worker.py``, no JAX there) are spawned once
for the module, on data=1 x model=4 and data=2 x model=2.  Each rank holds
its block of every table and of its moments, looks its slice's rows up
through the exchange outside autograd, gathers the step's ids and gradient
rows over the batch axes in role order and runs P1 on the rows it owns.
Held here (``tests/test_lazy_adam.py``'s mesh cases on the port's
layouts):

- the implicit (BPR) and explicit (regression) models on the 150 x 120
  set, D=16, 3 epochs of batch 256, l2 1e-6, under each exchange and
  layout: every rank's blocks of the tables and of ``mu`` and ``nu`` equal
  one device's lazy fit bit for bit, the padding rows zero, ``t`` equal;
  the capacity-factored explicit fit equals the psum one; bfloat16 tables
  with in-batch negatives at data=1 equal one device's;
- one lazy step from one state and JAX's own draws against JAX's
  ``build_lazy_epoch_fn(mesh=...)`` on a mesh of the same layout over the 8
  virtual CPU devices, at ``tests/test_torch_training.py``'s tolerances
  (``worker.assert_step_close``), in-batch at data=2 included;
- the lazy LSTM (256 sequences of 8 over 60 items, D=16, 2 epochs of
  batch 64) under 'psum' and 'alltoall': bit for bit at 1 x 4; at 2 x 2
  the tower's gradients are summed over 'data' in another order than one
  device's sum, and the fit is held within JAX's rtol 1e-4, atol 1e-6; the
  padding row and its moments stay zero, the moments are blocks;
- the streaming metrics of lazy-mesh models equal one device's and the
  materialize path's, with no call on the materialize route;
- 'alltoall_cf' with in-batch negatives falls back to the dense engine
  with JAX's RuntimeWarning, as the sequence models do under 'alltoall_cf';
- a saved lazy-mesh model loads on one device and resumes the lazy engine
  to one device's bits;
- the collective bytes of a lazy step, by formula: the batch axes carry
  the slice's ids and gradient rows, not table-sized gradients.
"""

import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.factorization import lazy as jax_lazy
from spotlight_tpu.factorization.representations import (
    BilinearNet as JaxBilinearNet)
from spotlight_tpu.ops.lazy_adam import lazy_adam_init as jax_lazy_adam_init
from spotlight_tpu.ops.sampling import (inbatch_importance_weight_table,
                                        sample_items_device)
from spotlight_tpu.parallel import sharding as jax_sharding
from spotlight_tpu.sequence import (
    ImplicitSequenceModel as JaxImplicitSequenceModel)
from spotlight_tpu_torch.data import SequenceInteractions
from spotlight_tpu_torch.factorization.representations import BilinearNet
from spotlight_tpu_torch.parallel.mesh import Mesh
from spotlight_tpu_torch.sequence import ImplicitSequenceModel
from spotlight_tpu_torch.sequence.lazy import build_lazy_step
from spotlight_tpu_torch.utils import serialization
from spotlight_tpu_torch.utils.convert import params_from_jax

from tests import torch_mesh_worker as worker
from tests._fixtures import factorization_dataset
from tests.test_torch_mesh import LAYOUTS, jax_mesh
from tests.torch_mesh_worker import EXCHANGES, assert_step_close, held

#: One step's case: JAX's network draws the state, JAX's key the batch's
#: permutation and negatives.
USERS, ITEMS, DIM, BATCH = 40, 103, 8, 32
WIDTH = DIM + 1
#: The lazy LSTM at 2 x 2: JAX's ``test_lazy_sequence_mesh_matches_single_
#: device`` tolerances.
SEQ_RTOL, SEQ_ATOL = 1e-4, 1e-6
#: In-batch, a near-cancelling gradient magnified by Adam's first step
#: (``tests/test_torch_mesh_training.py``'s ``INBATCH_PARAM_ATOL``).
INBATCH_PARAM_ATOL = 2e-6
TABLES = ('user_embeddings.weight', 'item_embeddings.weight')


@functools.lru_cache(maxsize=None)
def datasets():
    """The 150 x 120 implicit and explicit sets of ``tests/test_lazy_adam.
    py`` and its 256 LSTM sequences over 60 items, as numpy arrays."""
    implicit = factorization_dataset(num_users=150, num_items=120,
                                     num_interactions=6000)
    explicit = factorization_dataset(num_users=150, num_items=120,
                                     num_interactions=6000, explicit=True)
    return {
        'num_users': 150, 'num_items': 120,
        'implicit': (np.asarray(implicit.user_ids),
                     np.asarray(implicit.item_ids)),
        'explicit': (np.asarray(explicit.user_ids),
                     np.asarray(explicit.item_ids),
                     np.asarray(explicit.ratings)),
        'fit': dict(loss='bpr', embedding_dim=16, n_iter=3, batch_size=256,
                    learning_rate=1e-2, l2=1e-6),
        'sequences': np.random.RandomState(3).randint(
            1, 60, size=(256, 8)).astype(np.int32),
        'sequence_items': 60,
        'sequence_fit': dict(loss='bpr', representation='lstm',
                             embedding_dim=16, n_iter=2, batch_size=64)}


@functools.lru_cache(maxsize=None)
def step_case():
    """(the port's case, JAX's raw rows, the epoch key, JAX's tree): one
    batch in the order JAX's permutation of the key gives it, the negatives
    JAX's lazy engine draws from the key at the batch's width, in-batch
    weights, and a state drawn by JAX's network."""
    rs = np.random.RandomState(12)
    users = rs.randint(0, USERS, BATCH)
    items = rs.randint(0, ITEMS, BATCH)
    weights = np.asarray(inbatch_importance_weight_table(items, ITEMS))[
        items].astype(np.float32)
    key = jax.random.PRNGKey(5)
    perm_key, negatives_key = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(perm_key, BATCH))
    negatives = np.asarray(sample_items_device(
        jax.random.split(negatives_key, 1)[0], ITEMS, (1, BATCH)))[0]
    tree = jax.tree_util.tree_map(np.asarray, JaxBilinearNet(
        USERS, ITEMS, DIM).init(jax.random.PRNGKey(3)))
    case = {'loss': 'bpr', 'dim': DIM, 'batch': BATCH, 'lr': 1e-2,
            'l2': 1e-6, 'num_users': USERS, 'num_items': ITEMS,
            'pairs': (users[perm], items[perm]),
            'negatives': negatives.astype(np.int64),
            'negative_weight': weights[perm],
            'state': {name: value.numpy() for name, value in
                      params_from_jax(BilinearNet(USERS, ITEMS, DIM),
                                      tree).items()}}
    raw = {'user_ids': users, 'item_ids': items, 'negative_weight': weights}
    return case, raw, key, tree


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp('mesh_lazy')


@pytest.fixture(scope='module')
def ranks(workdir):
    case = dict(datasets(), step=step_case()[0], workdir=str(workdir))
    return worker.run_ranks({'layouts': LAYOUTS, 'lazy': case}, workdir)


@functools.lru_cache(maxsize=None)
def one_device(kind):
    """One device's lazy fit of the case's ``kind`` ('implicit',
    'explicit', 'sequence' or 'bf16 in-batch'), and the model."""
    case = datasets()
    if kind == 'sequence':
        model = worker.lazy_sequence(case)
    elif kind == 'bf16 in-batch':
        model = worker.lazy_bf16_in_batch(case)
        kind = 'implicit'
    else:
        model = worker.lazy_factorization(case, kind)
    model.fit(worker.lazy_data(case, kind))
    return worker.lazy_state(model), model


def assert_blocks_equal(got, want, layout, rank):
    """A rank's (loss, parameters, moments, t, lazy) against one device's:
    every block bit for bit (the padding rows zero), the step count
    equal, the loss within float32 (the ranks' sums reach it in another
    order)."""
    assert got[4] and want[4]
    assert got[3] == want[3]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for name, value in want[1].items():
        expected = held(value, layout, rank) if name in TABLES else value
        worker.assert_same(got[1][name], expected)
        if name in want[2]['mu']:
            for key in ('mu', 'nu'):
                worker.assert_same(got[2][key][name],
                                   held(want[2][key][name], layout, rank))


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('exchange', EXCHANGES)
@pytest.mark.parametrize('kind', ('implicit', 'explicit'))
def test_fit_equals_one_device_bit_for_bit(ranks, layout, exchange, kind):
    """``test_lazy_mesh_matches_single_device`` and its explicit twin: no
    exchange here is only numerically equivalent, the lookup being outside
    autograd (JAX's 'alltoall' drifts by XLA's codegen)."""
    want, _ = one_device(kind)
    for rank, out in enumerate(ranks):
        got = out[layout][kind, exchange]
        assert_blocks_equal(got, want, layout, rank)
        # The moments are blocks, as the tables.
        assert got[2]['mu']['item_embeddings.weight'].shape[0] == (
            -(-120 // layout[1]))


def test_padding_rows_of_the_blocks_stay_zero(ranks):
    """150 users over 4 model ranks: the last block holds 2 rows past the
    table, never touched, as its moments."""
    for rank in range(3, 4):
        got = ranks[rank][(1, 4)]['implicit', 'psum']
        for value in (got[1]['user_embeddings.weight'],
                      got[2]['mu']['user_embeddings.weight'],
                      got[2]['nu']['user_embeddings.weight']):
            assert value.shape[0] == 38
            assert not value[36:].any() and value[:36].any()


def test_capacity_factored_explicit_equals_psum(ranks):
    """``test_lazy_cf_explicit_matches_psum_mesh``: the same bits."""
    for out in ranks:
        for layout in LAYOUTS:
            worker.assert_same(out[layout]['explicit', 'alltoall_cf'][1],
                               out[layout]['explicit', 'psum'][1])


def test_in_batch_fit_at_one_data_rank_equals_one_device(ranks):
    """At data=1 the slice is the batch: in-batch negatives roll as one
    device's do; the bfloat16 tables' rows cross gloo in their dtype."""
    want, _ = one_device('bf16 in-batch')
    assert want[1]['item_embeddings.weight'].dtype == np.int16
    for rank, out in enumerate(ranks):
        assert_blocks_equal(out[(1, 4)]['implicit', 'in_batch'], want,
                            (1, 4), rank)


@functools.lru_cache(maxsize=None)
def jax_step(layout, exchange, in_batch=False):
    """JAX's ``build_lazy_epoch_fn(mesh=...)``, one step over the raw rows
    (it permutes them and draws the negatives as the port's case has them):
    (loss, padded parameters and moments by the port's names)."""
    case, raw, key, tree = step_case()
    mesh = jax_mesh(layout)
    net = JaxBilinearNet(USERS, ITEMS, DIM).sharded(
        'model', layout[1], exchange=exchange)
    specs = net.param_specs()
    params = jax.tree_util.tree_map(
        lambda value: jnp.pad(value, ((0, -value.shape[0] % layout[1]),
                                      (0, 0))), tree)
    opt_state = jax_lazy_adam_init(params)
    opt_specs = jax_lazy.lazy_opt_specs(specs)
    params = jax_sharding.shard_params(params, specs, mesh)
    opt_state = jax_sharding.shard_params(opt_state, opt_specs, mesh)
    epoch_fn = jax_lazy.build_lazy_epoch_fn(
        net, 'bpr', ITEMS, 1, BATCH, case['lr'], case['l2'], 1,
        negative_sampling='in_batch' if in_batch else 'uniform', mesh=mesh,
        param_specs=specs, exchange=exchange)
    data = {name: jnp.asarray(value) for name, value in raw.items()}
    params, opt_state, loss = epoch_fn(params, opt_state, key, data, BATCH)

    def flat(tree):
        return {'{}.weight'.format(layer): np.asarray(leaves['weight'])
                for layer, leaves in tree.items()}
    return (float(loss), flat(params),
            {'mu': flat(opt_state['mu']), 'nu': flat(opt_state['nu'])})


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('exchange', EXCHANGES)
def test_step_equals_jax_distributed_lazy_step(ranks, layout, exchange):
    want = jax_step(layout, exchange)
    for rank, out in enumerate(ranks):
        assert_step_close(out[layout]['step', exchange], want, layout, rank)


def test_in_batch_step_equals_jax_at_two_data_ranks(ranks):
    """Each data rank rolls its own 16 rows, as JAX's ``shard_map`` does."""
    layout = (2, 2)
    want = jax_step(layout, 'psum', in_batch=True)
    for rank, out in enumerate(ranks):
        assert_step_close(out[layout]['step', 'in_batch'], want, layout,
                          rank, INBATCH_PARAM_ATOL)


@pytest.mark.parametrize('exchange', ('psum', 'alltoall'))
def test_sequence_fit_equals_one_device(ranks, exchange):
    """The lazy LSTM: bit for bit at 1 x 4 (one data rank sums the tower's
    gradients as one device); within JAX's tolerances at 2 x 2.  The
    padding row and its moments stay zero; the moments are blocks of the
    item table (60 rows, 30 a block at model=2)."""
    want, _ = one_device('sequence')
    for rank, out in enumerate(ranks):
        assert_blocks_equal(out[(1, 4)]['sequence', exchange], want, (1, 4),
                            rank)
        got = out[(2, 2)]['sequence', exchange]
        assert got[4] and got[3] == want[3]
        for name, value in want[1].items():
            expected = (held(value, (2, 2), rank)
                        if name == 'item_embeddings.weight' else value)
            np.testing.assert_allclose(got[1][name], expected,
                                       rtol=SEQ_RTOL, atol=SEQ_ATOL,
                                       err_msg=name)
        for key in ('mu', 'nu'):
            block = got[2][key]['item_embeddings.weight']
            assert block.shape == (30, 17)
            if rank % 2 == 0:
                assert not block[0].any()
        if rank % 2 == 0:
            assert not got[1]['item_embeddings.weight'][0].any()


def test_streaming_metrics_of_lazy_mesh_models(ranks):
    """``test_lazy_mesh_streaming_eval_matches`` and its sequence twin at
    2 x 2: the streaming metrics equal one device's on its bit-equal
    tables, and the materialize path's within JAX's tolerance; no call
    took the materialize route."""
    case = datasets()
    _, implicit = one_device('implicit')
    _, sequence = one_device('sequence')
    want = {'implicit': worker.lazy_metrics(implicit, case, 'implicit'),
            'sequence': worker.lazy_metrics(sequence, case, 'sequence')}
    for out in ranks:
        got = out[(2, 2)]
        assert got['materialize_routes'] == 0
        for kind in ('implicit', 'sequence'):
            for key, value in got['metrics'][kind].items():
                if key[1]:
                    worker.assert_same(value, want[kind][key])
                np.testing.assert_allclose(
                    value, want[kind][key[0], True], rtol=1e-4, atol=1e-6)
    # The implicit model's tables are one device's: its metrics too.
    worker.assert_same(ranks[0][(2, 2)]['metrics']['implicit'],
                       want['implicit'])


def test_cf_with_in_batch_falls_back_loudly(ranks):
    """``test_lazy_cf_with_inbatch_falls_back_loudly``: the dense engine
    trains, with a RuntimeWarning naming the exchange."""
    for out in ranks:
        lazy, finite, messages = out[(2, 2)]['cf in-batch']
        assert not lazy and finite
        assert any('alltoall_cf' in message and 'in-batch' in message
                   for message in messages)


@pytest.mark.parametrize('kind', ('implicit', 'sequence'))
def test_saved_lazy_mesh_model_resumes_on_one_device(ranks, workdir, kind):
    """Rank 0's file (saved at 2 x 2 under 'psum', the blocks of the tables
    and moments gathered: the flat state, and the hybrid one with its
    tower state and ``t`` a host int) loads without a mesh and resumes the
    lazy engine: one more epoch equals one device's next epoch, bit for
    bit for the factorization model (its saved tables are one device's)
    and within JAX's tolerances for the LSTM."""
    model = serialization.load(os.path.join(str(workdir),
                                            'lazy_{}.rank0.pkl'.format(kind)))
    assert model._mesh is None and model._lazy
    state = model._opt_state
    moments = state['table'] if kind == 'sequence' else state['mu']
    if kind == 'sequence':
        assert moments['mu'].shape == (60, 17)
        assert state['tower']['count'] == state['t'] == 8
    else:
        assert moments['user_embeddings.weight'].shape == (150, 17)
        assert state['t'] == 72
    _, one = one_device(kind)
    resumed = worker.lazy_state(_next_epoch(model, kind))
    want = worker.lazy_state(_next_epoch(_copy(one), kind))
    assert resumed[3] == want[3] and resumed[4]
    for name, value in want[1].items():
        got = resumed[1][name][:value.shape[0]]
        if kind == 'implicit':
            worker.assert_same(got, value)
        else:
            np.testing.assert_allclose(got, value, rtol=SEQ_RTOL,
                                       atol=SEQ_ATOL, err_msg=name)


def _copy(model):
    """A copy of a one-device model through a pickle (the cached fit is
    left as it is)."""
    import io

    buffer = io.BytesIO()
    serialization.save(model, buffer)
    buffer.seek(0)
    return serialization.load(buffer)


def _next_epoch(model, kind):
    model._n_iter = 1
    return model.fit(worker.lazy_data(datasets(), kind))


def lazy_step_bytes(layout, exchange):
    """The collective bytes of one lazy MF step (BPR, one negative: a user
    lookup of b ids and an item lookup of 2b), by (op, axis).  The lookups
    are outside autograd: no cotangent travels back.  The batch axes carry
    the mask count and the loss (4 bytes each) and the role-ordered
    gathers of the step's 3b int64 ids and 3b float32 gradient rows of
    W = D + 1: 3b (8 + 4W) bytes.  An axis of one rank sends nothing."""
    data, shards = layout
    cf = exchange == 'alltoall_cf'
    b = BATCH // data // (shards if cf else 1)
    axes = 'data,model' if cf else 'data'
    want = {}
    if (data * shards if cf else data) > 1:
        want['all_reduce', axes] = 2 * 4
        want['all_gather', axes] = 3 * b * (8 + 4 * WIDTH)
    if exchange == 'psum':
        want['all_reduce', 'model'] = 3 * b * WIDTH * 4
    else:
        # Requests (int32) out, rows back.
        want['all_to_all', 'model'] = shards * 3 * b * (4 + WIDTH * 4)
    return want


@pytest.mark.parametrize('layout', LAYOUTS)
def test_collective_bytes_of_a_lazy_step(ranks, layout):
    """Every rank's bytes by formula.  At 1 x 4 under 'psum' and
    'alltoall' nothing crosses 'data'; the dense engine's step would
    all-reduce its (40 + 103) x 9 float32 table-gradient blocks over it
    at data=2 (``tests/test_torch_mesh_training.py``)."""
    for out in ranks:
        for exchange in EXCHANGES:
            assert out[layout]['bytes', exchange] == lazy_step_bytes(
                layout, exchange), exchange


def test_sequence_cf_falls_back_to_dense_as_jax():
    """``ImplicitSequenceModel(sparse=True, mesh=..., exchange=
    'alltoall_cf')`` trains dense with JAX's RuntimeWarning, word for
    word, and ``_lazy`` False, as JAX's does, on a mesh of one rank (its
    collectives the identity) and JAX's of one device."""
    from spotlight_tpu.data.interactions import (
        SequenceInteractions as JaxSequenceInteractions)
    from spotlight_tpu.parallel import make_mesh as jax_make_mesh

    case = datasets()
    config = dict(case['sequence_fit'], n_iter=1)
    model = ImplicitSequenceModel(
        sparse=True, mesh=Mesh(1, 1, 0, torch.device('cpu'), groups={}),
        exchange='alltoall_cf',
        random_state=np.random.RandomState(0), **config)
    with pytest.warns(RuntimeWarning, match='alltoall_cf') as got:
        model.fit(SequenceInteractions(case['sequences'],
                                       num_items=case['sequence_items']))
    assert not model._lazy and np.isfinite(model._last_epoch_loss)
    assert model._opt_state['count'] == 4
    jax_model = JaxImplicitSequenceModel(
        sparse=True, mesh=jax_make_mesh(devices=jax.devices()[:1]),
        exchange='alltoall_cf', random_state=np.random.RandomState(0),
        **config)
    with warnings.catch_warnings(record=True) as want:
        warnings.simplefilter('always')
        jax_model.fit(JaxSequenceInteractions(
            case['sequences'], num_items=case['sequence_items']))
    assert not jax_model._lazy
    assert ([str(w.message) for w in got if w.category is RuntimeWarning]
            == [str(w.message) for w in want
                if w.category is RuntimeWarning])
    # The engine itself takes only the two exchanges JAX's takes.
    with pytest.raises(ValueError, match="'psum' or 'alltoall'"):
        build_lazy_step(model._net, 'bpr', 1e-2, 0.0, 1, model._optimizer,
                        mesh=model._mesh, exchange='alltoall_cf')


def test_one_rank_axes_send_nothing_in_a_lazy_step():
    """On a mesh of one rank (no process group) a lazy step sends and
    counts nothing, and equals one device's step bit for bit."""
    from spotlight_tpu_torch.parallel import mesh as pmesh

    case = step_case()[0]
    mesh = Mesh(1, 1, 0, torch.device('cpu'), groups={})
    pmesh.COLLECTIVE_BYTES = {}
    got = worker.one_step(worker.implicit_model(case, mesh, sparse=True),
                          case, mesh, 'psum')
    assert pmesh.COLLECTIVE_BYTES == {}
    want = worker.one_step(worker.implicit_model(case, None, sparse=True),
                           case, None, 'psum')
    worker.assert_same(got, want)
