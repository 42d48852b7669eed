"""Dense-engine training on 4-rank gloo meshes of CPU processes.

The ranks (``tests/torch_mesh_worker.py``, no JAX there) are spawned once
for the module, on two layouts of one world of four: data=1 x model=4 and
data=2 x model=2.  Each rank holds its block of every table and of its
Adam moments.  Held here:

- one step of the implicit model (BPR, uniform negatives, l2 on) from one
  state and one batch, under each exchange and layout, against the port's
  single-device step and against JAX's ``epoch_scan_distributed`` on a
  mesh of the same layout over the 8 virtual CPU devices, driven with an
  ``elems_fn`` that reads the negatives from the batch and handed the
  permutation it draws.  Tolerances are ``tests/test_torch_training.py``'s:
  parameters atol 1e-6, moments atol 1e-6 x the largest moment, the loss
  rtol 1e-6;
- in-batch negatives at data=2, which roll within each data rank's slice
  (as JAX's ``shard_map`` does): JAX's mesh step (parameters within
  ``INBATCH_PARAM_ATOL``, which says why), and not one device's;
- the JAX package's mesh gates (``tests/test_sharding.py``) at 2 x 2: the
  explicit model's RMSE within 1e-4 of one device's and its item table
  within rtol 1e-4 (psum, alltoall), implicit MRR above 0.03 (psum,
  alltoall), the LSTM's sequence MRR above 0.35, and pooling, CNN and
  mixture models that take a step and predict;
- a mesh-trained model saved by every rank loads on one device and scores
  and predicts as it did; given the mesh again it scores over the padded
  whole tables as it did, and ``fit`` there trains them replicated, within
  ``MESH_TRAIN_BOUND`` of one device's epoch;
- models fitted on one device and then given the mesh (MF and LSTM, dense
  and lazy) train replicated, every rank's whole tables one device's:
  bit for bit at 1 x 4 and for the lazy MF at 2 x 2, within
  ``MESH_TRAIN_BOUND`` elsewhere;
- a network whose item layer stays replicated (a plain
  ``torch.nn.Embedding``) while its user table shards scores the whole
  catalogue on the mesh, as one device does;
- the collective bytes of a step, from ``parallel.mesh.COLLECTIVE_BYTES``,
  for the three exchanges: 'alltoall_cf' moves a model-axis factor less
  than 'alltoall' (``tests/test_collective_volume.py`` pins JAX's), and an
  axis of one rank sends nothing.

The lazy engines on a mesh (``sparse=True``) are held in
``tests/test_torch_mesh_lazy.py``.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.cross_validation import (random_train_test_split,
                                            user_based_train_test_split)
from spotlight_tpu.factorization.representations import (
    BilinearNet as JaxBilinearNet)
from spotlight_tpu.ops.losses import bpr_loss
from spotlight_tpu.ops.sampling import (inbatch_importance_weight_table,
                                        inbatch_pair_weights,
                                        weighted_inbatch_elems)
from spotlight_tpu.parallel import sharding as jax_sharding
from spotlight_tpu.parallel import training as jax_ptraining
from spotlight_tpu.utils import training as jax_training
from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions, SequenceInteractions
from spotlight_tpu_torch.factorization import (ExplicitFactorizationModel,
                                               ImplicitFactorizationModel)
from spotlight_tpu_torch.factorization.representations import BilinearNet
from spotlight_tpu_torch.parallel import mesh as pmesh
from spotlight_tpu_torch.parallel.mesh import Mesh
from spotlight_tpu_torch.sequence import ImplicitSequenceModel
from spotlight_tpu_torch.utils import serialization
from spotlight_tpu_torch.utils.convert import (_find_adam_state,
                                                params_from_jax)

from tests import torch_mesh_worker as worker
from tests._fixtures import factorization_dataset, sequential_dataset
from tests.test_torch_mesh import LAYOUTS, jax_mesh
from tests.torch_mesh_worker import EXCHANGES, assert_step_close, held

#: Parameters atol 1e-6, moments 1e-6 of the largest, the loss rtol 1e-6
#: (``torch_mesh_worker.assert_step_close``).
#: In-batch, an item whose positive and rolled-negative terms nearly cancel
#: has a gradient of about 1e-7 that differs between the packages by 0.14%
#: (a difference of near-equal terms, summed in another order), and Adam's
#: first step, lr g / (|g| + eps) with eps 1e-8, magnifies that into a
#: parameter gap of 1.13e-6; the moments stay within MOMENT_SCALE.
INBATCH_PARAM_ATOL = 2e-6
#: The bound on a mesh-trained leaf against one device's where the sum
#: order differs, as a share of the leaf's largest magnitude (the smoke's
#: ``MESH_TRAIN_RTOL``).
MESH_TRAIN_BOUND = 1e-4
USERS, ITEMS, DIM, BATCH = 40, 103, 8, 32
WIDTH = DIM + 1
EXPLICIT = dict(loss='regression', embedding_dim=16, n_iter=3,
                batch_size=256, learning_rate=1e-2, l2=1e-6)


@functools.lru_cache(maxsize=None)
def step_case():
    """(the port's case, JAX's raw rows, the epoch key, JAX's tree): one
    batch in the order JAX's permutation of the key gives it, its
    negatives and in-batch weights, and a state drawn by JAX's network."""
    rs = np.random.RandomState(11)
    users = rs.randint(0, USERS, BATCH)
    items = rs.randint(0, ITEMS, BATCH)
    negatives = rs.randint(0, ITEMS, BATCH)
    weights = np.asarray(inbatch_importance_weight_table(items, ITEMS))[
        items].astype(np.float32)
    key = jax.random.PRNGKey(4)
    perm = np.asarray(jax.random.permutation(jax.random.split(key)[0],
                                             BATCH))
    tree = jax.tree_util.tree_map(np.asarray, JaxBilinearNet(
        USERS, ITEMS, DIM).init(jax.random.PRNGKey(2)))
    case = {'loss': 'bpr', 'dim': DIM, 'batch': BATCH, 'lr': 1e-2,
            'l2': 1e-6, 'num_users': USERS, 'num_items': ITEMS,
            'pairs': (users[perm], items[perm]),
            'negatives': negatives[perm], 'negative_weight': weights[perm],
            'state': {name: value.numpy() for name, value in
                      params_from_jax(BilinearNet(USERS, ITEMS, DIM),
                                      tree).items()}}
    raw = {'user_ids': users, 'item_ids': items, 'negatives': negatives,
           'negative_weight': weights}
    return case, raw, key, tree


def _arrays(interactions, *names):
    return tuple(np.asarray(getattr(interactions, name)) for name in names)


@functools.lru_cache(maxsize=None)
def gate_cases():
    """The datasets and settings of ``tests/test_sharding.py``'s gates,
    as numpy arrays for the ranks."""
    explicit = factorization_dataset(num_users=150, num_items=120,
                                     num_interactions=6000, explicit=True)
    train, test = random_train_test_split(
        explicit, random_state=np.random.RandomState(0))
    gates = {'explicit': {
        'num_users': 150, 'num_items': 120, 'config': EXPLICIT,
        'train': _arrays(train, 'user_ids', 'item_ids', 'ratings'),
        'test': _arrays(test, 'user_ids', 'item_ids', 'ratings')}}
    implicit = factorization_dataset(num_users=600, num_items=400,
                                     num_interactions=30000, rank=8,
                                     noise=0.15)
    train, test = random_train_test_split(
        implicit, random_state=np.random.RandomState(0))
    gates['implicit'] = {
        'num_users': 600, 'num_items': 400,
        'config': dict(loss='bpr', embedding_dim=32, n_iter=10,
                       batch_size=1024, learning_rate=1e-2, l2=1e-6),
        'train': _arrays(train, 'user_ids', 'item_ids'),
        'test': _arrays(test, 'user_ids', 'item_ids')}
    sequences = sequential_dataset(num_users=100, num_items=100,
                                   num_interactions=10000,
                                   concentration_parameter=1e-3, order=2,
                                   seed=42)
    train, test = user_based_train_test_split(
        sequences, random_state=np.random.RandomState(42))
    gates['sequence'] = {
        'num_items': 100,
        'config': dict(loss='bpr', representation='lstm', batch_size=128,
                       embedding_dim=32, learning_rate=1e-2, l2=1e-7,
                       n_iter=10),
        'train': np.asarray(train.to_sequence(
            max_sequence_length=10).sequences),
        'test': np.asarray(test.to_sequence(
            max_sequence_length=10).sequences)}
    gates['families'] = {
        'num_items': 50,
        'sequences': np.random.RandomState(0).randint(
            1, 50, size=(256, 6)).astype(np.int32),
        'config': dict(loss='adaptive_hinge', embedding_dim=16,
                       batch_size=64, n_iter=1)}
    return gates


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp('mesh_training')


@pytest.fixture(scope='module')
def ranks(workdir):
    gates = dict(gate_cases(), workdir=str(workdir))
    cases = {'layouts': LAYOUTS,
             'training': {'step': step_case()[0], 'gates': gates},
             'replicated': replicated_case()}
    return worker.run_ranks(cases, workdir)


@functools.lru_cache(maxsize=None)
def one_device_step(in_batch=False):
    case = step_case()[0]
    model = worker.implicit_model(
        case, None, negative_sampling='in_batch' if in_batch else 'uniform')
    return worker.one_step(model, case, None, 'psum', in_batch=in_batch)


@functools.lru_cache(maxsize=None)
def jax_step(layout, exchange, in_batch=False):
    """JAX's ``epoch_scan_distributed``, one step over the raw rows (it
    permutes them as the port's case has them): (loss, padded parameters
    and moments by the port's names)."""
    case, raw, key, tree = step_case()
    mesh = jax_mesh(layout)
    net = JaxBilinearNet(USERS, ITEMS, DIM).sharded(
        'model', layout[1], exchange=exchange)
    specs = net.param_specs()
    params = jax.tree_util.tree_map(
        lambda value, spec: jnp.pad(value, ((0, -value.shape[0]
                                             % layout[1]), (0, 0))),
        tree, specs, is_leaf=lambda x: isinstance(x, np.ndarray))
    optimizer = jax_training.make_optimizer(case['lr'], case['l2'])
    opt_state = optimizer.init(params)
    opt_specs = jax_ptraining.opt_specs_like(opt_state, params, specs)
    params = jax_sharding.shard_params(params, specs, mesh)
    opt_state = jax_sharding.shard_params(opt_state, opt_specs, mesh)

    def elems_fn(params, batch, key):
        users, items = batch['user_ids'], batch['item_ids']
        if in_batch:
            positive, negative = net.apply_with_inbatch_negatives(
                params, users, items, num_negatives=1)
            elems = bpr_loss(positive, negative, reduce=False)
            weight = inbatch_pair_weights(batch['negative_weight'],
                                          negative, 1)
            return (weighted_inbatch_elems('bpr', elems, negative, weight),
                    batch['mask'])
        positive, negative = net.apply_with_negatives(
            params, users, items, batch['negatives'])
        return bpr_loss(positive, negative, reduce=False), batch['mask']

    data = {name: jnp.asarray(value) for name, value in raw.items()}
    params, opt_state, loss = jax_ptraining.epoch_scan_distributed(
        params, opt_state, key, data, BATCH, 1, BATCH, elems_fn, optimizer,
        mesh, specs, opt_specs, exchange=exchange)
    adam = _find_adam_state(opt_state)

    def flat(tree):
        return {'{}.weight'.format(layer): np.asarray(leaves['weight'])
                for layer, leaves in tree.items()}
    return (float(loss), flat(params),
            {'mu': flat(adam.mu), 'nu': flat(adam.nu)})


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('exchange', EXCHANGES)
def test_step_equals_one_device(ranks, layout, exchange):
    """Every rank's blocks after one mesh step equal the blocks of one
    device's step from the same state and draws."""
    want = one_device_step()
    for rank, out in enumerate(ranks):
        assert_step_close(out[layout]['step', exchange], want, layout, rank)


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('exchange', EXCHANGES)
def test_step_equals_jax_epoch_scan_distributed(ranks, layout, exchange):
    want = jax_step(layout, exchange)
    for rank, out in enumerate(ranks):
        assert_step_close(out[layout]['step', exchange], want, layout, rank)


def test_in_batch_negatives_roll_within_the_data_slice(ranks):
    """At data=2 each data rank rolls its own 16 rows, as JAX's mesh step
    does; one device rolls all 32, and its step differs."""
    layout = (2, 2)
    want = jax_step(layout, 'psum', in_batch=True)
    for rank, out in enumerate(ranks):
        assert_step_close(out[layout]['step', 'in_batch'], want, layout,
                          rank, INBATCH_PARAM_ATOL)
    one = one_device_step(in_batch=True)
    assert abs(one[0] - want[0]) > 1e-4
    gap = np.abs(held(one[1]['item_embeddings.weight'], layout, 0)
                 - ranks[0][layout]['step', 'in_batch'][1][
                     'item_embeddings.weight']).max()
    assert gap > 1e-4


def test_explicit_gate_matches_one_device(ranks):
    """``test_sharding.py:101`` and ``:283`` at 2 x 2: RMSE within 1e-4 of
    one device's, item tables within rtol 1e-4."""
    case = gate_cases()['explicit']
    train, test = (Interactions(*case[which], num_users=case['num_users'],
                                num_items=case['num_items'])
                   for which in ('train', 'test'))
    single = ExplicitFactorizationModel(
        random_state=np.random.RandomState(42), device='cpu', **EXPLICIT)
    single.fit(train)
    rmse = evaluation.rmse_score(single, test)
    table = single._net.item_embeddings.weight.detach().numpy()
    for rank, out in enumerate(ranks):
        for exchange in ('psum', 'alltoall'):
            got_rmse, got_table = out[(2, 2)]['explicit', exchange]
            assert abs(got_rmse - rmse) < 1e-4
            np.testing.assert_allclose(got_table,
                                       held(table, (2, 2), rank),
                                       rtol=1e-4, atol=1e-5)


def test_learning_gates(ranks):
    """``test_sharding.py:131``, ``:316`` and ``:266`` at 2 x 2, and
    ``:248``: pooling, CNN and mixture models take a step and predict."""
    for out in ranks:
        got = out[(2, 2)]
        assert got['implicit', 'psum'] > 0.03
        assert got['implicit', 'alltoall'] > 0.03
        assert got['sequence'] > 0.35
        for representation in ('pooling', 'cnn', 'mixture'):
            loss, scores = got['family', representation]
            assert np.isfinite(loss)
            assert scores.shape == (50,) and np.isfinite(scores).all()
    for got in ranks[1:]:
        assert got[(2, 2)]['sequence'] == ranks[0][(2, 2)]['sequence']


def test_saved_mesh_model_loads_on_one_device(ranks, workdir):
    """Every rank saves (the tables gathered over the model axis); rank 0's
    file loads without a mesh, its tables whole and padded, and scores as
    the mesh model did."""
    case = gate_cases()['implicit']
    test = Interactions(*case['test'], num_users=case['num_users'],
                        num_items=case['num_items'])
    model = serialization.load(os.path.join(str(workdir),
                                            'mesh_model.rank0.pkl'))
    assert model._mesh is None and model._param_specs is None
    assert model._net.item_embeddings.weight.shape == (400, 33)
    assert model._opt_state['mu']['user_embeddings.weight'].shape == (
        600, 33)
    mrr, precision, catalogue, pairs = ranks[0][(2, 2)]['saved metrics']
    assert evaluation.mrr_score(model, test).mean() == mrr
    assert evaluation.precision_recall_score(
        model, test, k=5)[0].mean() == precision
    # predict on the mesh: every rank the whole catalogue's scores (its
    # block's, gathered over the model axis) and the pairs' (looked up
    # through the exchange); the products of a block and of the whole
    # table may round apart.
    assert catalogue.shape == (400,)
    np.testing.assert_allclose(model.predict(3), catalogue, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(
        model.predict(np.arange(5), np.arange(5)), pairs)
    for other in ranks[1:]:
        np.testing.assert_array_equal(other[(2, 2)]['saved metrics'][2],
                                      catalogue)


def test_loaded_model_given_a_mesh_again(ranks, workdir):
    """A saved mesh model, loaded and given the 2 x 2 mesh again, holds the
    whole padded tables on every rank: its metrics run over views of the
    padded catalogue and equal the mesh-trained model's.  Its ``fit``
    there trains replicated, as JAX's does: one epoch leaves every rank's
    whole tables and moments within ``MESH_TRAIN_BOUND`` of each table's
    scale of one device's epoch from the loaded file (the gradients of
    the two data ranks' halves are summed, in another order than one
    device's sum), the same on every rank."""
    case = gate_cases()['implicit']
    train = Interactions(*case['train'], num_users=case['num_users'],
                         num_items=case['num_items'])
    one = serialization.load(os.path.join(str(workdir),
                                          'mesh_model.rank0.pkl'))
    one._n_iter = 1
    one.fit(train)
    want = worker.state_arrays(one)
    for rank, out in enumerate(ranks):
        got = out[(2, 2)]
        holds, mrr, precision, block = got['loaded on the mesh']
        assert not holds
        # Each model rank scores its half of the padded catalogue.
        assert block == (200, 200 * (rank % 2))
        assert mrr == got['saved metrics'][0]
        assert precision == got['saved metrics'][1]
        loss, holds, state = got['loaded on the mesh', 'fit']
        assert not holds
        np.testing.assert_allclose(loss, one._last_epoch_loss, rtol=1e-5)
        assert_within_scale(state, want)
        worker.assert_same(state, ranks[0][(2, 2)]['loaded on the mesh',
                                                   'fit'][2])


def assert_within_scale(got, want, bound=None):
    """Whole states (``worker.state_arrays``) leaf by leaf: host numbers
    equal, arrays within ``bound`` (``MESH_TRAIN_BOUND``) of each leaf's
    largest magnitude."""
    bound = MESH_TRAIN_BOUND if bound is None else bound
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_allclose(
                got[key], value, rtol=0,
                atol=bound * np.abs(value).max(), err_msg=key)
        else:
            assert got[key] == value, key


@functools.lru_cache(maxsize=None)
def replicated_case():
    """A small MF set (40 users, 103 items, 640 pairs: 10 batches of 64)
    and LSTM set (64 sequences of 6 over 50 items: 2 batches of 32)."""
    rs = np.random.RandomState(17)
    return {'num_users': USERS, 'num_items': ITEMS,
            'pairs': (rs.randint(0, USERS, 640), rs.randint(0, ITEMS, 640)),
            'sequences': rs.randint(1, 50, size=(64, 6)),
            'sequence_items': 50,
            'mf': dict(loss='bpr', embedding_dim=DIM, n_iter=1,
                       batch_size=64, l2=1e-6),
            'lstm': dict(loss='bpr', representation='lstm',
                         embedding_dim=DIM, n_iter=1, batch_size=32)}


def one_device_continued(name, sparse):
    """One device's two epochs of the replicated case's model."""
    case = replicated_case()
    if name == 'MF':
        model = ImplicitFactorizationModel(
            sparse=sparse, random_state=np.random.RandomState(42),
            device='cpu', **case['mf'])
        data = Interactions(*case['pairs'], num_users=USERS,
                            num_items=ITEMS)
    else:
        model = ImplicitSequenceModel(
            sparse=sparse, random_state=np.random.RandomState(42),
            device='cpu', **case['lstm'])
        data = SequenceInteractions(case['sequences'], num_items=50)
    model.fit(data)
    model.fit(data)
    return model


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('name, sparse', [('MF', False), ('MF', True),
                                          ('LSTM', False), ('LSTM', True)])
def test_whole_tables_train_replicated_on_the_mesh(ranks, layout, name,
                                                   sparse):
    """A model fitted one epoch on one device, then given the mesh and
    fitted one epoch more: every rank holds whole tables (the specs all
    ``PartitionSpec()``), the same on every rank, equal to one device's
    second epoch.  Bit for bit at 1 x 4 (a data axis of one rank sends
    nothing) and for the lazy MF at 2 x 2 (the step's stream is gathered
    in one device's order); at 2 x 2 the dense engines' gradients and the
    LSTM tower's are summed over the two data ranks in another order than
    one device's sum, within ``MESH_TRAIN_BOUND`` of each table's scale."""
    want = one_device_continued(name, sparse)
    for out in ranks:
        lazy, loss, state = out[layout]['replicated', name, sparse]
        assert lazy == want._lazy == sparse
        np.testing.assert_allclose(loss, want._last_epoch_loss, rtol=1e-5)
        if layout == (1, 4) or (name, sparse) == ('MF', True):
            worker.assert_same(state, worker.state_arrays(want))
        else:
            assert_within_scale(state, worker.state_arrays(want))
        worker.assert_same(state, ranks[0][layout]['replicated', name,
                                                   sparse][2])


def test_replicated_item_layer_scores_the_whole_catalogue(ranks, workdir):
    """A classic network whose item layer ``sharded`` leaves replicated (a
    plain ``torch.nn.Embedding``) while its user table shards: the metrics
    take the whole catalogue, not a block, and every rank's equal one
    device's on the saved model."""
    case = gate_cases()['implicit']
    test = Interactions(*case['test'], num_users=case['num_users'],
                        num_items=case['num_items'])
    model = serialization.load(os.path.join(
        str(workdir), 'replicated_item_layer.rank0.pkl'))
    mrr = evaluation.mrr_score(model, test).mean()
    precision = evaluation.precision_recall_score(model, test, k=5)[0].mean()
    for rank, out in enumerate(ranks):
        item_block, user_block, got_mrr, got_precision, block = out[
            (2, 2)]['replicated item layer']
        assert not item_block and user_block
        # Not the whole table as the rank's block: each model rank scores
        # its half of the catalogue.
        assert block == (200, 200 * (rank % 2))
        assert got_mrr == mrr and got_precision == precision


def test_one_rank_axis_is_the_identity():
    """Along an axis of one rank each collective returns its input, and
    sends and counts nothing (no process group is needed)."""
    mesh = Mesh(1, 4, 0, torch.device('cpu'), groups={})
    tensor = torch.arange(8.0)
    pmesh.COLLECTIVE_BYTES = {}
    assert mesh.all_reduce(tensor, 'data') is tensor
    assert mesh.all_gather(tensor, 'data') is tensor
    assert mesh.all_to_all(tensor, 'data') is tensor
    assert pmesh.COLLECTIVE_BYTES == {}


def step_bytes(layout, exchange):
    """The collective bytes of one MF step (BPR, one negative: a user
    lookup of b ids and an item lookup of 2b), by (op, axis).  An axis of
    one rank sends nothing: at data=1 the gradients and the scalars of the
    'data' axis are not exchanged."""
    data, shards = layout
    b = BATCH // data // (shards if exchange == 'alltoall_cf' else 1)
    blocks = (-(-USERS // shards) + -(-ITEMS // shards)) * WIDTH * 4
    want = {}
    if exchange == 'alltoall_cf':
        want['all_reduce', 'data,model'] = 2 * 4  # the mask count, the loss
    elif data > 1:
        want['all_reduce', 'data'] = 2 * 4
    if data > 1:
        # Both tables' gradients, one flattened buffer.
        grads = ('all_reduce', 'data')
        want[grads] = want.get(grads, 0) + blocks
    ids = b + 2 * b
    if exchange == 'psum':
        want['all_reduce', 'model'] = ids * WIDTH * 4
    else:
        # Requests (int32), rows forward, cotangents back.
        want['all_to_all', 'model'] = shards * ids * (4 + 2 * WIDTH * 4)
    return want


@pytest.mark.parametrize('layout', LAYOUTS)
def test_collective_bytes_of_a_step(ranks, layout):
    for out in ranks:
        for exchange in EXCHANGES:
            assert out[layout]['bytes', exchange] == step_bytes(layout,
                                                                exchange)
    a2a = step_bytes(layout, 'alltoall')['all_to_all', 'model']
    cf = step_bytes(layout, 'alltoall_cf')['all_to_all', 'model']
    assert cf * layout[1] == a2a
