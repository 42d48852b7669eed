"""Sharded checkpoints (``spotlight_tpu_torch.parallel.checkpoint``) against
the JAX package's orbax checkpoints, on the CPU.

In this process, on one device: a round trip of the dense and the lazy
engine's state (metrics bit for bit, a resumed ``fit`` equal to an
uninterrupted one, the generator's stream included), and the three
``ValueError``s of ``tests/test_checkpoint.py:182-239`` on the same
inputs, raised by both packages.

On four gloo ranks of CPU processes (``tests/torch_mesh_worker.py``'s
``checkpoint`` case, spawned once for the module) at 2 x 2 and 1 x 4 over
the 150 x 120 set (150 users: 152 rows at four shards, 150 at two):

- a one-device checkpoint restored at 1 x 4 and saved there, that restored
  at 2 x 2 and saved there, each restored on one device here: every block
  and every table equal to the one-device model's, padding rows zero;
- the file holds every rank's distinct block once: a 1 x 4 save restores
  whole, and the 2 x 2 save's bytes on disk are one copy of the state, not
  one a data replica;
- ``save_state`` hands the mesh's collectives no byte
  (``parallel.mesh.COLLECTIVE_BYTES``), where ``serialization.save``
  gathers the tables;
- JAX's state (``utils.convert``) restored by JAX at 2 x 4 over the 8
  virtual devices and by the port at 1 x 4: both padded to 152, equal;
- the lazy MF saved at 2 x 2: restored at 2 x 2 and at 1 x 4 (cut anew)
  and on one device here, ``t`` equal, each resumed ``fit`` bit for bit
  the saved model's continuation (the lazy engine is one device's bits at
  every layout);
- the sequence lazy engine's hybrid state of the LSTM (56 items: the same
  whole shape at 2 x 2 and 1 x 4, resharded by DCP) restored at 2 x 2 bit
  for bit and at 1 x 4 within ``tests/test_torch_mesh_lazy.py``'s rtol
  1e-4, atol 1e-6 (the tower's gradients are summed over 'data' at 2 x 2,
  in another order than at data=1).
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from spotlight_tpu.data import random_train_test_split
from spotlight_tpu.factorization import (
    ImplicitFactorizationModel as JaxImplicitModel)
from spotlight_tpu.parallel import checkpoint as jax_checkpoint
from spotlight_tpu.parallel import make_mesh as jax_make_mesh
from spotlight_tpu_torch.data import Interactions
from spotlight_tpu_torch.evaluation import mrr_score
from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
from spotlight_tpu_torch.parallel import checkpoint
from spotlight_tpu_torch.utils import serialization
from spotlight_tpu_torch.utils.convert import (_find_adam_state,
                                               opt_state_from_jax,
                                               params_from_jax)

from tests import torch_mesh_worker as worker
from tests._fixtures import factorization_dataset
from tests.torch_mesh_worker import held, state_arrays

MF = dict(loss='bpr', embedding_dim=8, n_iter=1, batch_size=512)
LSTM = dict(loss='bpr', representation='lstm', embedding_dim=8, n_iter=1,
            batch_size=32)
SEQUENCE_ITEMS = 56
RTOL, ATOL = 1e-4, 1e-6


@functools.lru_cache(maxsize=None)
def split():
    """``tests/test_checkpoint.py``'s data: 150 users, 120 items, the
    train and test split of the JAX package."""
    return random_train_test_split(
        factorization_dataset(num_users=150, num_items=120,
                              num_interactions=6000),
        random_state=np.random.RandomState(0))


def port(interactions):
    return Interactions(interactions.user_ids, interactions.item_ids,
                        num_users=interactions.num_users,
                        num_items=interactions.num_items)


def model(seed, sparse=False, **kwargs):
    config = dict(MF, **kwargs)
    return ImplicitFactorizationModel(
        sparse=sparse, random_state=np.random.RandomState(seed),
        device='cpu', **config)


def whole(got, name, key, layout, rows):
    """The whole table (its ``rows`` real rows) of the ranks' blocks under
    ``got[rank][name][key]`` (model coordinates 0 .. S - 1 are ranks 0 ..
    S - 1 at both layouts)."""
    parts = [got[rank][name][key] for rank in range(layout[1])]
    return np.concatenate(parts)[:rows]


def assert_blocks(got, want, layout, rank):
    """A rank's state arrays against a whole state (numpy arrays and host
    numbers) bit for bit: row-sharded leaves as the rank's block, the
    others whole."""
    assert got.keys() == want.keys()
    for key, value in want.items():
        if not isinstance(value, np.ndarray):
            assert got[key] == value, key
        elif got[key].shape == value.shape:
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key],
                                          held(value, layout, rank),
                                          err_msg=key)


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    """The one-device dense MF (one epoch, seed 42) and JAX's model,
    saved; JAX's restored onto its 2 x 4 mesh."""
    workdir = tmp_path_factory.mktemp('checkpoint')
    train, _ = split()
    one = model(42).fit(port(train))
    checkpoint.save_state(str(workdir / 'one_device'), one)

    jax_model = JaxImplicitModel(random_state=np.random.RandomState(42),
                                 **MF)
    jax_model.fit(train)
    converted = model(3)
    converted._initialize(port(train))
    tree = jax.tree_util.tree_map(np.asarray, jax_model._params)
    converted._load_params(params_from_jax(converted._net, tree))
    converted._opt_state = opt_state_from_jax(
        converted._net, jax.tree_util.tree_map(np.asarray,
                                               jax_model._opt_state))
    checkpoint.save_state(str(workdir / 'jax'), converted)
    jax_path = jax_checkpoint.save_state(str(workdir / 'orbax'), jax_model)
    sharded = JaxImplicitModel(mesh=jax_make_mesh(data=2, model=4),
                               random_state=np.random.RandomState(7), **MF)
    sharded._initialize(train)
    jax_checkpoint.restore_state(jax_path, sharded)
    return {'workdir': workdir, 'one': one, 'converted': converted,
            'jax 2x4': jax.tree_util.tree_map(np.asarray, (
                sharded._params, sharded._opt_state))}


@pytest.fixture(scope='module')
def ranks(saved):
    workdir = saved['workdir']
    train, _ = split()
    rs = np.random.RandomState(5)
    case = {'workdir': str(workdir), 'mf': MF, 'lstm': LSTM,
            'num_users': 150, 'num_items': 120,
            'pairs': (np.asarray(train.user_ids), np.asarray(train.item_ids)),
            'sequences': rs.randint(1, SEQUENCE_ITEMS, size=(128, 6)),
            'sequence_items': SEQUENCE_ITEMS,
            'one_device': str(workdir / 'one_device'),
            'jax': str(workdir / 'jax')}
    (workdir / 'ranks').mkdir()
    results = worker.run_ranks({'layouts': ((2, 2),), 'checkpoint': case},
                               workdir / 'ranks')
    return [out[(2, 2)] for out in results], case


@pytest.mark.parametrize('sparse', [False, True], ids=['dense', 'lazy'])
def test_one_device_round_trip(tmp_path, sparse):
    """Metrics bit for bit after the restore; the restored model's next
    epoch is the saved model's, bit for bit: parameters, moments, the step
    count and the generator's stream (the fresh model has another seed)."""
    train, test = split()
    train, test = port(train), port(test)
    saved_model = model(42, sparse).fit(train)
    path = checkpoint.save_state(str(tmp_path / 'ckpt'), saved_model)
    fresh = model(7, sparse)
    fresh._initialize(train)
    checkpoint.restore_state(path, fresh)
    np.testing.assert_array_equal(mrr_score(fresh, test),
                                  mrr_score(saved_model, test))
    saved_model.fit(train)
    fresh.fit(train)
    assert fresh._last_epoch_loss == saved_model._last_epoch_loss
    worker.assert_same(state_arrays(fresh), state_arrays(saved_model))


def test_force_and_the_initialized_model(tmp_path):
    train, _ = split()
    fitted = model(42).fit(port(train))
    path = str(tmp_path / 'ckpt')
    checkpoint.save_state(path, fitted)
    checkpoint.save_state(path, fitted, force=True)
    with pytest.raises(ValueError, match='already exists'):
        checkpoint.save_state(path, fitted, force=False)
    with pytest.raises(ValueError, match='unfitted'):
        checkpoint.save_state(str(tmp_path / 'other'), model(1))
    with pytest.raises(ValueError, match='Initialize the model'):
        checkpoint.restore_state(path, model(1))


def test_incompatible_checkpoint_raises_as_jax(tmp_path):
    """``tests/test_checkpoint.py:182``: a wider embedding cannot be
    adapted, a model of fewer users would drop non-zero rows; in both
    packages, and the port's model is left as it was."""
    train, _ = split()
    smaller_data = factorization_dataset(num_users=100, num_items=120,
                                         num_interactions=4000)
    config = dict(loss='bpr', n_iter=1, batch_size=512)

    jax_model = JaxImplicitModel(embedding_dim=32,
                                 random_state=np.random.RandomState(42),
                                 **config).fit(train)
    jax_path = jax_checkpoint.save_state(str(tmp_path / 'jax'), jax_model)
    fitted = ImplicitFactorizationModel(
        embedding_dim=32, random_state=np.random.RandomState(42),
        device='cpu', **config).fit(port(train))
    path = checkpoint.save_state(str(tmp_path / 'port'), fitted)
    for dim, data, message in ((48, train, 'cannot be adapted'),
                               (32, smaller_data, 'non-zero rows')):
        theirs = JaxImplicitModel(embedding_dim=dim,
                                  random_state=np.random.RandomState(7),
                                  **config)
        theirs._initialize(data)
        with pytest.raises(ValueError, match=message):
            jax_checkpoint.restore_state(jax_path, theirs)
        ours = ImplicitFactorizationModel(
            embedding_dim=dim, random_state=np.random.RandomState(7),
            device='cpu', **config)
        ours._initialize(port(data))
        before = state_arrays(ours)
        with pytest.raises(ValueError, match=message):
            checkpoint.restore_state(path, ours)
        worker.assert_same(state_arrays(ours), before)


def test_cross_engine_checkpoint_raises_as_jax(tmp_path):
    """``tests/test_checkpoint.py:214``: a dense state onto a lazy model
    and the reverse name the engine configuration, in both packages."""
    train, _ = split()
    config = dict(loss='bpr', n_iter=1, batch_size=512)
    paths = {}
    for sparse in (False, True):
        jax_model = JaxImplicitModel(sparse=sparse,
                                     random_state=np.random.RandomState(42),
                                     **config).fit(train)
        ours = ImplicitFactorizationModel(
            sparse=sparse, random_state=np.random.RandomState(42),
            device='cpu', **config).fit(port(train))
        paths[sparse] = (
            jax_checkpoint.save_state(str(tmp_path / 'jax{}'.format(sparse)),
                                      jax_model),
            checkpoint.save_state(str(tmp_path / 'port{}'.format(sparse)),
                                  ours))
    for sparse in (False, True):
        theirs = JaxImplicitModel(sparse=not sparse,
                                  random_state=np.random.RandomState(7),
                                  **config)
        theirs._initialize(train)
        with pytest.raises(ValueError, match='engine configuration'):
            jax_checkpoint.restore_state(paths[sparse][0], theirs)
        ours = ImplicitFactorizationModel(
            sparse=not sparse, random_state=np.random.RandomState(7),
            device='cpu', **config)
        ours._initialize(port(train))
        with pytest.raises(ValueError, match='engine configuration'):
            checkpoint.restore_state(paths[sparse][1], ours)


def test_bfloat16_tables_take_the_stored_values(tmp_path):
    """A float32 state restored onto bfloat16 tables of another padding (a
    one-rank mesh model's whole tables, padded as for four shards) is cast
    on the way in."""
    from spotlight_tpu_torch.factorization.representations import (
        BilinearNet)

    train, _ = split()
    fitted = model(42).fit(port(train))
    path = checkpoint.save_state(str(tmp_path / 'ckpt'), fitted)
    net = BilinearNet(150, 120, 8, table_dtype=torch.bfloat16).sharded(
        'model', 4)
    target = model(7, representation=net)
    target._initialize(port(train))
    checkpoint.restore_state(path, target)
    weight = target._net.user_embeddings.weight
    assert weight.dtype == torch.bfloat16 and weight.shape == (152, 9)
    want = fitted._net.user_embeddings.weight.detach()
    assert torch.equal(weight[:150], want.to(torch.bfloat16))
    assert not weight[150:].any()


def test_restores_across_layouts_and_back(saved, ranks):
    """One device -> 1 x 4 (152 rows) -> 2 x 2 (150) -> one device, and
    1 x 4 -> one device: every block, and every table restored here, equal
    to the one-device model's; the 1 x 4 file holds each rank's distinct
    block."""
    got, _ = ranks
    want = state_arrays(saved['one'])
    for rank, out in enumerate(got):
        # The padding rows of rank 3's user block (152 rows at 1 x 4) are
        # zero.
        assert_blocks(out['dense 1x4'], want, (1, 4), rank)
        assert_blocks(out['dense 2x2'], want, (2, 2), rank)
    train, _ = split()
    for name in ('dense_1x4', 'dense_2x2'):
        restored = model(11)
        restored._initialize(port(train))
        checkpoint.restore_state(str(saved['workdir'] / name), restored)
        worker.assert_same(state_arrays(restored), want)


def test_save_hands_the_collectives_no_table(ranks):
    """DCP writes each rank's blocks from the rank: the mesh's collectives
    carry nothing during ``save_state``; ``serialization.save`` gathers
    the tables over the model axis."""
    got, _ = ranks
    table_bytes = (150 + 120) * 9 * 4 // 2
    for out in got:
        for name in ('dense_1x4', 'dense_2x2', 'lazy_mf_2x2',
                     'lazy_lstm_2x2'):
            assert out['save bytes', name] == {}
        assert sum(out['pickle bytes'].values()) >= table_bytes


def test_bytes_on_disk_count_each_block_once(saved, ranks):
    """At 2 x 2 each block has two data replicas; the files of a 2,000 x
    1,000 model (D=32) hold one copy of its state: parameters, ``mu`` and
    ``nu`` of both tables, and a little beside (the step count, the
    generator's 5,056 bytes, each tensor's header)."""
    directory = saved['workdir'] / 'bytes_2x2'
    stored = sum(os.path.getsize(directory / name)
                 for name in os.listdir(directory)
                 if name.endswith('.distcp'))
    state = 3 * (2_000 + 1_000) * 33 * 4
    assert state <= stored < 1.05 * state


def test_jax_state_restores_on_the_same_layouts(saved, ranks):
    """JAX's checkpoint restored by JAX at 2 x 4 (8 virtual devices) and
    the same state (``utils.convert``) restored by the port at 1 x 4: both
    pad to 152 rows, with equal tables and moments."""
    got, _ = ranks
    params, opt_state = saved['jax 2x4']
    adam = _find_adam_state(opt_state)
    for name in ('user_embeddings', 'item_embeddings'):
        rows = 152 if name == 'user_embeddings' else 120
        for key, table in (('params', params), ('opt_state/mu', adam.mu),
                           ('opt_state/nu', adam.nu)):
            table = table[name]['weight']
            assert table.shape[0] == rows
            np.testing.assert_array_equal(
                whole(got, 'jax 1x4', '{}/{}.weight'.format(key, name),
                      (1, 4), rows), table)
    assert got[0]['jax 1x4']['opt_state/count'] == int(adam.count)


def test_lazy_state_resumes_on_every_layout(saved, ranks):
    """The lazy MF saved at 2 x 2 (one epoch): restored at 2 x 2 and 1 x 4
    (150 users cut anew into 152 rows) and fitted one epoch, bit for bit
    the saved model's second epoch; restored on one device here, ``t`` as
    saved, and its next epoch the same tables."""
    got, case = ranks
    for rank, out in enumerate(got):
        worker.assert_same(out['resumed', 'mf', '2x2'],
                           out['continued', 'mf'])
    for key in ('params/user_embeddings.weight',
                'opt_state/mu/user_embeddings.weight',
                'opt_state/nu/item_embeddings.weight'):
        rows = 150 if 'user' in key else 120
        np.testing.assert_array_equal(
            whole(got, ('resumed', 'mf', '1x4'), key, (1, 4), rows),
            whole(got, ('continued', 'mf'), key, (2, 2), rows))
    one, data = worker.checkpoint_model(case, None, sparse=True, seed=9)
    checkpoint.restore_state(str(saved['workdir'] / 'lazy_mf_2x2'), one)
    assert one._opt_state['t'] == got[0]['saved t', 'mf'] == 10
    assert isinstance(one._opt_state['t'], int)
    one.fit(data)
    for key, value in state_arrays(one).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(
                value, whole(got, ('continued', 'mf'), key, (2, 2),
                             len(value)), err_msg=key)


def test_sequence_hybrid_state_across_layouts(ranks):
    """The lazy LSTM's ``{'table', 'tower', 't'}`` saved at 2 x 2: resumed
    at 2 x 2 bit for bit, at 1 x 4 within rtol 1e-4, atol 1e-6 (the tower's
    gradient sums differ in order between data=2 and data=1)."""
    got, _ = ranks
    for out in got:
        worker.assert_same(out['resumed', 'lstm', '2x2'],
                           out['continued', 'lstm'])
        assert out['resumed', 'lstm', '1x4']['opt_state/t'] == 8
    for key, value in got[0]['continued', 'lstm'].items():
        if not isinstance(value, np.ndarray):
            continue
        if 'item_embeddings' in key or key.startswith('opt_state/table'):
            want = whole(got, ('continued', 'lstm'), key, (2, 2),
                         SEQUENCE_ITEMS)
            have = whole(got, ('resumed', 'lstm', '1x4'), key, (1, 4),
                         SEQUENCE_ITEMS)
        else:
            want, have = value, got[0]['resumed', 'lstm', '1x4'][key]
        np.testing.assert_allclose(have, want, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_pickled_mesh_model_loads_whole(saved, ranks):
    """For contrast: ``serialization.save`` of the 2 x 2 model gathers its
    tables, and the file loads on one device with the whole tables."""
    got, _ = ranks
    loaded = serialization.load(str(saved['workdir']
                                    / 'gathered.rank0.pkl'))
    assert loaded._mesh is None
    worker.assert_same(state_arrays(loaded), state_arrays(saved['one']))
