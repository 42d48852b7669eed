"""The port's row-sharded embedding layers and exchanges on 4-rank gloo
meshes of CPU processes.

The ranks (``tests/torch_mesh_worker.py``, no JAX there) are spawned once
for the module, on two layouts of one world of four: data=1 x model=4 and
data=2 x model=2.  Every table, id list and cotangent is dyadic, so each
sum is exact in any order and results are held bit for bit:

- ``ShardedEmbedding`` (over ``ScaledEmbedding`` with a padding row,
  ``ZeroEmbedding``, ``FusedBiasEmbedding``) and ``ShardedBloomEmbedding``
  under each exchange, each rank holding its block of a 103-row table
  (padded to 104; the bloom table's 51 rows to 52): the rows equal the
  dense layer's, and the block's gradient of ``sum(rows * cotangent)``, a
  cotangent that differs by position, equals the block of one device's
  (the engine's division by the model size for 'alltoall' included);
- the psum's backward is the identity, not a sum over the model axis;
- ``alltoall_lookup`` and ``alltoall_capacity_lookup`` (the default
  capacity and capacity 2 on ids all owned by one shard): rows, block
  gradients and overflow counts equal JAX's on a mesh of the same layout
  over the 8 virtual CPU devices, as ``tests/test_alltoall_cf.py`` drives
  it.

A mesh model loading whole tables keeps its blocks.  In the test process:
``opt_specs_like`` against JAX's structure, and the whole-table path a
loaded model takes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from spotlight_tpu.factorization.representations import (
    BilinearNet as JaxBilinearNet)
from spotlight_tpu.parallel import sharding as jax_sharding
from spotlight_tpu.parallel import training as jax_ptraining
from spotlight_tpu.utils import training as jax_training
from spotlight_tpu_torch.factorization.representations import BilinearNet
from spotlight_tpu_torch.ops.embeddings import (BloomEmbedding,
                                                ScaledEmbedding)
from spotlight_tpu_torch.parallel import sharding
from spotlight_tpu_torch.parallel.sharding import PartitionSpec
from spotlight_tpu_torch.parallel.training import opt_specs_like
from spotlight_tpu_torch.utils import training
from spotlight_tpu_torch.utils.convert import (_find_adam_state,
                                                params_from_jax)

from tests import torch_mesh_worker as worker
from tests.test_torch_mesh import LAYOUTS, dyadic, jax_mesh
from tests.torch_mesh_worker import EXCHANGES, assert_same

NUM_IDS = 103
WIDTHS = {'scaled': 8, 'zero': 1, 'fused': 9, 'bloom': 8}
BLOOM_ROWS = int(worker.BLOOM_RATIO * NUM_IDS)         # 51
RAW_ROWS, RAW_DIM = 64, 4


@functools.lru_cache(maxsize=None)
def table_case():
    rs = np.random.RandomState(5)
    case = {'num_ids': NUM_IDS}
    for kind, width in WIDTHS.items():
        rows = BLOOM_ROWS if kind == 'bloom' else NUM_IDS
        case[kind] = dyadic(rs, (rows, width))
        if kind != 'zero':
            case[kind][0] = 0.0                 # the padding row
        case['cot_' + kind] = dyadic(rs, (16, 6, width), step=0.25)
    case['ids'] = rs.randint(0, NUM_IDS, (16, 6))
    case['ids'][0, :3] = [0, 102, 51]
    case['raw_weight'] = dyadic(rs, (RAW_ROWS, RAW_DIM))
    case['raw_ids'] = rs.randint(0, RAW_ROWS, 8)
    case['raw_cot'] = dyadic(rs, (8, RAW_DIM), step=0.25)
    # 5 ids a shard of 4 (10 of 2), every one owned by shard 0.
    case['skewed_ids'] = rs.randint(0, 16, 20)
    case['skewed_cot'] = dyadic(rs, (20, RAW_DIM), step=0.25)
    case['load_tree'] = {
        'user_embeddings': {'weight': dyadic(rs, (30, 5))},
        'item_embeddings': {'weight': dyadic(rs, (NUM_IDS, 5))}}
    return case


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    cases = {'layouts': LAYOUTS, 'tables': table_case()}
    return worker.run_ranks(cases, tmp_path_factory.mktemp('tables'))


def one_device(kind):
    """(rows, padded gradient) of the dense layer on the case's ids."""
    case = table_case()
    inner = worker.dense_layer(kind, case[kind], NUM_IDS)
    vectors = inner(torch.as_tensor(case['ids']))
    loss = (vectors * torch.as_tensor(case['cot_' + kind])).sum()
    (grad,) = torch.autograd.grad(loss, [inner.weight])
    rows = sharding.rows_per_shard(grad.shape[0], 4) * 4
    grad = torch.cat([grad, grad.new_zeros(rows - grad.shape[0],
                                           grad.shape[1])])
    return vectors.detach().numpy(), grad.numpy()


def block(array, layout, rank):
    """The block of a padded array that ``rank`` holds on ``layout``."""
    shards = layout[1]
    rows = -(-array.shape[0] // shards)
    index = rank % shards
    return array[index * rows:(index + 1) * rows]


def model_part(array, layout, rank):
    rows = array.shape[0] // layout[1]
    index = rank % layout[1]
    return array[index * rows:(index + 1) * rows]


@pytest.mark.parametrize('layout', LAYOUTS)
@pytest.mark.parametrize('kind', sorted(WIDTHS))
@pytest.mark.parametrize('exchange', EXCHANGES)
def test_sharded_layers_equal_the_dense_layer(ranks, layout, kind,
                                              exchange):
    """Rows and block gradients bit for bit, on every rank."""
    vectors, grad = one_device(kind)
    for rank, out in enumerate(ranks):
        got_vectors, got_grad = out[layout]['table', kind, exchange]
        want_vectors = (model_part(vectors, layout, rank)
                        if exchange == 'alltoall_cf' else vectors)
        padded = sharding.rows_per_shard(len(table_case()[kind]),
                                         layout[1]) * layout[1]
        assert_same(got_vectors, want_vectors)
        assert_same(got_grad, block(grad[:padded], layout, rank))


@pytest.mark.parametrize('layout', LAYOUTS)
def test_psum_backward_is_the_identity(ranks, layout):
    """The sum over the model axis forward (every rank held the same
    tensor: the model size times it) and the cotangent unchanged back,
    not multiplied by the model size."""
    cot = table_case()['raw_cot']
    for out in ranks:
        summed, grad = out[layout]['psum backward']
        assert_same(summed, cot * layout[1])
        assert_same(grad, np.full_like(cot, 3.0))


def jax_exchanges(layout):
    """JAX's rows, block gradients and overflow counts of the three raw
    exchange cases on a mesh of ``layout``."""
    case = table_case()
    mesh = jax_mesh(layout)
    weight = jnp.asarray(case['raw_weight'])
    out = {}

    def grad_of(lookup, ids_spec, cot_spec, out_spec):
        @functools.partial(shard_map, mesh=mesh,
                           in_specs=(P('model', None), ids_spec, cot_spec),
                           out_specs=(out_spec, P('model', None),
                                      P('model')),
                           check_vma=False)
        def run(w_local, ids, cot):
            def loss(w):
                vectors, overflow = lookup(w, ids)
                return (vectors * cot).sum(), (vectors, overflow)
            grad, (vectors, overflow) = jax.grad(loss, has_aux=True)(
                w_local)
            return vectors, grad, overflow[None]
        return run

    run = grad_of(lambda w, ids: (jax_sharding.alltoall_lookup(w, ids),
                                  jnp.zeros((), jnp.int32)),
                  P(), P(), P())
    vectors, grad, _ = run(weight, jnp.asarray(case['raw_ids']),
                           jnp.asarray(case['raw_cot']))
    out['alltoall'] = (np.asarray(vectors), np.asarray(grad), None)
    for name, ids, cot, capacity in (
            ('cf', 'raw_ids', 'raw_cot', None),
            ('cf capacity 2', 'skewed_ids', 'skewed_cot', 2)):
        run = grad_of(functools.partial(
            jax_sharding.alltoall_capacity_lookup, capacity=capacity),
            P('model'), P('model', None), P('model', None))
        vectors, grad, overflow = run(weight, jnp.asarray(case[ids]),
                                      jnp.asarray(case[cot]))
        out[name] = (np.asarray(vectors), np.asarray(grad),
                     np.asarray(overflow))
    return out


@pytest.mark.parametrize('layout', LAYOUTS)
def test_exchanges_equal_jax(ranks, layout):
    """The raw exchanges against JAX's: rows, block gradients (each model
    rank's backward reaches the owner, no division) and overflow counts,
    bit for bit; capacity 2 overflows on the skewed ids."""
    want = jax_exchanges(layout)
    for rank, out in enumerate(ranks):
        vectors, grad, _ = out[layout]['exchange', 'alltoall']
        assert_same(vectors, want['alltoall'][0])
        assert_same(grad, model_part(want['alltoall'][1], layout, rank))
        for name in ('cf', 'cf capacity 2'):
            vectors, grad, overflow = out[layout]['exchange', name]
            assert_same(vectors, model_part(want[name][0], layout, rank))
            assert_same(grad, model_part(want[name][1], layout, rank))
            assert overflow == int(want[name][2][rank % layout[1]])
    overflows = [out[layout]['exchange', 'cf capacity 2'][2]
                 for out in ranks]
    assert min(overflows) > 0
    assert all(out[layout]['exchange', 'cf'][2] == 0 for out in ranks)


@pytest.mark.parametrize('layout', LAYOUTS)
def test_mesh_model_loads_whole_tables_as_blocks(ranks, layout):
    """``params_from_jax`` and then ``_load_params`` on a mesh model give
    each rank its block of each whole table once (the second call passes
    a block through), the padded rows zero."""
    tree = table_case()['load_tree']
    for rank, out in enumerate(ranks):
        for name in ('user_embeddings', 'item_embeddings'):
            assert_same(out[layout]['loaded'][name + '.weight'],
                        block_of_padded(tree[name]['weight'], layout, rank))


def block_of_padded(array, layout, rank):
    rows = sharding.rows_per_shard(len(array), layout[1]) * layout[1]
    padded = np.concatenate([array, np.zeros(
        (rows - len(array),) + array.shape[1:], array.dtype)])
    return block(padded, layout, rank)


@pytest.mark.parametrize('fused', [True, False])
def test_opt_specs_like_matches_jax(fused):
    """Adam's moments inherit the parameters' specs by structure, the step
    count replicates, as JAX's ``opt_specs_like`` assigns them."""
    generator = torch.Generator().manual_seed(0)
    net = BilinearNet(30, 41, 4, fused=fused, generator=generator).sharded(
        'model', 4)
    params = dict(net.named_parameters())
    specs = net.param_specs()
    state = training.Adam(1e-2, 1e-6).init(params)
    got = opt_specs_like(state, params, specs)

    jax_net = JaxBilinearNet(30, 41, 4, fused=fused).sharded('model', 4)
    jax_params = jax_net.init(jax.random.PRNGKey(0))
    jax_specs = jax_net.param_specs()
    jax_state = jax_training.make_optimizer(1e-2, 1e-6).init(jax_params)
    want = jax_ptraining.opt_specs_like(jax_state, jax_params, jax_specs)

    def flat(tree):
        return {'{}.{}'.format(layer, leaf): spec
                for layer, leaves in tree.items()
                for leaf, spec in leaves.items()}

    adam = _find_adam_state(want)
    assert specs == flat(jax_specs)
    assert got == {'count': PartitionSpec(), 'mu': flat(adam.mu),
                   'nu': flat(adam.nu)}
    assert adam.count == P()
    assert all(spec == PartitionSpec('model', None)
               for spec in specs.values())


def test_whole_table_path_of_a_loaded_model():
    """A sharded layer holding the whole padded table (a model saved from
    a mesh, loaded on one device) looks up by a plain gather: the dense
    layer's rows and gradients, none on the pad row; JAX's padded tables
    load into it."""
    case = table_case()
    ids = torch.as_tensor(case['ids'])
    for kind in ('scaled', 'bloom'):
        inner = worker.dense_layer(kind, case[kind], NUM_IDS)
        layer = (sharding.ShardedBloomEmbedding if kind == 'bloom'
                 else sharding.ShardedEmbedding)(inner, num_shards=4)
        assert not layer.holds_block and layer.mesh is None
        assert layer.weight.shape[0] == layer.padded_rows
        want, grad = one_device(kind)
        rows = layer(ids)
        assert_same(rows.detach().numpy(), want)
        (got,) = torch.autograd.grad(
            (rows * torch.as_tensor(case['cot_' + kind])).sum(),
            [layer.weight])
        assert_same(got.numpy(), grad[:layer.padded_rows])

    net = BilinearNet(30, NUM_IDS, 4, generator=torch.Generator()).sharded(
        'model', 4)
    jax_net = JaxBilinearNet(30, NUM_IDS, 4).sharded('model', 4)
    tree = jax.tree_util.tree_map(np.asarray, jax_net.init(
        jax.random.PRNGKey(3)))
    assert tree['item_embeddings']['weight'].shape == (104, 5)
    net.load_state_dict(params_from_jax(net, tree))
    users = torch.arange(30) % 30
    items = torch.arange(30) * 3
    np.testing.assert_array_equal(
        net(users, items).detach().numpy(),
        np.asarray(jax_net.apply(jax.tree_util.tree_map(jnp.asarray, tree),
                                 jnp.asarray(users.numpy()),
                                 jnp.asarray(items.numpy()))))


def test_unknown_exchange_and_a_block_without_mesh_raise():
    inner = ScaledEmbedding(10, 2)
    with pytest.raises(ValueError, match='exchange must be one of'):
        sharding.ShardedEmbedding(inner, num_shards=2, exchange='ring')
    layer = sharding.ShardedEmbedding(inner, num_shards=2)
    layer.weight = torch.nn.Parameter(layer.weight.detach()[:5].clone())
    assert layer.holds_block
    with pytest.raises(RuntimeError, match='has none'):
        layer(torch.arange(3))
    bloom = sharding.ShardedBloomEmbedding(BloomEmbedding(40, 2),
                                           num_shards=4)
    bloom.weight = torch.nn.Parameter(bloom.weight.detach()[:3].clone())
    with pytest.raises(ValueError, match='expected global 8 or per-shard 2'):
        bloom(torch.arange(3))
