"""Ranks of a ``torch.distributed`` mesh for the port's mesh tests.

Not collected by pytest.  :func:`run_ranks` starts one process a rank (the
``spawn`` start method, so this module is what each child imports: it
imports neither JAX nor ``spotlight_tpu``).  The ranks join one process
group through a ``file://`` store, build each mesh layout the cases name
from that one world, run every case on every layout, and each rank saves
what it got, so that the caller can hold every rank's results to one
device's and to the JAX package's.

The cases are a dict of numpy arrays (see ``tests/test_torch_mesh.py``):

- ``functions``: operands of the four sharded functions (dot and mixture
  scoring), called directly, streaming and not;
- ``models``: parameters and interactions of a factorization model and of
  a mixture sequence model, whose four metrics run on the mesh;
- ``tables``: tables, ids and cotangents of the sharded embedding layers
  and of the raw exchanges (``tests/test_torch_sharded_tables.py``);
- ``training``: states, batches and datasets of mesh steps, fits and
  gates (``tests/test_torch_mesh_training.py``);
- ``lazy``: datasets, a step's state and draws, and the settings of the
  row-sparse (lazy) engines' fits on the mesh
  (``tests/test_torch_mesh_lazy.py``);
- ``replicated``: datasets and settings of models fitted on one device
  and then on the mesh, their whole tables replicated
  (``tests/test_torch_mesh_training.py``);
- ``checkpoint``: a dataset, settings and checkpoint paths of the sharded
  checkpoints saved and restored across layouts
  (``tests/test_torch_checkpoint.py``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: Seconds a collective may wait before the process group gives up.
COLLECTIVE_TIMEOUT = 120


def run_ranks(cases, workdir, world=4, backend='gloo', devices=None,
              timeout=300, target=None):
    """Run the cases on ``world`` ranks and return each rank's results.

    Raises if a rank fails or if the ranks have not all ended within
    ``timeout`` seconds (the ranks still alive are killed first): room for
    four ranks to start beside a busy test run on two cores, while a
    collective that waits gives up after COLLECTIVE_TIMEOUT.  ``target``
    is each rank's main, :func:`rank_main` by default, called with the
    same arguments."""
    workdir = str(workdir)
    cases_path = os.path.join(workdir, 'cases.pkl')
    with open(cases_path, 'wb') as fh:
        pickle.dump(cases, fh)
    store = os.path.join(workdir, 'store')
    devices = devices or ['cpu'] * world
    context = mp.get_context('spawn')
    procs = [context.Process(target=target or rank_main, args=(
        rank, world, backend, store, devices, cases_path, workdir))
        for rank in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    alive = [rank for rank, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    errors = []
    for rank, proc in enumerate(procs):
        path = os.path.join(workdir, 'rank{}.err'.format(rank))
        if os.path.exists(path):
            with open(path) as fh:
                errors.append('rank {}:\n{}'.format(rank, fh.read()))
    if alive or errors or any(proc.exitcode for proc in procs):
        raise RuntimeError('mesh ranks failed (still running after {} s: '
                           '{}; exit codes {}):\n{}'.format(
                               timeout, alive,
                               [proc.exitcode for proc in procs],
                               '\n'.join(errors)))
    results = []
    for rank in range(world):
        with open(os.path.join(workdir, 'rank{}.pkl'.format(rank)),
                  'rb') as fh:
            results.append(pickle.load(fh))
    return results


def rank_main(rank, world, backend, store, devices, cases_path, workdir):
    """One rank: join the group, run the cases on each layout, save."""
    try:
        torch.set_num_threads(1)
        if torch.device(devices[rank]).type == 'cuda':
            torch.cuda.set_device(torch.device(devices[rank]))
        dist.init_process_group(
            backend, init_method='file://' + store, world_size=world,
            rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        with open(cases_path, 'rb') as fh:
            cases = pickle.load(fh)
        from spotlight_tpu_torch.parallel import make_mesh

        results = {}
        for data, model in cases['layouts']:
            mesh = make_mesh(data=data, model=model, devices=devices)
            results[(data, model)] = run_cases(mesh, cases)
        dist.destroy_process_group()
        with open(os.path.join(workdir, 'rank{}.pkl'.format(rank)),
                  'wb') as fh:
            pickle.dump(results, fh)
    except BaseException:
        with open(os.path.join(workdir, 'rank{}.err'.format(rank)),
                  'w') as fh:
            fh.write(traceback.format_exc())
        raise


def run_cases(mesh, cases):
    out = {}
    if 'functions' in cases:
        out.update(run_functions(mesh, cases['functions']))
    if 'models' in cases:
        out.update(run_metrics(mesh, cases['models']))
    if 'tables' in cases:
        out.update(run_tables(mesh, cases['tables']))
    if 'training' in cases:
        out.update(run_training(mesh, cases['training']))
    if 'lazy' in cases:
        out.update(run_lazy(mesh, cases['lazy']))
    if 'replicated' in cases:
        out.update(run_replicated(mesh, cases['replicated']))
    if 'checkpoint' in cases:
        out.update(run_checkpoint(mesh, cases['checkpoint']))
    return out


def _numpy(value):
    if isinstance(value, tuple):
        return tuple(_numpy(v) for v in value)
    return value.cpu().numpy()


def run_functions(mesh, case):
    """The four sharded functions on the case's operands: top-k and rank
    counts streaming and not, rank weights and candidate scores, each with
    dot and mixture scoring; top-k and candidate scores also on a batch
    one user short (no data split)."""
    from spotlight_tpu_torch.parallel import evaluation as pe

    def on(name):
        return torch.as_tensor(case[name], device=mesh.device)

    items, bias = on('items'), on('bias')
    scorings = (('dot', on('users'), None),
                ('mixture', on('mix_users'), case['mixtures']))
    out = {}
    for name, users, mixture in scorings:
        target_scores = on('target_scores_' + name)
        for streaming in (True, False):
            out['topk', name, streaming] = _numpy(pe.sharded_topk(
                mesh, users, items, bias, case['k'], mixture=mixture,
                streaming=streaming))
            out['counts', name, streaming] = _numpy(pe.sharded_rank_counts(
                mesh, users, items, bias, target_scores, on('target_ids'),
                mixture=mixture, streaming=streaming))
        out['weights', name] = _numpy(pe.sharded_rank_weights(
            mesh, users, items, bias, target_scores, mixture=mixture))
        out['scores', name] = _numpy(pe.sharded_candidate_scores(
            mesh, users, items, bias, on('candidates'), mixture=mixture))
        out['topk', name, 'short'] = _numpy(pe.sharded_topk(
            mesh, users[:-1], items, bias, case['k'], mixture=mixture))
        out['scores', name, 'short'] = _numpy(pe.sharded_candidate_scores(
            mesh, users[:-1], items, bias, on('candidates')[:-1],
            mixture=mixture))
    return out


def factorization_model(case, mesh=None, device='cpu'):
    """The case's implicit factorization model, its parameters loaded."""
    from spotlight_tpu_torch.data import Interactions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel

    model = ImplicitFactorizationModel(
        loss='bpr', embedding_dim=case['dim'], mesh=mesh,
        random_state=np.random.RandomState(0),
        device=None if mesh is not None else device)
    model._initialize(interactions(case, 'train', Interactions))
    model._load_params({name: torch.as_tensor(value)
                        for name, value in case['state'].items()})
    return model


def sequence_model(case, mesh=None, device='cpu'):
    """The case's mixture-of-tastes sequence model, its parameters
    loaded."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel
    from spotlight_tpu_torch.sequence.representations import MixtureLSTMNet

    model = ImplicitSequenceModel(
        loss='bpr', embedding_dim=case['dim'], mesh=mesh,
        representation=MixtureLSTMNet(case['num_items'], case['dim'],
                                      num_mixtures=case['mixtures']),
        random_state=np.random.RandomState(0),
        device=None if mesh is not None else device)
    model._initialize(SequenceInteractions(case['sequences'],
                                           num_items=case['num_items']))
    model._load_params({name: torch.as_tensor(value)
                        for name, value in case['state'].items()})
    return model


def interactions(case, which, cls):
    users, items = case[which]
    return cls(users, items, num_users=case['num_users'],
               num_items=case['num_items'])


def metrics(mf, mf_case, seq, seq_case):
    """Every metric call the mesh tests hold: name -> numpy result.  The
    batch sizes split the users into several batches, one of them odd."""
    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.data import Interactions, SequenceInteractions

    test = interactions(mf_case, 'test', Interactions)
    train = interactions(mf_case, 'train', Interactions)
    sequences = SequenceInteractions(seq_case['sequences'],
                                     num_items=seq_case['num_items'])
    k = mf_case['k']
    out = {}
    for batch_size in (None, 25):
        out['mrr', batch_size] = evaluation.mrr_score(
            mf, test, batch_size=batch_size)
        out['mrr/train', batch_size] = evaluation.mrr_score(
            mf, test, train=train, batch_size=batch_size)
        out['pr', batch_size] = evaluation.precision_recall_score(
            mf, test, k=k, batch_size=batch_size)
        out['pr/train', batch_size] = evaluation.precision_recall_score(
            mf, test, train=train, k=k, batch_size=batch_size)
        for exclude in (False, True):
            out['sequence_mrr', exclude, batch_size] = (
                evaluation.sequence_mrr_score(
                    seq, sequences, exclude_preceding=exclude,
                    batch_size=batch_size))
            out['sequence_pr', exclude, batch_size] = (
                evaluation.sequence_precision_recall_score(
                    seq, sequences, k=seq_case['k'],
                    exclude_preceding=exclude, batch_size=batch_size))
    return out


def run_metrics(mesh, cases):
    from spotlight_tpu_torch import evaluation

    evaluation.MATERIALIZE_ROUTES = 0
    mf = factorization_model(cases['mf'], mesh)
    seq = sequence_model(cases['sequence'], mesh)
    out = {'metrics': metrics(mf, cases['mf'], seq, cases['sequence'])}
    out['materialize_routes'] = evaluation.MATERIALIZE_ROUTES
    out['device'] = str(mf._device)
    return out


def assert_same(got, want):
    """Equal trees of arrays: float arrays bit for bit."""
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for key in got:
            assert_same(got[key], want[key])
    elif isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_same(a, b)
    elif isinstance(got, np.ndarray):
        assert got.shape == want.shape and got.dtype == want.dtype
        if got.dtype.kind == 'f':
            assert np.array_equal(got.view(np.int32 if got.itemsize == 4
                                           else np.int64),
                                  want.view(np.int32 if want.itemsize == 4
                                            else np.int64))
        else:
            np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# -- sharded tables -------------------------------------------------------------

EXCHANGES = ('psum', 'alltoall', 'alltoall_cf')
#: The bloom table case's compressed rows: int(0.5 x its ids).
BLOOM_RATIO = 0.5


def dense_layer(kind, weight, num_ids):
    """The dense layer of a table case, its weight the case's."""
    from spotlight_tpu_torch.ops import embeddings

    dim = weight.shape[1]
    layer = {'scaled': lambda: embeddings.ScaledEmbedding(
                 num_ids, dim, padding_idx=0),
             'zero': lambda: embeddings.ZeroEmbedding(num_ids, dim),
             'fused': lambda: embeddings.FusedBiasEmbedding(
                 num_ids, dim - 1, padding_idx=0),
             'bloom': lambda: embeddings.BloomEmbedding(
                 num_ids, dim, compression_ratio=BLOOM_RATIO,
                 num_hash_functions=3)}[kind]()
    layer.weight.data = torch.as_tensor(weight)
    return layer


def model_slice(mesh, n):
    """This rank's contiguous slice of ``n`` rows over the model axis."""
    rows = n // mesh.shape['model']
    return slice(mesh.model_index * rows, (mesh.model_index + 1) * rows)


def run_tables(mesh, case):
    """Each layer kind x exchange: the rank's lookup of the case's ids
    (its model slice of them for 'alltoall_cf') and the gradient of
    ``sum(rows * cotangent)`` on its block (the loss divided by the model
    size for 'alltoall', as the step divides it); then the raw exchanges
    and the psum's backward."""
    from spotlight_tpu_torch.parallel import sharding

    shards = mesh.shape['model']
    out = {}
    ids = torch.as_tensor(case['ids'])
    for kind in ('scaled', 'zero', 'fused', 'bloom'):
        inner = dense_layer(kind, case[kind], case['num_ids'])
        cls = (sharding.ShardedBloomEmbedding if kind == 'bloom'
               else sharding.ShardedEmbedding)
        for exchange in EXCHANGES:
            layer = cls(inner, 'model', shards, exchange, mesh)
            layer.weight = torch.nn.Parameter(sharding.shard_params(
                {'weight': layer.weight.detach()}, layer.spec(),
                mesh)['weight'].clone())
            assert layer.holds_block or shards == 1
            rows = (model_slice(mesh, len(ids)) if exchange == 'alltoall_cf'
                    else slice(None))
            vectors = layer(ids[rows])
            loss = (vectors * torch.as_tensor(
                case['cot_' + kind])[rows]).sum()
            if exchange == 'alltoall':
                loss = loss / shards
            (grad,) = torch.autograd.grad(loss, [layer.weight])
            out['table', kind, exchange] = _numpy((vectors.detach(), grad))
    out.update(run_exchanges(mesh, case))
    out['loaded'] = run_loads(mesh, case)
    return out


def run_loads(mesh, case):
    """A mesh model's blocks after loading a JAX tree of whole tables
    through ``params_from_jax`` and ``_load_params`` (each takes the
    rank's block, the second of a block already taken)."""
    from spotlight_tpu_torch.data import Interactions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.utils.convert import params_from_jax

    tree = case['load_tree']
    model = ImplicitFactorizationModel(embedding_dim=4, mesh=mesh)
    model._initialize(Interactions(
        np.arange(4), np.arange(4),
        num_users=len(tree['user_embeddings']['weight']),
        num_items=len(tree['item_embeddings']['weight'])))
    model._load_params(params_from_jax(model._net, tree))
    return {name: value.detach().numpy().copy()
            for name, value in model._net.state_dict().items()}


def run_exchanges(mesh, case):
    """``alltoall_lookup`` on replicated ids, ``alltoall_capacity_lookup``
    on the rank's model slice at the default and a reduced capacity:
    rows, the block's gradient of ``sum(rows * cotangent)`` (JAX's
    convention: no division) and the overflow count."""
    from spotlight_tpu_torch.parallel import sharding

    weight = torch.as_tensor(case['raw_weight'])
    rows = weight.shape[0] // mesh.shape['model']
    block = weight[mesh.model_index * rows:(mesh.model_index + 1) * rows]
    out = {}
    for name, ids, cot, call in (
            ('alltoall', case['raw_ids'], case['raw_cot'],
             lambda w, i: (sharding.alltoall_lookup(mesh, w, i), None)),
            ('cf', case['raw_ids'], case['raw_cot'],
             lambda w, i: sharding.alltoall_capacity_lookup(mesh, w, i)),
            ('cf capacity 2', case['skewed_ids'], case['skewed_cot'],
             lambda w, i: sharding.alltoall_capacity_lookup(
                 mesh, w, i, capacity=2))):
        local = block.clone().requires_grad_(True)
        ids, cot = torch.as_tensor(ids), torch.as_tensor(cot)
        if name != 'alltoall':
            part = model_slice(mesh, len(ids))
            ids, cot = ids[part], cot[part]
        vectors, overflow = call(local, ids)
        (grad,) = torch.autograd.grad((vectors * cot).sum(), [local])
        out['exchange', name] = _numpy((vectors.detach(), grad)) + (
            None if overflow is None else int(overflow),)
    x = torch.as_tensor(case['raw_cot']).requires_grad_(True)
    summed = sharding._SumOverAxis.apply(x, mesh, 'model')
    (grad,) = torch.autograd.grad((summed * 3).sum(), [x])
    out['psum backward'] = _numpy((summed.detach(), grad))
    return out


# -- mesh training ------------------------------------------------------------------

MOMENT_SCALE, PARAM_ATOL, LOSS_RTOL = 1e-6, 1e-6, 1e-6


def held(array, layout, rank):
    """The block of a whole (or padded) table that ``rank`` holds."""
    shards = layout[1]
    rows = -(-array.shape[0] // shards)
    padded = np.concatenate([array, np.zeros(
        (rows * shards - array.shape[0],) + array.shape[1:], array.dtype)])
    index = rank % shards
    return padded[index * rows:(index + 1) * rows]


def assert_step_close(got, want, layout, rank, param_atol=PARAM_ATOL):
    """A rank's (loss, parameter blocks, moment blocks) against a whole
    (loss, parameters, moments): parameters within ``param_atol``, moments
    within MOMENT_SCALE of each table's largest, the loss within
    LOSS_RTOL (``tests/test_torch_training.py``'s tolerances)."""
    loss, params, moments = got
    np.testing.assert_allclose(loss, want[0], rtol=LOSS_RTOL)
    for name, value in want[1].items():
        np.testing.assert_allclose(params[name],
                                   held(value, layout, rank), rtol=0,
                                   atol=param_atol, err_msg=name)
        for key in ('mu', 'nu'):
            moment = want[2][key][name]
            np.testing.assert_allclose(
                moments[key][name], held(moment, layout, rank), rtol=0,
                atol=MOMENT_SCALE * np.abs(moment).max(),
                err_msg='{} {}'.format(key, name))



def implicit_model(case, mesh, exchange='psum', negative_sampling='uniform',
                   device='cpu', sparse=False):
    """The step case's implicit model on ``mesh`` (or on ``device``), its
    parameters the case's; ``sparse`` selects the lazy engine."""
    from spotlight_tpu_torch.data import Interactions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel

    model = ImplicitFactorizationModel(
        loss=case['loss'], embedding_dim=case['dim'],
        batch_size=case['batch'], learning_rate=case['lr'], l2=case['l2'],
        mesh=mesh, exchange=exchange, negative_sampling=negative_sampling,
        sparse=sparse, random_state=np.random.RandomState(0),
        device=None if mesh is not None else device)
    model._initialize(Interactions(
        *case['pairs'], num_users=case['num_users'],
        num_items=case['num_items']))
    model._load_params({name: torch.as_tensor(value)
                        for name, value in case['state'].items()})
    return model


def step_batch(case, device, in_batch=False):
    """(batch, negatives) of the step case, as ``run_epoch`` hands them to
    a step: columns in the case's (already permuted) order, the mask, and
    ``(n_neg, B)`` negatives (none in-batch, which reads the weight
    column)."""
    users, items = case['pairs']
    batch = {'user_ids': torch.as_tensor(users),
             'item_ids': torch.as_tensor(items),
             'mask': torch.ones(len(users))}
    negatives = torch.as_tensor(case['negatives'])[None]
    if in_batch:
        batch['negative_weight'] = torch.as_tensor(case['negative_weight'])
        negatives = None
    batch = {name: value.to(device) for name, value in batch.items()}
    return batch, None if negatives is None else negatives.to(device)


def one_step(model, case, mesh, exchange, in_batch=False):
    """``case['steps']`` steps (one by default) of ``model`` on the case's
    batch, from the case's state, on the rank's slice: (last loss,
    parameters, Adam moments), blocks on a mesh."""
    from spotlight_tpu_torch.parallel import training as ptraining

    batch, negatives = step_batch(case, model._device, in_batch)
    if mesh is not None:
        rows = ptraining.batch_rows(mesh, case['batch'], exchange)
        batch = {name: value[rows] for name, value in batch.items()}
        negatives = None if negatives is None else negatives[:, rows]
    step = model._step_fn()
    for _ in range(case.get('steps', 1)):
        loss = step(batch, negatives)
    state = model._opt_state
    return (float(loss),
            {name: p.detach().cpu().numpy()
             for name, p in model._net.named_parameters()},
            {key: {name: m.cpu().numpy() for name, m in state[key].items()}
             for key in ('mu', 'nu')})


def run_training(mesh, case):
    """The steps, the fits and gates, the saved model and the collective
    bytes a step that ``tests/test_torch_mesh_training.py`` holds."""
    from spotlight_tpu_torch.parallel import mesh as pmesh

    layout = (mesh.shape['data'], mesh.shape['model'])
    out = {}
    step = case['step']
    for exchange in EXCHANGES:
        model = implicit_model(step, mesh, exchange)
        pmesh.COLLECTIVE_BYTES = {}
        out['step', exchange] = one_step(model, step, mesh, exchange)
        out['bytes', exchange] = dict(pmesh.COLLECTIVE_BYTES)
    if layout == (2, 2) and 'gates' in case:
        model = implicit_model(step, mesh, 'psum', 'in_batch')
        out['step', 'in_batch'] = one_step(model, step, mesh, 'psum',
                                           in_batch=True)
        out.update(run_gates(mesh, case['gates']))
    return out


def run_loaded_on_mesh(mesh, path, train, test):
    """The saved mesh model loaded (whole padded tables) and given the mesh
    again: its metrics over the padded catalogue's blocks, then one epoch
    of ``fit`` there, replicated (its loss, whole tables and moments)."""
    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.utils import serialization

    model = serialization.load(path)
    model._mesh = mesh
    out = {'loaded on the mesh': (
        model._net._holds_blocks(),
        evaluation.mrr_score(model, test).mean(),
        evaluation.precision_recall_score(model, test, k=5)[0].mean(),
        catalog_block(model))}
    model._n_iter = 1
    model.fit(train)
    out['loaded on the mesh', 'fit'] = (
        model._last_epoch_loss, model._net._holds_blocks(),
        state_arrays(model))
    return out


def run_replicated_item_layer(mesh, implicit, train, test, workdir):
    """One epoch of a classic ``BilinearNet`` whose item layer is a plain
    ``torch.nn.Embedding``, which ``sharded`` leaves replicated while the
    user and bias tables shard; saved like the gate model.  Returns
    (whether the item table is a block, whether the user table is, MRR,
    P@5, the rank's block of the catalogue the metrics scored)."""
    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.factorization.representations import (
        BilinearNet)
    from spotlight_tpu_torch.utils import serialization

    dim = implicit['config']['embedding_dim']
    items = torch.nn.Embedding.from_pretrained(torch.as_tensor(
        np.random.RandomState(3).normal(
            0, 0.1, (implicit['num_items'], dim)).astype(np.float32)),
        freeze=False)
    net = BilinearNet(implicit['num_users'], implicit['num_items'], dim,
                      item_embedding_layer=items,
                      generator=torch.Generator().manual_seed(3))
    config = dict(implicit['config'], n_iter=1)
    model = ImplicitFactorizationModel(
        representation=net, mesh=mesh,
        random_state=np.random.RandomState(42), **config)
    model.fit(train)
    serialization.save(model, os.path.join(
        workdir, 'replicated_item_layer.rank{}.pkl'.format(mesh.rank)))
    return (model._net._holds_blocks(),
            model._net.user_embeddings.holds_block,
            evaluation.mrr_score(model, test).mean(),
            evaluation.precision_recall_score(model, test, k=5)[0].mean(),
            catalog_block(model))


def catalog_block(model):
    """(rows, first id) of the rank's block of the catalogue that the
    model's last metric scored."""
    rows, _, _, first = model._shard_catalog_cache[2]
    return rows, first


def run_gates(mesh, gates):
    """The JAX package's mesh gates on this layout: each model's metric,
    plus the explicit models' item tables (this rank's block)."""
    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.data import Interactions, SequenceInteractions
    from spotlight_tpu_torch.factorization import (
        ExplicitFactorizationModel, ImplicitFactorizationModel)
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel
    from spotlight_tpu_torch.utils import serialization

    out = {}
    explicit = gates['explicit']
    train, test = (Interactions(*explicit[which],
                                num_users=explicit['num_users'],
                                num_items=explicit['num_items'])
                   for which in ('train', 'test'))
    for exchange in ('psum', 'alltoall'):
        model = ExplicitFactorizationModel(mesh=mesh, exchange=exchange,
                                           random_state=np.random.RandomState(
                                               42), **explicit['config'])
        model.fit(train)
        out['explicit', exchange] = (
            evaluation.rmse_score(model, test),
            model._net.item_embeddings.weight.detach().numpy().copy())
    implicit = gates['implicit']
    train, test = (Interactions(*implicit[which],
                                num_users=implicit['num_users'],
                                num_items=implicit['num_items'])
                   for which in ('train', 'test'))
    for exchange in ('psum', 'alltoall'):
        model = ImplicitFactorizationModel(mesh=mesh, exchange=exchange,
                                           random_state=np.random.RandomState(
                                               42), **implicit['config'])
        model.fit(train)
        out['implicit', exchange] = evaluation.mrr_score(
            model, test, train=train).mean()
        if exchange == 'psum':
            path = os.path.join(gates['workdir'],
                                'mesh_model.rank{}.pkl'.format(mesh.rank))
            serialization.save(model, path)
            out['saved metrics'] = (
                evaluation.mrr_score(model, test).mean(),
                evaluation.precision_recall_score(model, test, k=5)[0].mean(),
                model.predict(3), model.predict(np.arange(5), np.arange(5)))
            out.update(run_loaded_on_mesh(mesh, path, train, test))
    out['replicated item layer'] = run_replicated_item_layer(
        mesh, implicit, train, test, gates['workdir'])
    sequence = gates['sequence']
    train, test = (SequenceInteractions(sequence[which],
                                        num_items=sequence['num_items'])
                   for which in ('train', 'test'))
    model = ImplicitSequenceModel(mesh=mesh, random_state=np.random.RandomState(
        42), **sequence['config'])
    model.fit(train)
    out['sequence'] = evaluation.sequence_mrr_score(model, test).mean()
    families = gates['families']
    data = SequenceInteractions(families['sequences'],
                                num_items=families['num_items'])
    for representation in ('pooling', 'cnn', 'mixture'):
        model = ImplicitSequenceModel(
            representation=representation, mesh=mesh,
            random_state=np.random.RandomState(1), **families['config'])
        model.fit(data)
        out['family', representation] = (
            model._last_epoch_loss,
            model.predict(families['sequences'][0]))
    return out


# -- the lazy engines on a mesh ---------------------------------------------------


def lazy_state(model):
    """(last epoch loss, parameters, moments, step count, whether the lazy
    engine trained) of a fitted model, blocks on a mesh, a bfloat16 table
    as its int16 bits; the sequence engine's moments are those of its item
    table, under its name."""
    state = model._opt_state
    moments = state.get('table', state)
    if 'table' in state:
        moments = {key: {'item_embeddings.weight': moments[key]}
                   for key in ('mu', 'nu')}
    def array(tensor):
        # A bfloat16 table as its bits.
        tensor = tensor.detach().cpu()
        if tensor.dtype == torch.bfloat16:
            tensor = tensor.view(torch.int16)
        return tensor.numpy().copy()

    return (model._last_epoch_loss,
            {name: array(p) for name, p in model._net.named_parameters()},
            {key: {name: m.cpu().numpy().copy()
                   for name, m in moments[key].items()}
             for key in ('mu', 'nu')},
            state['t'], model._lazy)


def lazy_factorization(case, kind, mesh=None, exchange='psum', **kwargs):
    """The case's lazy implicit (``kind`` 'implicit') or explicit model, on
    ``mesh`` or on the CPU."""
    from spotlight_tpu_torch.factorization import (
        ExplicitFactorizationModel, ImplicitFactorizationModel)

    cls = (ImplicitFactorizationModel if kind == 'implicit'
           else ExplicitFactorizationModel)
    config = dict(case['fit'], **kwargs)
    if kind == 'explicit':
        config['loss'] = 'regression'
    return cls(sparse=True, mesh=mesh, exchange=exchange,
               random_state=np.random.RandomState(42),
               device=None if mesh is not None else 'cpu', **config)


def lazy_bf16_in_batch(case, mesh=None):
    """The case's lazy implicit model with bfloat16 tables and in-batch
    negatives, under 'psum'."""
    from spotlight_tpu_torch.factorization.representations import (
        BilinearNet)

    net = BilinearNet(case['num_users'], case['num_items'],
                      case['fit']['embedding_dim'],
                      table_dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0))
    return lazy_factorization(case, 'implicit', mesh,
                              negative_sampling='in_batch',
                              representation=net)


def lazy_sequence(case, mesh=None, exchange='psum'):
    """The case's lazy LSTM, on ``mesh`` or on the CPU."""
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    return ImplicitSequenceModel(
        sparse=True, mesh=mesh, exchange=exchange,
        random_state=np.random.RandomState(0),
        device=None if mesh is not None else 'cpu', **case['sequence_fit'])


def lazy_data(case, kind):
    """The case's implicit or explicit interactions, or its sequences."""
    from spotlight_tpu_torch.data import Interactions, SequenceInteractions

    if kind == 'sequence':
        return SequenceInteractions(case['sequences'],
                                    num_items=case['sequence_items'])
    return Interactions(*case[kind], num_users=case['num_users'],
                        num_items=case['num_items'])


def lazy_metrics(model, case, kind):
    """The streaming metrics of a lazy model, and the same with
    ``streaming=False``: MRR with train and P@5 of a factorization model,
    ``sequence_mrr_score`` of a sequence model."""
    from spotlight_tpu_torch import evaluation

    data = lazy_data(case, kind)
    out = {}
    for streaming in (True, False):
        if kind == 'sequence':
            out['sequence_mrr', streaming] = evaluation.sequence_mrr_score(
                model, data, streaming=streaming)
        else:
            out['mrr', streaming] = evaluation.mrr_score(
                model, data, train=data, streaming=streaming)
            out['pr', streaming] = evaluation.precision_recall_score(
                model, data, k=5, streaming=streaming)
    return out


def run_lazy(mesh, case):
    """The lazy engines on this layout: the implicit and explicit fits and
    one step of the step case under each exchange (with the collective
    bytes of the step), the LSTM fits under 'psum' and 'alltoall'; at
    1 x 4 an in-batch fit of bfloat16 tables, at 2 x 2 an in-batch step, the fallback of
    'alltoall_cf' with in-batch negatives, the streaming metrics and the
    saved models."""
    import warnings

    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.parallel import mesh as pmesh
    from spotlight_tpu_torch.utils import serialization

    layout = (mesh.shape['data'], mesh.shape['model'])
    out = {}
    models = {}
    for exchange in EXCHANGES:
        for kind in ('implicit', 'explicit'):
            model = lazy_factorization(case, kind, mesh, exchange)
            model.fit(lazy_data(case, kind))
            out[kind, exchange] = lazy_state(model)
            models[kind, exchange] = model
        step = case['step']
        model = implicit_model(step, mesh, exchange, sparse=True)
        pmesh.COLLECTIVE_BYTES = {}
        out['step', exchange] = one_step(model, step, mesh, exchange)
        out['bytes', exchange] = dict(pmesh.COLLECTIVE_BYTES)
    for exchange in ('psum', 'alltoall'):
        model = lazy_sequence(case, mesh, exchange)
        model.fit(lazy_data(case, 'sequence'))
        out['sequence', exchange] = lazy_state(model)
        models['sequence', exchange] = model
    if layout == (1, 4):
        model = lazy_bf16_in_batch(case, mesh)
        model.fit(lazy_data(case, 'implicit'))
        out['implicit', 'in_batch'] = lazy_state(model)
    if layout == (2, 2):
        step = case['step']
        model = implicit_model(step, mesh, 'psum', 'in_batch', sparse=True)
        out['step', 'in_batch'] = one_step(model, step, mesh, 'psum',
                                           in_batch=True)
        model = lazy_factorization(case, 'implicit', mesh, 'alltoall_cf',
                                   negative_sampling='in_batch', n_iter=1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            model.fit(lazy_data(case, 'implicit'))
        out['cf in-batch'] = (model._lazy, np.isfinite(
            model._last_epoch_loss), [
            str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)])
        evaluation.MATERIALIZE_ROUTES = 0
        out['metrics'] = {
            kind: lazy_metrics(models[kind, 'psum'], case, kind)
            for kind in ('implicit', 'sequence')}
        out['materialize_routes'] = evaluation.MATERIALIZE_ROUTES
        for kind in ('implicit', 'sequence'):
            serialization.save(models[kind, 'psum'], os.path.join(
                case['workdir'], 'lazy_{}.rank{}.pkl'.format(kind,
                                                             mesh.rank)))
    return out


# -- replicated training of whole tables ------------------------------------------


def run_replicated(mesh, case):
    """The repair of a model that holds whole tables given a mesh: the
    case's implicit MF (dense, then lazy) and dense LSTM fitted one epoch
    on one device, given the mesh and fitted one epoch more there, every
    rank's whole tables and step count."""
    from spotlight_tpu_torch.data import Interactions, SequenceInteractions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    data = Interactions(*case['pairs'], num_users=case['num_users'],
                        num_items=case['num_items'])
    sequences = SequenceInteractions(case['sequences'],
                                     num_items=case['sequence_items'])
    out = {}
    for name, build, fit_data in (
            ('MF', lambda sparse: ImplicitFactorizationModel(
                sparse=sparse, random_state=np.random.RandomState(42),
                device=str(mesh.device), **case['mf']), data),
            ('LSTM', lambda sparse: ImplicitSequenceModel(
                sparse=sparse, random_state=np.random.RandomState(42),
                device=str(mesh.device), **case['lstm']), sequences)):
        for sparse in (False, True):
            model = build(sparse).fit(fit_data)
            model._mesh = mesh
            model.fit(fit_data)
            out['replicated', name, sparse] = (
                model._lazy, model._last_epoch_loss,
                state_arrays(model))
    return out


def state_arrays(model):
    """The model's parameters and flat optimizer state as numpy (blocks on
    a mesh; a bfloat16 table as its int16 bits), host numbers as they
    are."""
    def array(tensor):
        tensor = tensor.detach().cpu()
        if tensor.dtype == torch.bfloat16:
            tensor = tensor.view(torch.int16)
        return tensor.numpy().copy()

    def flat(tree, prefix, out):
        if isinstance(tree, dict):
            for key, value in tree.items():
                flat(value, prefix + (key,), out)
        else:
            out['/'.join(prefix)] = (array(tree) if torch.is_tensor(tree)
                                     else tree)
        return out

    return flat({'params': dict(model._net.named_parameters()),
                 'opt_state': model._opt_state}, (), {})


# -- sharded checkpoints ------------------------------------------------------------


def checkpoint_model(case, mesh, kind='mf', seed=7, sparse=False):
    """The checkpoint case's implicit MF (``kind`` 'mf') or LSTM, on
    ``mesh`` (None: one device on the CPU), initialized on its data."""
    from spotlight_tpu_torch.data import Interactions, SequenceInteractions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    device = None if mesh is not None else 'cpu'
    if kind == 'mf':
        model = ImplicitFactorizationModel(
            sparse=sparse, mesh=mesh, random_state=np.random.RandomState(
                seed), device=device, **case['mf'])
        data = Interactions(*case['pairs'], num_users=case['num_users'],
                            num_items=case['num_items'])
    else:
        model = ImplicitSequenceModel(
            sparse=sparse, mesh=mesh, random_state=np.random.RandomState(
                seed), device=device, **case['lstm'])
        data = SequenceInteractions(case['sequences'],
                                    num_items=case['sequence_items'])
    model._initialize(data)
    return model, data


def run_checkpoint(mesh, case):
    """Save and restore across layouts, on the case's 2 x 2 mesh and a
    1 x 4 mesh of the same ranks: the one-device dense MF checkpoint
    restored at 1 x 4 (150 users padded to 152) and saved there, that one
    restored at 2 x 2 (150) and saved there, each save's collective bytes
    (and ``serialization.save``'s, which gathers, for contrast); JAX's
    state restored at 1 x 4; the lazy MF and the lazy LSTM fitted at 2 x 2,
    saved, fitted on (the continuation), and restored onto fresh models of
    other seeds at 2 x 2 and 1 x 4 and fitted as far."""
    from spotlight_tpu_torch.parallel import checkpoint, make_mesh
    from spotlight_tpu_torch.parallel import mesh as pmesh
    from spotlight_tpu_torch.utils import serialization

    workdir = case['workdir']
    wide = make_mesh(1, 4, devices=[str(mesh.device)] * mesh.size(
        ('data', 'model')))
    out = {}

    def saved(model, name):
        pmesh.COLLECTIVE_BYTES = {}
        checkpoint.save_state(os.path.join(workdir, name), model)
        out['save bytes', name] = dict(pmesh.COLLECTIVE_BYTES)

    model, _ = checkpoint_model(case, wide)
    checkpoint.restore_state(case['one_device'], model)
    out['dense 1x4'] = state_arrays(model)
    saved(model, 'dense_1x4')
    model, _ = checkpoint_model(case, mesh)
    checkpoint.restore_state(os.path.join(workdir, 'dense_1x4'), model)
    out['dense 2x2'] = state_arrays(model)
    saved(model, 'dense_2x2')
    pmesh.COLLECTIVE_BYTES = {}
    serialization.save(model, os.path.join(
        workdir, 'gathered.rank{}.pkl'.format(mesh.rank)))
    out['pickle bytes'] = dict(pmesh.COLLECTIVE_BYTES)

    # Bytes on disk: a state of 2,000 x 1,000 rows of D=32, whose
    # per-tensor overhead in the files is small beside it.
    from spotlight_tpu_torch.data import Interactions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel

    model = ImplicitFactorizationModel(embedding_dim=32, mesh=mesh)
    model._initialize(Interactions(np.arange(4), np.arange(4),
                                   num_users=2_000, num_items=1_000))
    saved(model, 'bytes_2x2')

    model, _ = checkpoint_model(case, wide)
    checkpoint.restore_state(case['jax'], model)
    out['jax 1x4'] = state_arrays(model)

    for kind in ('mf', 'lstm'):
        model, data = checkpoint_model(case, mesh, kind, seed=42,
                                       sparse=True)
        model.fit(data)
        saved(model, 'lazy_{}_2x2'.format(kind))
        out['saved t', kind] = model._opt_state['t']
        model.fit(data)
        out['continued', kind] = state_arrays(model)
        for name, layout in (('2x2', mesh), ('1x4', wide)):
            model, data = checkpoint_model(case, layout, kind, sparse=True)
            checkpoint.restore_state(os.path.join(
                workdir, 'lazy_{}_2x2'.format(kind)), model)
            model.fit(data)
            out['resumed', kind, name] = state_arrays(model)
    return out


# -- multi-process helpers ----------------------------------------------------------


def multihost_training(mesh, case):
    """``tests/test_multihost.py``'s training run on the mesh: the MF (2
    epochs of batch 64, 37 users x 53 items, D=16), the LSTM and the lazy
    MF; each one's last loss and state (blocks)."""
    from spotlight_tpu_torch.data import Interactions, SequenceInteractions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    interactions = Interactions(*case['pairs'], num_users=37, num_items=53)
    sequences = SequenceInteractions(case['sequences'], num_items=53)
    config = dict(loss='bpr', embedding_dim=16, n_iter=2, batch_size=64,
                  mesh=mesh, random_state=np.random.RandomState(42))
    out = {}
    for name, model, data in (
            ('MF', ImplicitFactorizationModel(**config), interactions),
            ('LSTM', ImplicitSequenceModel(representation='lstm', **config),
             sequences),
            ('lazy MF', ImplicitFactorizationModel(sparse=True, **config),
             interactions)):
        model.fit(data)
        out[name] = (model._lazy, model._last_epoch_loss,
                     state_arrays(model))
    return out


def multihost_rank_main(rank, world, backend, store, devices, cases_path,
                        workdir):
    """One rank started through ``parallel.multihost.initialize`` (over
    TCP at the cases' ``address``): ``is_primary``, ``global_batch_array``
    of its data slice at 2 x 2, and :func:`multihost_training`; then the
    same training once more in a group joined through the file store, as
    :func:`rank_main` joins it."""
    try:
        torch.set_num_threads(1)
        with open(cases_path, 'rb') as fh:
            cases = pickle.load(fh)
        case = cases['multihost']
        from spotlight_tpu_torch.parallel import make_mesh, multihost

        out = {'primary before': multihost.is_primary()}
        multihost.initialize(case['address'], world, rank, backend=backend)
        out['primary'] = multihost.is_primary()
        mesh = make_mesh(2, 2, devices=devices)
        rows = len(case['batch']) // mesh.shape['data']
        local = case['batch'][mesh.data_index * rows:
                              (mesh.data_index + 1) * rows]
        out['global batch'] = multihost.global_batch_array(
            mesh, local).cpu().numpy()
        out['tcp'] = multihost_training(mesh, case)
        dist.destroy_process_group()
        dist.init_process_group(
            backend, init_method='file://' + store, world_size=world,
            rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        out['file'] = multihost_training(make_mesh(2, 2, devices=devices),
                                         case)
        dist.destroy_process_group()
        with open(os.path.join(workdir, 'rank{}.pkl'.format(rank)),
                  'wb') as fh:
            pickle.dump(out, fh)
    except BaseException:
        with open(os.path.join(workdir, 'rank{}.err'.format(rank)),
                  'w') as fh:
            fh.write(traceback.format_exc())
        raise
