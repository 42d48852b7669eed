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
  a mixture sequence model, whose four metrics run on the mesh.
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
              timeout=300):
    """Run the cases on ``world`` ranks and return each rank's results.

    Raises if a rank fails or if the ranks have not all ended within
    ``timeout`` seconds (the ranks still alive are killed first): room for
    four ranks to start beside a busy test run on two cores, while a
    collective that waits gives up after COLLECTIVE_TIMEOUT."""
    workdir = str(workdir)
    cases_path = os.path.join(workdir, 'cases.pkl')
    with open(cases_path, 'wb') as fh:
        pickle.dump(cases, fh)
    store = os.path.join(workdir, 'store')
    devices = devices or ['cpu'] * world
    context = mp.get_context('spawn')
    procs = [context.Process(target=rank_main, args=(
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
