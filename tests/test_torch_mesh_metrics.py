"""The metrics of mesh models on 4-rank gloo meshes of CPU processes.

The ranks (``tests/torch_mesh_worker.py``) are spawned once for the module
and run ``mrr_score``, ``precision_recall_score``, ``sequence_mrr_score``
and ``sequence_precision_recall_score`` on two layouts of one world of
four: data=1 x model=4 and data=2 x model=2.  A factorization model
(dyadic tables, exact ties) and a mixture-of-tastes sequence model (M=2)
over 203 items, no multiple of 4, so the catalogue is padded; with and
without the train mask (a heavy user among the rows) and
``exclude_preceding``; in one batch and in batches of 25 users, which the
data axis of 2 does not divide for the metrics' top k (that batch is
scored whole by every data rank) and which the MRR path pads.

Each rank's results equal every other's and one device's exactly, and
the JAX package's mesh models' on the data=2 x model=2 layout: MRR within
float32 (rtol 1e-6), precision and recall exactly.  (On one device the
port's metrics are held to JAX's in ``tests/test_torch_evaluation.py`` and
``tests/test_torch_sequence.py``.)
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spotlight_tpu import evaluation as jax_eval
from spotlight_tpu.data import Interactions as JaxInteractions
from spotlight_tpu.data.interactions import (
    SequenceInteractions as JaxSequenceInteractions)
from spotlight_tpu.factorization import (
    ImplicitFactorizationModel as JaxImplicitModel)
from spotlight_tpu.parallel import sharding as jax_sharding
from spotlight_tpu.sequence import ImplicitSequenceModel as JaxSequenceModel
from spotlight_tpu.sequence.representations import (
    MixtureLSTMNet as JaxMixtureLSTMNet)

from tests import torch_mesh_worker as worker
from tests.test_torch_mesh import (DIM, K, LAYOUTS, MIXTURES, MRR_RTOL,
                                   NUM_ITEMS, SEQ_K, assert_same, jax_mesh,
                                   model_cases, one_device_metrics)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """Every rank's metrics, one dict a layout: both layouts in one
    spawn."""
    mf, seq, _, _ = model_cases()
    cases = {'layouts': LAYOUTS, 'models': {'mf': mf, 'sequence': seq}}
    return worker.run_ranks(cases, tmp_path_factory.mktemp('mesh'))


@pytest.mark.parametrize('layout', LAYOUTS)
def test_every_rank_returns_the_same_result(ranks, layout):
    """Replicated results, no call on the materialize route, and the
    models on the ranks' devices."""
    for other in ranks[1:]:
        assert_same(other[layout], ranks[0][layout])
    assert ranks[0][layout]['materialize_routes'] == 0
    assert ranks[0][layout]['device'] == 'cpu'


METRICS = [('mrr', None), ('mrr/train', None), ('pr', None),
           ('pr/train', None), ('sequence_mrr', False), ('sequence_mrr', True),
           ('sequence_pr', False), ('sequence_pr', True)]


def _key(metric, exclude, batch_size):
    if metric.startswith('sequence'):
        return metric, exclude, batch_size
    return metric, batch_size


@pytest.mark.parametrize('batch_size', [None, 25])
@pytest.mark.parametrize('metric,exclude', METRICS)
@pytest.mark.parametrize('layout', LAYOUTS)
def test_mesh_metrics_equal_one_device(ranks, layout, metric, exclude,
                                       batch_size):
    key = _key(metric, exclude, batch_size)
    assert_same(ranks[0][layout]['metrics'][key], one_device_metrics()[key])


@pytest.mark.parametrize('metric,exclude', METRICS)
def test_mesh_metrics_match_jax_mesh(ranks, metric, exclude):
    layout = (2, 2)
    got = ranks[0][layout]['metrics'][_key(metric, exclude, None)]
    want = jax_metrics(layout)[metric if not metric.startswith('sequence')
                               else (metric, exclude)]
    if metric.endswith('mrr') or metric.startswith('mrr'):
        np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)
    else:
        for got_part, want_part in zip(got, want):
            np.testing.assert_array_equal(got_part, want_part)




def _jax_interactions(case, which):
    return worker.interactions(case, which, JaxInteractions)


def _on_jax_mesh(model, tree, mesh):
    """Install ``tree`` into a JAX mesh model whose tables hold padded
    rows (the padding rows are zero)."""
    params = jax.tree_util.tree_map(np.array, model._params)
    for name in ('user_embeddings', 'item_embeddings'):
        if name in tree:
            table = tree[name]['weight']
            target = np.zeros_like(params[name]['weight'])
            target[:len(table)] = table
            tree = dict(tree, **{name: {'weight': target}})
    model._params = jax_sharding.shard_params(
        jax.tree_util.tree_map(jnp.asarray, tree), model._param_specs,
        mesh)
    return model


@functools.lru_cache(maxsize=None)
def jax_metrics(layout):
    """The JAX package's mesh models' metrics, streaming (its kernels in
    interpret mode), keyed as the worker keys the port's."""
    mf, seq, mf_tree, seq_tree = model_cases()
    mesh = jax_mesh(layout)
    model = JaxImplicitModel(loss='bpr', embedding_dim=DIM, mesh=mesh,
                             random_state=np.random.RandomState(0))
    train = _jax_interactions(mf, 'train')
    model._initialize(train)
    model = _on_jax_mesh(model, mf_tree, mesh)
    test = _jax_interactions(mf, 'test')
    out = {
        'mrr': jax_eval.mrr_score(model, test, streaming=True),
        'mrr/train': jax_eval.mrr_score(model, test, train=train,
                                        streaming=True),
        'pr': jax_eval.precision_recall_score(model, test, k=K,
                                              streaming=True),
        'pr/train': jax_eval.precision_recall_score(
            model, test, train=train, k=K, streaming=True)}
    sequences = JaxSequenceInteractions(seq['sequences'],
                                        num_items=NUM_ITEMS)
    model = JaxSequenceModel(
        loss='bpr', representation=JaxMixtureLSTMNet(
            NUM_ITEMS, DIM, num_mixtures=MIXTURES),
        embedding_dim=DIM, mesh=mesh, random_state=np.random.RandomState(2))
    model._initialize(sequences)
    model = _on_jax_mesh(model, seq_tree, mesh)
    for exclude in (False, True):
        out['sequence_mrr', exclude] = jax_eval.sequence_mrr_score(
            model, sequences, exclude_preceding=exclude, streaming=True)
        out['sequence_pr', exclude] = (
            jax_eval.sequence_precision_recall_score(
                model, sequences, k=SEQ_K, exclude_preceding=exclude,
                streaming=True))
    return out
