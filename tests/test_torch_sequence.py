"""The port's sequence slice against the JAX package's.

A JAX ``ImplicitSequenceModel`` is initialised (not fitted) and its item
biases filled with seeded values; its parameters go through
``params_from_jax`` into the port, and both packages must then agree:

- ``to_sequence`` and ``SequenceInteractions``: exactly;
- the LSTM and mixture representations and ``predict``: rtol 1e-5 (the
  float32 sums run in another order);
- the mixture score (K3) and the candidate scores (K4): rtol 1e-5, the
  port's plain versions on the CPU against the JAX kernels in interpret
  mode;
- rank counts and top-k ids: exactly;
- ``sequence_mrr_score``: rtol 1e-6 (ranks are half-integer counts, equal
  in both packages); precision and recall: exactly.
"""

import ast
import functools
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu import evaluation as jax_eval
from spotlight_tpu.data.interactions import Interactions as JaxInteractions
from spotlight_tpu.data.interactions import (
    SequenceInteractions as JaxSequenceInteractions)
from spotlight_tpu.ops.kernels import ranking as jax_ranking
from spotlight_tpu.ops.kernels import topk as jax_topk
from spotlight_tpu.sequence import ImplicitSequenceModel as JaxSequenceModel
from spotlight_tpu.sequence.representations import (
    MixtureLSTMNet as JaxMixtureLSTMNet)
from spotlight_tpu_torch import evaluation
from spotlight_tpu_torch.data import Interactions, SequenceInteractions
from spotlight_tpu_torch.ops.kernels import ranking, topk
from spotlight_tpu_torch.sequence import (CNNNet, ImplicitSequenceModel,
                                          LSTMNet, MixtureLSTMNet, PoolNet)
from spotlight_tpu_torch.utils.convert import params_from_jax

NUM_ITEMS, DIM, LENGTH, NUM_SEQUENCES = 64, 8, 8, 32
RTOL, ATOL = 1e-5, 1e-6
MRR_RTOL = 1e-6
PORT_ROOT = pathlib.Path(__file__).resolve().parents[1] / 'spotlight_tpu_torch'

#: (representation, mixtures): the LSTM (dot scoring) and two mixtures.
KINDS = [('lstm', None), ('mixture', 2), ('mixture', 4)]


def _sequences(seed=0):
    rs = np.random.RandomState(seed)
    sequences = rs.randint(1, NUM_ITEMS, (NUM_SEQUENCES, LENGTH))
    sequences[:6, :3] = 0          # left padding, as to_sequence makes it
    return sequences


def _jax_model(representation, mixtures, sequences, duplicate=False):
    rep = (representation if mixtures in (None, 4)
           else JaxMixtureLSTMNet(NUM_ITEMS, DIM, num_mixtures=mixtures))
    model = JaxSequenceModel(loss='bpr', representation=rep,
                             embedding_dim=DIM,
                             random_state=np.random.RandomState(1))
    model._initialize(JaxSequenceInteractions(sequences,
                                              num_items=NUM_ITEMS))
    params = jax.tree_util.tree_map(np.array, model._params)
    weight = params['item_embeddings']['weight']
    weight[1:, DIM] = 0.1 * np.random.RandomState(2).randn(NUM_ITEMS - 1)
    if duplicate:
        weight[6] = weight[5]      # item 6 ties item 5 exactly
    model._params = jax.tree_util.tree_map(jnp.asarray, params)
    return model, params


@functools.lru_cache(maxsize=None)
def pair(representation, mixtures, duplicate=False):
    """(JAX model, port model holding its parameters, sequences)."""
    sequences = _sequences()
    jax_model, params = _jax_model(representation, mixtures, sequences,
                                   duplicate)
    rep = (representation if mixtures in (None, 4)
           else MixtureLSTMNet(NUM_ITEMS, DIM, num_mixtures=mixtures))
    port = ImplicitSequenceModel(loss='bpr', representation=rep,
                                 embedding_dim=DIM, device='cpu',
                                 random_state=np.random.RandomState(1))
    port._initialize(SequenceInteractions(sequences, num_items=NUM_ITEMS))
    port._load_params(params_from_jax(port._net, params))
    return jax_model, port, sequences


def _tests(sequences):
    return (JaxSequenceInteractions(sequences, num_items=NUM_ITEMS),
            SequenceInteractions(sequences, num_items=NUM_ITEMS))


# -- data ----------------------------------------------------------------------

def _timed_interactions(seed, num_users=12, num_items=40, num=300):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, num_users, num), rs.randint(1, num_items, num),
            rs.permutation(num))


@pytest.mark.parametrize('max_length,min_length,step', [
    (5, None, None), (5, None, 1), (4, 2, 2), (10, 3, None), (1, None, 1)])
def test_to_sequence_matches_jax(max_length, min_length, step):
    users, items, timestamps = _timed_interactions(max_length)
    got = Interactions(users, items, timestamps=timestamps).to_sequence(
        max_length, min_sequence_length=min_length, step_size=step)
    want = JaxInteractions(users, items, timestamps=timestamps).to_sequence(
        max_length, min_sequence_length=min_length, step_size=step)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.user_ids, want.user_ids)
    assert got.sequences.dtype == want.sequences.dtype
    assert (got.num_items, got.max_sequence_length, repr(got)) == (
        want.num_items, want.max_sequence_length, repr(want))


def test_to_sequence_refusals_match_jax():
    users, items, timestamps = _timed_interactions(0)
    with pytest.raises(ValueError, match='timestamps'):
        Interactions(users, items).to_sequence()
    items = items.copy()
    items[3] = 0
    with pytest.raises(ValueError, match='padding'):
        Interactions(users, items, timestamps=timestamps).to_sequence()
    with pytest.raises(ValueError, match='num_items'):
        SequenceInteractions(np.zeros((0, 4), np.int32))
    seqs = _sequences()
    assert (SequenceInteractions(seqs).num_items
            == JaxSequenceInteractions(seqs).num_items)


# -- representations -----------------------------------------------------------

@pytest.mark.parametrize('representation,mixtures', KINDS)
def test_user_representation_matches_jax(representation, mixtures):
    jax_model, port, sequences = pair(representation, mixtures)
    want_steps, want_final = jax_model._net.user_representation(
        jax_model._params, jnp.asarray(sequences))
    with torch.no_grad():
        got_steps, got_final = port._net.user_representation(
            torch.as_tensor(sequences))
    np.testing.assert_allclose(got_steps.numpy(), np.asarray(want_steps),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_final.numpy(), np.asarray(want_final),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('representation,mixtures', KINDS)
def test_step_scores_match_jax(representation, mixtures):
    jax_model, port, sequences = pair(representation, mixtures)
    net, params = jax_model._net, jax_model._params
    steps, _ = net.user_representation(params, jnp.asarray(sequences))
    want = net.score(params, steps, jnp.asarray(sequences))
    with torch.no_grad():
        got_steps, _ = port._net.user_representation(
            torch.as_tensor(sequences))
        got = port._net.score(got_steps, torch.as_tensor(sequences))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('representation,mixtures', KINDS)
def test_predict_matches_jax(representation, mixtures):
    jax_model, port, sequences = pair(representation, mixtures)
    for row in (0, 3, NUM_SEQUENCES - 1):
        np.testing.assert_allclose(port.predict(sequences[row]),
                                   jax_model.predict(sequences[row]),
                                   rtol=RTOL, atol=ATOL)
    items = np.array([1, 5, NUM_ITEMS - 1])
    np.testing.assert_allclose(port.predict(sequences[1], items),
                               jax_model.predict(sequences[1], items),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match='single sequence'):
        port.predict(sequences[:2])
    with pytest.raises(ValueError, match='Maximum item id'):
        port.predict(sequences[0], [NUM_ITEMS])


@pytest.mark.parametrize('representation,mixtures', KINDS)
def test_rank_factors_match_jax(representation, mixtures):
    """The streaming kernels' operands: (B, D) or the (B, 2M * D) stack
    of tastes then attentions, and the cached catalogue."""
    jax_model, port, sequences = pair(representation, mixtures)
    got = port._rank_factors_sequences(sequences[:5])
    want = jax_model._rank_factors_sequences(sequences[:5])
    assert got[3] == (want[3] if len(want) > 3 else None)
    # The CUDA kernels take contiguous operands only.
    assert all(part.is_contiguous() for part in got[:3])
    for got_part, want_part in zip(got[:3], want[:3]):
        np.testing.assert_allclose(got_part.numpy(), np.asarray(want_part),
                                   rtol=RTOL, atol=ATOL)
    again = port._rank_factors_sequences(sequences[5:9])
    assert again[1] is got[1] and again[2] is got[2]


# -- kernels: K3, K4, and the mixture variants of K1 and K2 --------------------

def _mixture_operands(seed, batch, mixtures, num_items=NUM_ITEMS, dim=DIM):
    rs = np.random.RandomState(seed)
    users = (rs.randn(batch, 2 * mixtures * dim) / dim ** .5).astype(
        np.float32)
    items = rs.randn(num_items, dim).astype(np.float32)
    bias = (0.1 * rs.randn(num_items)).astype(np.float32)
    items[6], bias[6] = items[5], bias[5]        # a duplicate forces a tie
    return users, items, bias


@pytest.mark.parametrize('mixtures', [2, 4])
def test_mixture_scores_match_jax(mixtures):
    """K3: the plain catalogue scores against make_mixture_score_fn."""
    users, items, bias = _mixture_operands(mixtures, 12, mixtures)
    score_fn = jax_ranking.make_mixture_score_fn(mixtures, DIM)
    want = np.asarray(score_fn(jnp.asarray(items), jnp.asarray(users).T)
                      ) + bias[:, None]
    got = ranking.plain_mixture_scores(
        torch.from_numpy(users), torch.from_numpy(items),
        torch.from_numpy(bias), mixtures)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, ranking.plain_scores(
        torch.from_numpy(users), torch.from_numpy(items),
        torch.from_numpy(bias), mixtures))


@pytest.mark.parametrize('mixtures', [2, 4])
def test_candidate_scores_match_jax(mixtures):
    """K4: the plain candidate scores against the JAX kernel in interpret
    mode, and bit-equal to the plain catalogue pass (the exact-tie
    contract)."""
    users, items, bias = _mixture_operands(10 + mixtures, 12, mixtures)
    ids = np.random.RandomState(3).randint(0, NUM_ITEMS, (12, 5))
    score_fn = jax_ranking.make_mixture_score_fn(mixtures, DIM)
    want = jax_ranking.matched_candidate_scores(
        jnp.asarray(users), jnp.asarray(items), jnp.asarray(bias),
        jnp.asarray(ids), score_fn, interpret=True)
    args = (torch.from_numpy(users), torch.from_numpy(items),
            torch.from_numpy(bias))
    got = ranking.matched_candidate_scores(*args, torch.from_numpy(ids),
                                           mixtures)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    catalogue = ranking.plain_mixture_scores(*args, mixtures).T
    assert torch.equal(got, torch.gather(catalogue, 1,
                                         torch.from_numpy(ids)))


@pytest.mark.parametrize('ids_dtype', [torch.int32, torch.int64])
@pytest.mark.parametrize('mixtures', [2, 4])
def test_candidate_scores_clamp_ids_as_jax_clips_them(mixtures, ids_dtype):
    """K4 against the JAX kernel in interpret mode on ids outside
    [0, N): the port clamps them (on the card inside the kernel) as the JAX
    callers clip them before the call, and int32 and int64 ids give the
    same bits."""
    users, items, bias = _mixture_operands(40 + mixtures, 12, mixtures)
    ids = np.random.RandomState(5).randint(-5, NUM_ITEMS + 5, (12, 6))
    ids[0, :4] = [-1, -2 ** 31, NUM_ITEMS, 2 ** 31 - 1]
    want = jax_ranking.matched_candidate_scores(
        jnp.asarray(users), jnp.asarray(items), jnp.asarray(bias),
        jnp.clip(jnp.asarray(ids), 0, NUM_ITEMS - 1),
        jax_ranking.make_mixture_score_fn(mixtures, DIM), interpret=True)
    args = (torch.from_numpy(users), torch.from_numpy(items),
            torch.from_numpy(bias))
    got = ranking.matched_candidate_scores(
        *args, torch.from_numpy(ids).to(ids_dtype), mixtures)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    other = torch.int64 if ids_dtype == torch.int32 else torch.int32
    again = ranking.matched_candidate_scores(
        *args, torch.from_numpy(ids).to(other), mixtures)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize('mixtures', [2, 4])
def test_mixture_rank_weights_match_jax(mixtures):
    """K1 with mixture scoring: counts exactly equal to the JAX kernel's,
    the duplicated target's tie included."""
    users, items, bias = _mixture_operands(20 + mixtures, 12, mixtures)
    ids = np.random.RandomState(4).randint(0, NUM_ITEMS, (12, 3))
    ids[:, 0] = 5
    score_fn = jax_ranking.make_mixture_score_fn(mixtures, DIM)
    jargs = (jnp.asarray(users), jnp.asarray(items), jnp.asarray(bias))
    jts = jax_ranking.matched_candidate_scores(*jargs, jnp.asarray(ids),
                                               score_fn, interpret=True)
    want = jax_ranking.rank_weights(*jargs, jts, tile_items=256,
                                    interpret=True, score_fn=score_fn)
    args = (torch.from_numpy(users), torch.from_numpy(items),
            torch.from_numpy(bias))
    ts = ranking.matched_candidate_scores(*args, torch.from_numpy(ids),
                                          mixtures)
    got = ranking.rank_weights(*args, ts, mixtures)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # Target 5 ties itself and its copy, item 6: a whole weight.
    assert np.all(got.numpy()[:, 0] % 1 == 0)


@pytest.mark.parametrize('k', [1, 10, NUM_ITEMS])
@pytest.mark.parametrize('mixtures', [2, 4])
def test_mixture_streaming_topk_matches_jax(k, mixtures):
    """K2 with mixture scoring: ids exactly equal to the JAX kernel's, tie
    order (item 5 before its copy, item 6) included."""
    users, items, bias = _mixture_operands(30 + mixtures, 12, mixtures)
    want_s, want_i = jax_topk.streaming_topk(
        jnp.asarray(users), jnp.asarray(items), jnp.asarray(bias), k,
        tile_items=256, interpret=True,
        score_fn=jax_ranking.make_mixture_score_fn(mixtures, DIM))
    got_s, got_i = topk.streaming_topk(
        torch.from_numpy(users), torch.from_numpy(items),
        torch.from_numpy(bias), k, mixtures)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL,
                               atol=ATOL)


def test_mixture_wrappers_reject_bad_operands():
    users, items, bias = (torch.from_numpy(a)
                          for a in _mixture_operands(0, 3, 2))
    ids = torch.zeros(3, 1, dtype=torch.int64)
    with pytest.raises(ValueError, match='wide'):
        ranking.matched_candidate_scores(users, items, bias, ids, 4)
    with pytest.raises(ValueError, match='num_mixtures'):
        topk.streaming_topk(users, items, bias, 3, ranking.MAX_MIXTURES + 1)
    with pytest.raises(ValueError, match='wide'):
        ranking.rank_weights(users[:, :DIM], items, bias,
                             torch.zeros(3, 1), 2)


# -- evaluation ----------------------------------------------------------------

@pytest.mark.parametrize('streaming', [True, False])
@pytest.mark.parametrize('exclude', [False, True])
@pytest.mark.parametrize('representation,mixtures', KINDS)
def test_sequence_mrr_matches_jax(representation, mixtures, exclude,
                                  streaming):
    jax_model, port, sequences = pair(representation, mixtures)
    jax_test, port_test = _tests(sequences)
    got = evaluation.sequence_mrr_score(port, port_test,
                                        exclude_preceding=exclude,
                                        streaming=streaming)
    want = jax_eval.sequence_mrr_score(jax_model, jax_test,
                                       exclude_preceding=exclude,
                                       streaming=streaming)
    assert got.shape == want.shape == (NUM_SEQUENCES,)
    np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)


@pytest.mark.parametrize('streaming', [True, False])
@pytest.mark.parametrize('exclude', [False, True])
@pytest.mark.parametrize('representation,mixtures', KINDS)
def test_sequence_precision_recall_matches_jax(representation, mixtures,
                                               exclude, streaming):
    jax_model, port, sequences = pair(representation, mixtures)
    jax_test, port_test = _tests(sequences)
    got = evaluation.sequence_precision_recall_score(
        port, port_test, k=3, exclude_preceding=exclude,
        streaming=streaming)
    want = jax_eval.sequence_precision_recall_score(
        jax_model, jax_test, k=3, exclude_preceding=exclude,
        streaming=streaming)
    for got_part, want_part in zip(got, want):
        assert got_part.shape == want_part.shape
        np.testing.assert_array_equal(got_part, want_part)


@pytest.mark.parametrize('exclude', [False, True])
@pytest.mark.parametrize('mixtures,routes', [(9, 1), (12, 1), (8, 0)])
def test_mixtures_past_the_kernels_route_to_materialize(mixtures, routes,
                                                        exclude):
    """More tastes than the kernels take (``MAX_MIXTURES``): with the
    default ``streaming=True`` each metric call runs on the materialize
    path, counted once in ``MATERIALIZE_ROUTES``, and equals JAX's; M = 8
    still streams."""
    jax_model, port, sequences = pair('mixture', mixtures)
    jax_test, port_test = _tests(sequences)
    before = evaluation.MATERIALIZE_ROUTES
    got = evaluation.sequence_mrr_score(port, port_test,
                                        exclude_preceding=exclude)
    assert evaluation.MATERIALIZE_ROUTES - before == routes
    want = jax_eval.sequence_mrr_score(jax_model, jax_test,
                                       exclude_preceding=exclude)
    np.testing.assert_allclose(got, want, rtol=MRR_RTOL, atol=0)
    before = evaluation.MATERIALIZE_ROUTES
    got = evaluation.sequence_precision_recall_score(
        port, port_test, k=3, exclude_preceding=exclude)
    assert evaluation.MATERIALIZE_ROUTES - before == routes
    want = jax_eval.sequence_precision_recall_score(
        jax_model, jax_test, k=3, exclude_preceding=exclude)
    for got_part, want_part in zip(got, want):
        np.testing.assert_array_equal(got_part, want_part)


@pytest.mark.parametrize('batch_size', [5, 13])
def test_sequence_metrics_in_ragged_batches(batch_size):
    _, port, sequences = pair('mixture', 4)
    _, test = _tests(sequences)
    for exclude in (False, True):
        np.testing.assert_allclose(
            evaluation.sequence_mrr_score(port, test, batch_size=batch_size,
                                          exclude_preceding=exclude),
            evaluation.sequence_mrr_score(port, test,
                                          exclude_preceding=exclude),
            rtol=MRR_RTOL, atol=0)
        for got, want in zip(
                evaluation.sequence_precision_recall_score(
                    port, test, k=2, batch_size=batch_size,
                    exclude_preceding=exclude),
                evaluation.sequence_precision_recall_score(
                    port, test, k=2, exclude_preceding=exclude)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('representation,mixtures', KINDS)
def test_duplicated_row_ties_exactly(representation, mixtures):
    """Item 6 copies item 5, the target of every sequence: the streaming
    ranks see an exact two-way tie, so every rank is k + 0.5, as in the
    JAX package."""
    jax_model, port, sequences = pair(representation, mixtures,
                                      duplicate=True)
    doctored = sequences.copy()
    doctored[:, -1] = 5
    jax_test, port_test = _tests(doctored)
    got = evaluation.sequence_mrr_score(port, port_test)
    # 2 * rank is an odd integer: every rank is k + 0.5.
    twice = 2.0 / got.astype(np.float64)
    np.testing.assert_allclose(twice, np.round(twice), rtol=1e-6)
    assert np.all(np.round(twice) % 2 == 1)
    np.testing.assert_allclose(
        got, jax_eval.sequence_mrr_score(jax_model, jax_test,
                                         streaming=True),
        rtol=MRR_RTOL, atol=0)
    np.testing.assert_allclose(
        got, evaluation.sequence_mrr_score(port, port_test, streaming=False),
        rtol=MRR_RTOL, atol=0)


def test_lstm_streams_through_the_dot_kernels(monkeypatch):
    """An LSTM (dot-product) model takes the 'sequences' kind through the
    dot kernels (K1c, K1, K2), never the mixture ones."""
    _, port, sequences = pair('lstm', None)
    _, test = _tests(sequences)

    def refuse(*args):
        raise AssertionError('a dot model reached a mixture kernel')

    monkeypatch.setattr(evaluation, 'matched_candidate_scores', refuse)
    calls = []
    original = evaluation.rank_weights

    def spy(*args):
        calls.append(args[4])
        return original(*args)

    monkeypatch.setattr(evaluation, 'rank_weights', spy)
    evaluation.sequence_mrr_score(port, test, exclude_preceding=True)
    evaluation.sequence_precision_recall_score(port, test, k=3)
    assert calls == [None]
    assert port._rank_factors_sequences(sequences[:2])[3] is None


def test_dedup_rows_match_jax():
    """Each prefix's distinct items (``_excluded_rows``), padded on the
    device, equal the JAX package's ``_dedup_rows``."""
    rs = np.random.RandomState(5)
    rows = rs.randint(0, 6, (7, 9))

    def padded(prefixes):
        got, = evaluation._rows_on(
            [evaluation._excluded_rows(prefixes, True)], torch.device('cpu'))
        return got.numpy()

    got = padded(rows)
    want = jax_eval._dedup_rows(rows)
    # The JAX package pads to a power-of-two width; the values agree.
    assert got.shape[1] <= want.shape[1]
    np.testing.assert_array_equal(got, want[:, :got.shape[1]])
    assert np.all(want[:, got.shape[1]:] == -1)
    assert padded(rows[:0]).shape == (0, 1)


def test_empty_sequence_test_set_matches_jax():
    jax_model, port, _ = pair('mixture', 4)
    empty = np.zeros((0, LENGTH), np.int32)
    jax_test, port_test = _tests(empty)
    for streaming in (True, False):
        got = evaluation.sequence_mrr_score(port, port_test,
                                            streaming=streaming)
        want = jax_eval.sequence_mrr_score(jax_model, jax_test,
                                           streaming=streaming)
        assert got.shape == want.shape
        for got_part, want_part in zip(
                evaluation.sequence_precision_recall_score(
                    port, port_test, k=2, streaming=streaming),
                jax_eval.sequence_precision_recall_score(
                    jax_model, jax_test, k=2, streaming=streaming)):
            assert got_part.shape == want_part.shape


# -- the model -----------------------------------------------------------------

def test_fit_is_not_faked():
    """``fit`` trains (it raised before sequence training was ported): it
    returns the model, counts its steps and moves every parameter."""
    sequences = _sequences()
    model = ImplicitSequenceModel(loss='bpr', representation='lstm',
                                  embedding_dim=DIM, n_iter=2, batch_size=16,
                                  random_state=np.random.RandomState(1),
                                  device='cpu')
    model._initialize(SequenceInteractions(sequences, num_items=NUM_ITEMS))
    before = {name: value.clone()
              for name, value in model._net.state_dict().items()}
    assert model.fit(SequenceInteractions(sequences,
                                          num_items=NUM_ITEMS)) is model
    assert model._opt_state['count'] == 2 * NUM_SEQUENCES // 16
    assert np.isfinite(model._last_epoch_loss)
    for name, value in model._net.state_dict().items():
        assert not torch.equal(value, before[name]), name


@pytest.mark.parametrize('kwargs,error', [
    ({'loss': 'nope'}, ValueError),
    ({'negative_sampling': 'nope'}, ValueError),
    ({'exchange': 'nope'}, ValueError),
    ({'representation': 'nope'}, ValueError),
    ({'representation': 'pooling'}, None),
    ({'representation': 'cnn'}, None),
    ({'representation': 'lstm',
      'mesh': SimpleNamespace(shape={'data': 3, 'model': 1}, device='cpu')},
     ValueError),
])
def test_constructor_refusals(kwargs, error):
    """Bad settings raise (a batch size of 256 on a data axis of 3 among
    them, as in the JAX package); 'pooling' and 'cnn' (refused until their
    slice was ported) construct and build their network at the first
    ``fit``, and so does the default, 'pooling'."""
    if error is not None:
        with pytest.raises(error):
            ImplicitSequenceModel(device='cpu', **kwargs)
        return
    kinds = {'pooling': PoolNet, 'cnn': CNNNet}
    models = [ImplicitSequenceModel(device='cpu', **kwargs)]
    if kwargs['representation'] == 'pooling':
        models.append(ImplicitSequenceModel(device='cpu'))
    for model in models:
        model._n_iter = 1
        assert model.fit(SequenceInteractions(_sequences(),
                                              num_items=NUM_ITEMS)) is model
        assert type(model._net) is kinds[kwargs['representation']]


def test_uninitialised_model_refuses_to_predict():
    model = ImplicitSequenceModel(representation='mixture', device='cpu')
    assert 'uninitialised' in repr(model)
    with pytest.raises(RuntimeError, match='fit'):
        model.predict(np.array([1, 2]))
    with pytest.raises(RuntimeError, match='_initialize'):
        model._load_params({})


def test_params_from_jax_rejects_a_mixture_of_another_width():
    _, params = _jax_model('mixture', 2, _sequences())
    net = MixtureLSTMNet(NUM_ITEMS, DIM, num_mixtures=4)
    with pytest.raises(ValueError, match='projection'):
        params_from_jax(net, params)
    with pytest.raises(ValueError, match='expects'):
        params_from_jax(LSTMNet(NUM_ITEMS, DIM), params)


def test_same_random_state_same_parameters():
    nets = [ImplicitSequenceModel(representation='mixture', embedding_dim=4,
                                  random_state=np.random.RandomState(9),
                                  device='cpu') for _ in range(2)]
    for model in nets:
        model._initialize(SequenceInteractions(_sequences(),
                                               num_items=NUM_ITEMS))
    for (name, a), (_, b) in zip(nets[0]._net.state_dict().items(),
                                 nets[1]._net.state_dict().items()):
        assert torch.equal(a, b), name
    # The padding row reads as zeros.
    assert not nets[0]._net.item_embeddings(torch.tensor([0])).any()


# -- isolation -----------------------------------------------------------------

SEQUENCE_MODULES = ['spotlight_tpu_torch.sequence',
                    'spotlight_tpu_torch.sequence.implicit',
                    'spotlight_tpu_torch.sequence.lazy',
                    'spotlight_tpu_torch.sequence.representations',
                    'spotlight_tpu_torch.utils.serialization',
                    'spotlight_tpu_torch.data.interactions',
                    'spotlight_tpu_torch.evaluation']


def test_sequence_slice_imports_neither_jax_nor_the_jax_package():
    """Imported in a fresh interpreter in which ``jax`` and
    ``spotlight_tpu`` cannot be imported, the sequence slice runs."""
    code = '\n'.join([
        'import sys',
        'class Refuse:',
        '    def find_spec(self, name, path=None, target=None):',
        '        if name.split(".")[0] in ("jax", "jaxlib", "spotlight_tpu"):',
        '            raise ImportError("blocked: " + name)',
        'sys.meta_path.insert(0, Refuse())',
        'import importlib, numpy as np',
        'for name in {!r}:'.format(SEQUENCE_MODULES),
        '    importlib.import_module(name)',
        'from spotlight_tpu_torch.sequence import ImplicitSequenceModel',
        'from spotlight_tpu_torch.data import SequenceInteractions',
        'from spotlight_tpu_torch.evaluation import sequence_mrr_score',
        'seqs = np.random.RandomState(0).randint(1, 30, (4, 5))',
        'm = ImplicitSequenceModel(representation="mixture", '
        'embedding_dim=4, device="cpu")',
        'm._initialize(SequenceInteractions(seqs, num_items=30))',
        'print(sequence_mrr_score(m, SequenceInteractions(seqs, '
        'num_items=30)).shape)',
        'print(sorted(n for n in sys.modules if n.split(".")[0] in '
        '("jax", "spotlight_tpu")))',
    ])
    result = subprocess.run([sys.executable, '-c', code],
                            cwd=PORT_ROOT.parent, capture_output=True,
                            text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stdout.split('\n')[:2] == ['(4,)', '[]']


def test_sequence_sources_name_no_jax():
    for path in sorted((PORT_ROOT / 'sequence').glob('*.py')):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([alias.name for alias in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ''] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split('.')[0] not in ('jax', 'spotlight_tpu'), (
                    path, name)
