"""``SelfAttentionNet`` (SASRec) against the plain reference
``benchmark/reference/sasrec.py`` on seeded random weights at a small size
(N=60, d=16, n=12, two blocks), with ragged left-padded rows and rows of
padding only; and the estimator's paths that run it: one dense step's loss
and gradients, the training and evaluation modes, the streaming metrics,
serialization, ``sparse=True``, the mesh refusal, the counters and the
span.  The network has no JAX counterpart, so nothing here compares with
the JAX package.

Tolerances: the port and the reference compute the same float32 sums in
different orders (fused LayerNorm and softmax against their written-out
forms, batched products against the reference's), so each reading differs
by a few float32 roundings carried through two blocks: 2e-6 absolute on
representations of order 1, 1e-5 relative on a gradient.
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import sasrec as reference  # noqa: E402
from spotlight_tpu_torch import evaluation  # noqa: E402
from spotlight_tpu_torch.data import SequenceInteractions  # noqa: E402
from spotlight_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from spotlight_tpu_torch.sequence import (  # noqa: E402
    ImplicitSequenceModel, SelfAttentionNet, representations)
from spotlight_tpu_torch.utils import profiling, serialization  # noqa: E402
from spotlight_tpu_torch.utils.training import epoch_draws  # noqa: E402

NUM_ITEMS, DIM, WINDOW, BLOCKS = 60, 16, 12, 2
#: Representations of order 1 (LayerNorm outputs), a few float32 roundings
#: apart.
REPR_ATOL = 2e-6


def network(seed=0, dropout=0.0):
    """A network whose every parameter is seeded away from its
    initialisation (gains off 1, offsets and the bias column off 0)."""
    generator = torch.Generator().manual_seed(seed)
    net = SelfAttentionNet(NUM_ITEMS, DIM, num_blocks=BLOCKS,
                           max_sequence_length=WINDOW, dropout=dropout,
                           generator=generator)
    with torch.no_grad():
        for name, p in net.named_parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=generator))
        net.item_embeddings.weight[0] = 0.0
    return net


def weights_of(net):
    return {name: p.detach().clone() for name, p in net.named_parameters()}


def histories(rows=10, length=WINDOW, seed=1):
    """Ragged left-padded histories: real lengths from ``length`` down,
    two rows of padding only."""
    rs = np.random.RandomState(seed)
    out = rs.randint(1, NUM_ITEMS, (rows, length))
    for row, real in enumerate(np.linspace(length, 0, rows).astype(int)):
        out[row, :length - real] = 0
    if rows > 2:
        out[-2] = 0
    return torch.as_tensor(out)


@pytest.mark.parametrize('length', [WINDOW, 7, 1])
def test_per_step_and_final_match_the_reference(length):
    net = network().eval()
    seqs = histories(length=length)
    with torch.no_grad():
        per_step, final = net.user_representation(seqs)
    want = reference.representations(weights_of(net), seqs, BLOCKS)
    assert per_step.shape == (seqs.shape[0], length, DIM)
    torch.testing.assert_close(per_step, want[:, :-1], rtol=0,
                               atol=REPR_ATOL)
    torch.testing.assert_close(final, want[:, -1], rtol=0, atol=REPR_ATOL)
    # The catalogue scores: the dot with the shared item factors plus the
    # bias column.
    with torch.no_grad():
        scores = net.score_catalog(final)
    torch.testing.assert_close(
        scores, reference.catalogue_scores(weights_of(net), want[:, -1]),
        rtol=0, atol=1e-5)


def test_longer_sequences_than_the_window_raise():
    with pytest.raises(ValueError, match='12 positions'):
        network().user_representation(histories(length=WINDOW + 1))


def test_a_later_item_changes_no_earlier_step():
    net = network().eval()
    seqs = histories(rows=4)
    with torch.no_grad():
        per_step, final = net.user_representation(seqs)
        for t in (3, 8, WINDOW - 1):
            changed = seqs.clone()
            changed[:, t] = (changed[:, t] % (NUM_ITEMS - 1)) + 1
            other, other_final = net.user_representation(changed)
            # per_step[:, t] has seen the items before t only.
            assert torch.equal(other[:, :t + 1], per_step[:, :t + 1])
            assert not torch.equal(torch.cat([other, other_final[:, None]],
                                             1)[:2, t + 1:],
                                   torch.cat([per_step, final[:, None]],
                                             1)[:2, t + 1:])


def test_padded_steps_change_nothing():
    net = network().eval()
    seqs = histories(rows=6)
    real = seqs != 0
    # Rows whose first five (six) items are padding: 2-5 (3-5).
    five, six = ~real[:, :5].any(1), ~real[:, :6].any(1)
    with torch.no_grad():
        per_step, final = net.user_representation(seqs)
        # Fewer padded steps in front: the same real steps at the same
        # positions (the newest takes the window's last).
        trimmed, trimmed_final = net.user_representation(seqs[five, 5:])
        torch.testing.assert_close(trimmed_final, final[five], rtol=0,
                                   atol=REPR_ATOL)
        torch.testing.assert_close(trimmed[real[five, 5:]],
                                   per_step[five, 5:][real[five, 5:]],
                                   rtol=0, atol=REPR_ATOL)
        # The padding row of the table, and the positions that only padded
        # steps take (rows 0-5: the steps of items 0-5), enter nothing.
        net.item_embeddings.weight[0] = 7.0
        net.position_embeddings[:6] = -3.0
        again, again_final = net.user_representation(seqs[six])
    assert torch.equal(again_final, final[six])
    assert torch.equal(again[real[six]], per_step[six][real[six]])


class Recorder:
    """An optimizer that keeps the gradients it is handed and steps
    nothing."""

    def __init__(self):
        self.grads = []

    def init(self, params):
        return {}

    def update(self, params, grads, state):
        self.grads.append({name: g.detach().clone()
                           for name, g in grads.items()})


def test_one_dense_step_matches_the_reference_loss_and_gradients():
    net = network(dropout=0.0)
    weights = {name: w.requires_grad_() for name, w in
               weights_of(net).items()}
    seqs = histories(rows=16)
    recorder = Recorder()
    model = ImplicitSequenceModel(
        loss='bpr', representation=net, n_iter=1, batch_size=16,
        optimizer_func=lambda: recorder, device='cpu',
        random_state=np.random.RandomState(3))
    generator = torch.Generator()
    generator.set_state(model._generator.get_state())
    perm, negatives = epoch_draws(generator, 16, (1, 16, WINDOW), NUM_ITEMS)
    model.fit(SequenceInteractions(seqs.numpy(), num_items=NUM_ITEMS))

    loss = reference.bpr_loss(weights, seqs[perm], negatives[0],
                              torch.ones(16, dtype=torch.bool), BLOCKS)
    assert model._last_epoch_loss == pytest.approx(loss.item(), rel=1e-6)
    names = list(weights)
    want = dict(zip(names, torch.autograd.grad(loss, list(weights.values()),
                                               allow_unused=True)))
    got, = recorder.grads
    assert set(got) == set(names)
    for name in names:
        if want[name] is None:
            assert not got[name].any(), name
            continue
        scale = float(want[name].abs().max())
        torch.testing.assert_close(got[name], want[name], rtol=0,
                                   atol=1e-5 * scale + 1e-9, msg=name)


def _fitted(dropout, n_iter=1, seed=0):
    model = ImplicitSequenceModel(
        loss='bpr', representation=network(seed=seed, dropout=dropout),
        n_iter=n_iter, batch_size=8, device='cpu',
        random_state=np.random.RandomState(seed))
    model.fit(SequenceInteractions(histories(rows=16).numpy(),
                                   num_items=NUM_ITEMS))
    return model


def test_dropout_is_on_in_fit_and_off_when_scoring(monkeypatch):
    seen = []
    forward = SelfAttentionNet.user_representation

    def noting(self, sequences):
        seen.append(self.training)
        return forward(self, sequences)

    monkeypatch.setattr(SelfAttentionNet, 'user_representation', noting)
    model = _fitted(dropout=0.5)
    assert seen and all(seen)
    net = model._net
    seqs = histories(rows=6)
    # In training mode two passes drop different units.
    net.train()
    with torch.no_grad():
        assert not torch.equal(net.user_representation(seqs)[1],
                               net.user_representation(seqs)[1])
    del seen[:]
    data = SequenceInteractions(seqs.numpy(), num_items=NUM_ITEMS)
    scores = model.predict(seqs[0].numpy())
    streamed = evaluation.sequence_mrr_score(model, data)
    materialized = evaluation.sequence_mrr_score(model, data,
                                                 streaming=False)
    assert seen and not any(seen) and not net.training
    # Serving is the reference's forward pass, dropout off.
    want = reference.catalogue_scores(
        weights_of(net), reference.final_representation(
            weights_of(net), seqs[:1], BLOCKS))[0]
    np.testing.assert_allclose(scores, want.numpy(), rtol=0, atol=1e-5)
    assert np.array_equal(model.predict(seqs[0].numpy()), scores)
    np.testing.assert_allclose(streamed, materialized, rtol=1e-6)


def test_streaming_metrics_equal_materialize_and_route_nothing():
    model = _fitted(dropout=0.2, n_iter=2)
    data = SequenceInteractions(histories(rows=30, seed=5).numpy(),
                                num_items=NUM_ITEMS)
    routes = evaluation.MATERIALIZE_ROUTES
    streamed = evaluation.sequence_mrr_score(model, data)
    top = evaluation.sequence_precision_recall_score(model, data, k=3)
    assert evaluation.MATERIALIZE_ROUTES == routes
    assert model._rank_factors_sequences(data.sequences[:2, :-1]) is not None
    materialized = evaluation.sequence_mrr_score(model, data,
                                                 streaming=False)
    np.testing.assert_allclose(streamed, materialized, rtol=1e-6)
    np.testing.assert_array_equal(
        top, evaluation.sequence_precision_recall_score(model, data, k=3,
                                                        streaming=False))


def test_save_and_load_round_trip(tmp_path):
    model = _fitted(dropout=0.2)
    seqs = histories(rows=6, seed=2)
    path = tmp_path / 'sasrec.pkl'
    serialization.save(model, path)
    loaded = serialization.load(path)
    assert isinstance(loaded._net, SelfAttentionNet)
    assert loaded._net.dropout == 0.2
    for row in seqs.numpy():
        assert np.array_equal(loaded.predict(row), model.predict(row))
    # Training resumes alike.
    data = SequenceInteractions(seqs.numpy(), num_items=NUM_ITEMS)
    torch.manual_seed(11)
    model.fit(data)
    torch.manual_seed(11)
    loaded.fit(data)
    for (name, a), (_, b) in zip(model._net.named_parameters(),
                                 loaded._net.named_parameters()):
        assert torch.equal(a, b), name


def test_sparse_true_falls_back_to_the_dense_engine_with_its_reason():
    def fit(sparse):
        model = ImplicitSequenceModel(
            loss='bpr', representation=network(dropout=0.0), n_iter=2,
            batch_size=8, sparse=sparse, device='cpu',
            random_state=np.random.RandomState(4))
        model.fit(SequenceInteractions(histories(rows=16).numpy(),
                                       num_items=NUM_ITEMS))
        return model

    with pytest.warns(RuntimeWarning, match='masks padding keys by item id'):
        lazy = fit(True)
    dense = fit(False)
    assert not lazy._lazy
    for (name, a), (_, b) in zip(lazy._net.named_parameters(),
                                 dense._net.named_parameters()):
        assert torch.equal(a, b), name


def test_a_mesh_raises_with_its_reason():
    model = ImplicitSequenceModel(
        representation=network(), batch_size=8, device='cpu',
        mesh=Mesh(1, 1, 0, torch.device('cpu'), groups={}))
    with pytest.raises(ValueError, match='one device'):
        model.fit(SequenceInteractions(histories(rows=8).numpy(),
                                       num_items=NUM_ITEMS))
    fitted = _fitted(dropout=0.0)
    fitted._mesh = Mesh(1, 1, 0, torch.device('cpu'), groups={})
    with pytest.raises(ValueError, match='one device'):
        fitted.predict(histories(rows=1)[0].numpy())


def test_counters_and_the_block_span():
    net = network().eval()
    seqs = histories(rows=10)
    rows, real = representations.ATTENTION_ROWS, \
        representations.ATTENTION_REAL_ROWS
    profiling.clear_spans()
    with profiling.recording(), torch.no_grad():
        net.user_representation(seqs)
    steps = seqs.shape[1] + 1
    assert representations.ATTENTION_ROWS - rows == BLOCKS * 10 * steps
    assert representations.ATTENTION_REAL_ROWS - real == \
        BLOCKS * int((seqs != 0).sum())
    assert [r.name for r in profiling.spans()] == \
        ['spotlight.seq.block'] * BLOCKS

    # In a metric call each batch's blocks lie in its factors' span.
    model = _fitted(dropout=0.0)
    data = SequenceInteractions(seqs.numpy(), num_items=NUM_ITEMS)
    profiling.clear_spans()
    with profiling.recording():
        evaluation.sequence_mrr_score(model, data, batch_size=4)
    records = profiling.spans()
    by_id = {r.id: r.name for r in records}
    blocks = [r for r in records if r.name == 'spotlight.seq.block']
    assert len(blocks) == BLOCKS * math.ceil(10 / 4)
    assert {by_id[r.parent] for r in blocks} == {'spotlight.eval.factors'}
