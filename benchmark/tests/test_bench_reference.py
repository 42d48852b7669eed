"""The plain reference against brute force at a tiny size."""

import numpy as np
import pytest
import scipy.stats
import torch

from benchmark.reference import mf, ranks, sequence
from benchmark.reference.precision import to_tf32


def _scores(rows=6, items=200, seed=0):
    g = torch.Generator().manual_seed(seed)
    scores = torch.randn(rows, items, generator=g)
    scores[:, 7] = scores[:, 3]            # an exact tie
    targets = torch.randint(0, items, (rows, 5), generator=g)
    targets[:, 0] = 3
    targets[0, 3:] = -1
    return scores, targets


def test_mrr_answers_are_scipy_average_ranks():
    scores, targets = _scores()
    got = ranks.mrr_answers(scores, targets).numpy()
    for row in range(scores.shape[0]):
        rank = scipy.stats.rankdata(-scores[row].numpy())
        t = targets[row][targets[row] >= 0].numpy()
        assert got[row] == pytest.approx(np.mean(1.0 / rank[t]))


def test_exact_answers_read_nought_and_wrong_ones_do_not():
    scores, targets = _scores()
    mrr = ranks.mrr_answers(scores, targets)
    assert float(ranks.mrr_gaps(scores, targets, mrr).max()) == 0.0
    assert float(ranks.mrr_gaps(scores, targets, mrr * 1.5).min()) > 0.0


def test_a_nan_answer_reads_none():
    scores, targets = _scores()
    answers = torch.full((scores.shape[0],), float('nan'),
                         dtype=torch.float64)
    assert float(ranks.mrr_gaps(scores, targets, answers).min()) == \
        pytest.approx(ranks.NONE)


def test_gap_is_the_rounding_that_explains_a_swap():
    scores = torch.tensor([[0.0, 1.0, 1.0 + 1e-3, -1.0]])
    targets = torch.tensor([[1]])
    # Rank 2 is exact; rank 1 needs item 2 moved below item 1 (1e-3).
    assert float(ranks.mrr_gaps(scores, targets,
                                torch.tensor([0.5], dtype=torch.float64))) \
        == 0.0
    gap = float(ranks.mrr_gaps(scores, targets,
                               torch.tensor([1.0], dtype=torch.float64)))
    assert gap * float(scores.double().std()) == pytest.approx(1e-3,
                                                               rel=1e-3)


def test_catalogue_scores_are_the_bilinear_scores():
    g = torch.Generator().manual_seed(1)
    users, items = torch.randn(4, 9, generator=g), torch.randn(30, 9,
                                                               generator=g)
    got = mf.catalogue_scores(users, items)
    for u in range(4):
        for i in range(30):
            want = float(users[u, :8] @ items[i, :8] + users[u, 8]
                         + items[i, 8])
            assert float(got[u, i]) == pytest.approx(want, abs=1e-5)


def test_tf32_rounds_the_mantissa_to_ten_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, 3.0])
    assert to_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]


def test_bpr_steps_follow_adam_by_hand():
    g = torch.Generator().manual_seed(2)
    user, item = torch.randn(5, 4, generator=g), torch.randn(6, 4,
                                                             generator=g)
    batch = (torch.tensor([0, 1, 1]), torch.tensor([2, 3, 4]),
             torch.tensor([5, 0, 1]), torch.ones(3))
    losses, first, tables = mf.bpr_steps(user, item, [batch], 0.1)
    u, i = user.clone().requires_grad_(), item.clone().requires_grad_()
    pos = (u[batch[0], :3] * i[batch[1], :3]).sum(1) + u[batch[0], 3] \
        + i[batch[1], 3]
    neg = (u[batch[0], :3] * i[batch[2], :3]).sum(1) + u[batch[0], 3] \
        + i[batch[2], 3]
    loss = (1 - torch.sigmoid(pos - neg)).mean()
    gu, gi = torch.autograd.grad(loss, (u, i))
    assert losses[0] == pytest.approx(float(loss.detach()))
    assert torch.allclose(first[0], gu) and torch.allclose(first[1], gi)
    for p, grad, got in ((user, gu, tables[0]), (item, gi, tables[1])):
        mu, nu = 0.1 * grad, 0.001 * grad * grad
        want = p - 0.1 * (mu / 0.1) / (torch.sqrt(nu / 0.001) + 1e-8)
        assert torch.allclose(got, want, atol=1e-6)
    # BPR's difference of scores cancels the user bias exactly.
    assert float(first[0][:, 3].abs().max()) == 0.0


def test_mixture_scores_follow_the_paper():
    g = torch.Generator().manual_seed(3)
    d, m, n = 4, 2, 7
    weights = {'item_embeddings.weight': torch.randn(n, d + 1, generator=g),
               'lstm.w_ih': torch.randn(d, 4 * d, generator=g),
               'lstm.w_hh': torch.randn(d, 4 * d, generator=g),
               'lstm.b_ih': torch.randn(4 * d, generator=g),
               'lstm.b_hh': torch.randn(4 * d, generator=g),
               'projection.weight': torch.randn(d, 2 * m * d, generator=g),
               'projection.bias': torch.randn(2 * m * d, generator=g)}
    seqs = torch.tensor([[1, 2, 3], [0, 4, 5]])
    final = sequence.final_representation(weights, seqs)
    scores = sequence.catalogue_scores(weights, final)
    table = weights['item_embeddings.weight']
    for b in range(2):
        h = c = torch.zeros(d)
        steps = [torch.zeros(d)] + [table[i, :d] * (i != 0)
                                    for i in seqs[b].tolist()]
        for x in steps:
            z = (x @ weights['lstm.w_ih'] + weights['lstm.b_ih']
                 + h @ weights['lstm.w_hh'] + weights['lstm.b_hh'])
            i_, f, g_, o = z[:d], z[d:2 * d], z[2 * d:3 * d], z[3 * d:]
            c = torch.sigmoid(f) * c + torch.sigmoid(i_) * torch.tanh(g_)
            h = torch.sigmoid(o) * torch.tanh(c)
        proj = (h @ weights['projection.weight']
                + weights['projection.bias']).reshape(2 * m, d)
        for item in range(n):
            v = table[item, :d]
            w = torch.softmax(proj[m:] @ v, 0)
            want = float((w * (proj[:m] @ v)).sum() + table[item, d])
            assert float(scores[b, item]) == pytest.approx(want, rel=1e-4,
                                                           abs=1e-5)
