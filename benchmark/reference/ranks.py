"""How far the port's ranking answers lie from the reference's scores.

A user's (or sequence's) answer is judged against the reference's float32
scores of the whole catalogue.  Two computations of the same scores differ
by rounding, so an item whose score lies within that rounding of a target's
may rank on either side of it.  The reading of an answer is the smallest
``delta`` for which some perturbation of the reference scores by at most
``delta`` gives that answer, over the user's standard deviation of scores:

with ``delta``, target ``i`` ranks between ``1 + #{s_j > s_i + delta}``
and ``#{s_j >= s_i - delta}`` (itself counted), so the user's mean
reciprocal rank lies between the means of the reciprocals of those two ends
(average-tie ranks, as ``scipy.stats.rankdata`` gives, lie between them
too).

An answer that no ``delta`` up to :data:`FAR` explains reads :data:`NONE`.
"""

from __future__ import annotations

import torch

#: The largest ``delta`` searched, in standard deviations of the user's
#: scores; past it an answer reads NONE.
FAR = 64.0
#: The reading of an answer that no ``delta`` up to FAR explains (finite,
#: so that it prints as a JSON number).
NONE = 1e30
#: Bisection steps between 1e-12 and FAR standard deviations (geometric).
STEPS = 60
#: float32 rounding of the port's own mean of reciprocal ranks: at most one
#: rounding a reciprocal, a sum and the division, per target.
UNIT = 2.0 ** -24


def _counts(sorted_scores, values, right):
    return sorted_scores.shape[1] - torch.searchsorted(
        sorted_scores, values.contiguous(), right=right)


def _mrr_within(sorted_scores, target_scores, valid, answers, delta):
    d = delta[:, None]
    best = 1.0 + _counts(sorted_scores, target_scores + d, True)
    worst = _counts(sorted_scores, target_scores - d, False).clamp(min=1)
    count = valid.sum(1).clamp(min=1)
    high = torch.where(valid, 1.0 / best.double(), 0.0).sum(1) / count
    low = torch.where(valid, 1.0 / worst.double(), 0.0).sum(1) / count
    slack = 2.0 * (count + 2) * UNIT
    return (answers >= low * (1 - slack)) & (answers <= high * (1 + slack))


def _smallest_delta(within, scale):
    """Per row, the smallest delta / scale for which ``within(delta)``
    holds: 0 where it holds at 0, else a geometric bisection, NONE past
    FAR."""
    zero = torch.zeros_like(scale)
    out = torch.full_like(scale, NONE)
    ok0 = within(zero)
    out[ok0] = 0.0
    far = within(scale * FAR)
    todo = ~ok0 & far
    lo = torch.full_like(scale, -12.0)
    hi = torch.full_like(scale, float(torch.log10(torch.tensor(FAR))))
    for _ in range(STEPS):
        mid = 0.5 * (lo + hi)
        ok = within(scale * 10.0 ** mid)
        hi = torch.where(ok, mid, hi)
        lo = torch.where(ok, lo, mid)
    out[todo] = (10.0 ** hi)[todo]
    return out


def _prepare(scores, targets):
    """(ascending scores, target scores, valid targets, scale)."""
    valid = targets >= 0
    safe = targets.clamp(min=0)
    target_scores = torch.gather(scores, 1, safe)
    sorted_scores = torch.sort(scores, dim=1).values
    scale = scores.double().std(dim=1).float().clamp(min=1e-30)
    return sorted_scores.contiguous(), target_scores, valid, scale


def mrr_gaps(scores, targets, answers):
    """Per row, the reading of the port's mean reciprocal rank ``answers``
    (B,) of the targets (B, T; -1 pads) against reference ``scores``
    (B, N)."""
    sorted_scores, target_scores, valid, scale = _prepare(scores, targets)
    answers = answers.double()
    return _smallest_delta(
        lambda delta: _mrr_within(sorted_scores, target_scores, valid,
                                  answers, delta), scale)


def mrr_answers(scores, targets):
    """Mean reciprocal average-tie ranks of the targets under ``scores``
    (B, N): the answers of a control computed as the reference."""
    valid = targets >= 0
    target_scores = torch.gather(scores, 1, targets.clamp(min=0))
    sorted_scores = torch.sort(scores, dim=1).values
    above = _counts(sorted_scores, target_scores, True)
    at_or_above = _counts(sorted_scores, target_scores, False)
    ranks = 1.0 + above + 0.5 * (at_or_above - above - 1)
    count = valid.sum(1).clamp(min=1)
    return torch.where(valid, 1.0 / ranks.double(), 0.0).sum(1) / count
