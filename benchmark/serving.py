"""What the ranking entries share: the calls of a traffic mix built once in
set-up, the answers of the window's calls kept, and their judgement
against the reference.

A call hands the port's metric one ``Interactions`` (or
``SequenceInteractions``) of ``rows_per_call`` users (or sequences) and
gets one answer a row back.  The calls cycle through a pool of
``pool_calls`` draws made in set-up, so that the window times the port and
not the making of its inputs; set-up warms the port with ``warm_calls``
of them.  Once the window has closed, ``check_answers`` answers drawn from
the seed, and the one with the most targets, are judged by the reference
(``reference.ranks``) in blocks of rows (``block_rows`` of the family's
set-up: as many as keep a block's scores to about 2 GB).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import data
from benchmark.reference import ranks
from benchmark.reference.precision import float32_exact

def routes():
    from spotlight_tpu_torch import evaluation

    return evaluation.MATERIALIZE_ROUTES


def setup(run, answer):
    """The family's serving set-up, then ``warm_calls`` calls."""
    state = run.family.serving(run)
    state.answers = []
    state.widest = None
    for inputs in state.inputs[:run.traffic['warm_calls']]:
        answer(state.model, inputs)
    return state


def call(run, state, index, answer):
    """Call ``index`` of the window: the pool's calls in turn.  Returns the
    call's shape and work (its rows) for the metrics."""
    which = index % len(state.pool)
    state.answers.append((which, answer(state.model, state.inputs[which])))
    shape = state.shapes[which]
    return dict(shape, work=shape['batch'])


def release(state):
    """Free the port's model before the reference runs."""
    state.model = None
    state.inputs = None


def padded(lists):
    """Ragged target lists as a (rows, widest) int64 matrix, -1 pads."""
    width = max(1, max(len(x) for x in lists))
    out = np.full((len(lists), width), -1, np.int64)
    for row, items in enumerate(lists):
        out[row, :len(items)] = items
    return out


def _width(answer):
    first = answer[0] if isinstance(answer, tuple) else answer
    return len(first)


def missing_answers(state, rows_per_call):
    """Answers due in the window and not given: per call, the rows it was
    asked for less the answers it returned."""
    return sum(max(0, rows_per_call - _width(answer))
               for _, answer in state.answers)


def sampled(run, state):
    """(row ids, calls, places) of the answers to judge: ``check_answers``
    drawn from the seed out of every answer due in the window, and the one
    with the most targets."""
    rows_per_call = run.traffic['rows_per_call']
    due = len(state.answers) * rows_per_call
    if state.widest is None:
        state.widest = [int(np.argmax([len(state.targets_of(r))
                                       for r in rows]))
                        for rows in state.pool]

    def width(c):
        which = state.answers[c][0]
        return len(state.targets_of(state.pool[which][state.widest[which]]))

    call = max(range(len(state.answers)), key=width)
    widest = call * rows_per_call + state.widest[state.answers[call][0]]
    chosen = data.check_sample(due, run.traffic['check_answers'], run.seed,
                               must=[widest])
    calls, places = np.divmod(chosen, rows_per_call)
    rows = np.array([state.pool[state.answers[c][0]][p]
                     for c, p in zip(calls, places)])
    return rows, calls, places


def given(state, rows, calls, places, pick):
    """The port's answers ``pick(answer, place, row)`` at (call, place),
    NaN where the call gave none."""
    out = np.full(len(calls), np.nan)
    for i, (row, c, p) in enumerate(zip(rows, calls, places)):
        answer = state.answers[c][1]
        if p < _width(answer):
            out[i] = pick(answer, p, row)
    return out


def judge(run, state, rows, answers, gaps_of, precision, answers_of):
    """The largest reading of ``answers`` to ``rows`` against the
    reference's float32 scores, in blocks.  With a ``precision`` other
    than 'float32', the answers judged are the control's, worked out by
    ``answers_of(scores, targets)`` from the reference's scores in that
    precision."""
    worst = 0.0
    with float32_exact():
        step = state.block_rows
        for start in range(0, len(rows), step):
            block = rows[start:start + step]
            targets = torch.as_tensor(padded(
                [state.targets_of(r) for r in block]), device=run.device)
            reference = state.score_rows(block, 'float32')
            if precision == 'float32':
                judged = torch.as_tensor(answers[start:start + step],
                                         device=run.device)
            else:
                judged = answers_of(state.score_rows(block, precision),
                                    targets)
            gap = gaps_of(reference, targets, judged)
            worst = max(worst, float(gap.max()))
            del reference, targets, judged, gap
    return worst


def verify_mrr(run, state, precision='float32'):
    """``rank_gap``: the widest reading of the sampled mean reciprocal
    ranks; ``missing_answers``; ``materialize_routes``: the window's
    calls on the materialize path."""
    rows, calls, places = sampled(run, state)
    answers = given(state, rows, calls, places,
                    lambda a, p, row: float(a[p]))
    return {'rank_gap': judge(run, state, rows, answers, ranks.mrr_gaps,
                              precision, ranks.mrr_answers),
            'missing_answers': missing_answers(
                state, run.traffic['rows_per_call']),
            'materialize_routes': run.counters['materialize_routes']}
