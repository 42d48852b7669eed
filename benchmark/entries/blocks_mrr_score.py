"""``evaluation.sequence_mrr_score(model, test)`` over causal
self-attention blocks: the calls, answers and judgement of
``sequence_mrr_score``, and besides the route the attention's counters
(``sequence.representations.ATTENTION_ROWS``, the query rows computed,
and ``ATTENTION_REAL_ROWS``, those at real steps)."""

from __future__ import annotations

from benchmark import serving
from benchmark.entries.sequence_mrr_score import (
    answer, call, control, release, setup, verify)

__all__ = ['answer', 'call', 'control', 'counters', 'release', 'setup',
           'verify']


def counters(run, state):
    from spotlight_tpu_torch.sequence import representations

    return {'materialize_routes': serving.routes(),
            'attention_rows': representations.ATTENTION_ROWS,
            'attention_real_rows': representations.ATTENTION_REAL_ROWS}
