"""``attention_rows.eval``: the query rows that the attention blocks
computed in the window over those of them at real (non-padding) steps,
from the port's counters ``ATTENTION_ROWS`` and ``ATTENTION_REAL_ROWS``
(``sequence.representations``): the window's padded steps per real one,
plus one; 1 where only real rows are computed."""


def read(window):
    rows = window.counters.get('attention_rows')
    real = window.counters.get('attention_real_rows')
    if not rows or not real:
        return None
    return rows / real
