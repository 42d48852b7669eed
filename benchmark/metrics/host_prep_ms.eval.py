"""``host_prep_ms.eval``: host milliseconds a call in the port's
preparation of the call's rows, from its spans: ``spotlight.eval.rows``
(``evaluation._eval_rows``: the test CSR and its padded rows; for
sequences the prefixes) and ``spotlight.eval.upload`` (each batch's rows
trimmed and placed on the card, in ``_batches`` and
``_sequence_batches``).

A traced reading: the port keeps spans in the ``--trace 1`` run, under
the profiler, so the figure includes the profiler's own host cost
and reads above the same spans under ``profiling.recording()``."""

from benchmark import spans


def read(window):
    found = spans.in_window(window, ('spotlight.eval.rows',
                                     'spotlight.eval.upload'))
    if not found:
        return None
    return spans.total_ms(found) / len(window.calls)
