"""``host_prep_ms.train``: host milliseconds a fit in the port's
preparation of the epoch, from its spans: ``spotlight.fit.epoch_data``
(the estimator's ``_epoch_data``: the id columns, their check, padding and
``place_data``) and ``spotlight.fit.epoch_draws`` (``epoch_draws``: the
permutation, the negatives and their one copy to the card), over the
window's ``spotlight.fit`` spans.

A traced reading: the port keeps spans in the ``--trace 1`` run, under
the profiler, so the figure includes the profiler's own host cost
and reads above the same spans under ``profiling.recording()``."""

from benchmark import spans


def read(window):
    found = spans.in_window(window, ('spotlight.fit.epoch_data',
                                     'spotlight.fit.epoch_draws'))
    fits = spans.in_window(window, ('spotlight.fit',))
    if not found or not fits:
        return None
    return spans.total_ms(found) / len(fits)
