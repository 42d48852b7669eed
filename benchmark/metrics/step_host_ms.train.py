"""``step_host_ms.train``: host milliseconds a step, from the port's
``spotlight.fit.step`` spans (``utils.training.run_epoch``: a step from its
first dispatch to its return, autograd and Adam issued on the host).
Where the host paces the card this is its dispatch time; where the card
paces, with the launch queue full, the card's step time.

A traced reading: the port keeps spans in the ``--trace 1`` run, under
the profiler, so the figure includes the profiler's own host cost
and reads above the same spans under ``profiling.recording()``."""

from benchmark import spans


def read(window):
    found = spans.in_window(window, ('spotlight.fit.step',))
    if not found:
        return None
    return spans.total_ms(found) / len(found)
