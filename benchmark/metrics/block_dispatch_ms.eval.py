"""``block_dispatch_ms.eval``: host milliseconds a call in the port's
``spotlight.seq.block`` spans (one a self-attention block a forward pass,
``SelfAttentionNet``): the host issuing the block's products, softmax and
LayerNorms.  Where the card is busy this is the host's issue time; where
the host waits on a full launch queue, the card's.

A traced reading: the port keeps spans in the ``--trace 1`` run, under
the profiler, so the figure includes the profiler's own host cost
and reads above the same spans under ``profiling.recording()``."""

from benchmark import spans


def read(window):
    found = spans.in_window(window, ('spotlight.seq.block',))
    if not found:
        return None
    return spans.total_ms(found) / len(window.calls)
