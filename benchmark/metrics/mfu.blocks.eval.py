"""``mfu.blocks.eval``: the calls' float32 operations of the
self-attention blocks, counted at the real steps only with causal pairs
(``benchmark.blocks``), and of their catalogue scoring (2 B N D), at the
float32 peak of 67 TFLOP/s over the card's busy time in the traced
window."""

from benchmark import blocks, peaks


def read(window):
    if window.trace is None or window.trace.busy_s <= 0:
        return None
    ops = sum(blocks.call_ops(c['real_steps'], c['dim'], c['blocks'],
                              c['num_items'])
              for c in window.calls if 'real_steps' in c)
    if not ops:
        return None
    return 100.0 * ops / peaks.FP32_OPS_PER_S / window.trace.busy_s
