"""``mfu.eval``: the calls' scoring operations (2 B N D for dots, the
mixture's for mixtures) at the float32 peak of 67 TFLOP/s over the card's
busy time in the traced window: the whole call's share of the chip's
peak while the card works."""

from benchmark import peaks


def read(window):
    if (window.trace is None or window.trace.busy_s <= 0
            or window.traffic['entry'] == 'fit'):
        return None
    ops = sum(peaks.scoring_ops(c['batch'], c['num_items'], c['dim'],
                                c['mixtures'])
              for c in window.calls if 'batch' in c)
    return 100.0 * ops / peaks.FP32_OPS_PER_S / window.trace.busy_s
