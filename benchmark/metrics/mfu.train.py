"""``mfu.train``: the dense steps' least time over the card's busy time
in the traced window.  A step's least time is the larger of its float32
operations at 67 TFLOP/s and its bytes at 3.35 TB/s (Adam reading and
writing every parameter and both moments once, and the batch's rows),
summed over the steps of the window's fits."""

from benchmark import peaks


def read(window):
    if (window.trace is None or window.trace.busy_s <= 0
            or window.traffic['entry'] != 'fit'):
        return None
    least_ms = sum(c['steps'] * peaks.bound(*peaks.bilinear_step(
        c['batch'], c['dim'], c['num_params']))[0]
        for c in window.calls if 'steps' in c)
    return 100.0 * least_ms / 1e3 / window.trace.busy_s
