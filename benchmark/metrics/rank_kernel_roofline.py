"""``rank_kernel_roofline``: the rank pass's (K1, dot or mixture scoring)
least time over its device time: the larger of its float32 operations at
67 TFLOP/s and its bytes at 3.35 TB/s, counted from each call's shapes,
over the device time of ``rank_kernel`` in the trace."""

from benchmark import peaks, trace


def read(window):
    if window.trace is None:
        return None
    measured = trace.device_seconds(window.trace, ('rank_kernel',))
    if measured <= 0:
        return None
    least = sum(peaks.bound(*peaks.rank_pass(
        c['batch'], c['num_items'], c['dim'], c['targets'],
        c['mixtures']))[0] for c in window.calls if 'targets' in c) / 1e3
    return 100.0 * least / measured
