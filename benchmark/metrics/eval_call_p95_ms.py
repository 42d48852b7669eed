"""``eval_call_p95_ms``: the 95th percentile of the latencies of all the
window's calls, each from the moment it is made until its answer is on
the host."""

import statistics


def read(window):
    if window.traffic['entry'] == 'fit' or len(window.calls) < 2:
        return None
    latencies = [(c['end'] - c['start']) * 1e3 for c in window.calls]
    return statistics.quantiles(latencies, n=20, method='inclusive')[18]
