"""``factors_ms.eval``: device milliseconds a call in activities other than
the port's hand-written kernels: the factors (user rows, the LSTM and the
mixture projection, the cached catalogue matrix) and the small work around
the kernels, from the trace."""

from benchmark import trace


def read(window):
    if window.trace is None or not window.calls:
        return None
    other = sum(window.trace.by_name.values()) - trace.device_seconds(
        window.trace, trace.PORT_KERNELS)
    return other * 1e3 / len(window.calls)
