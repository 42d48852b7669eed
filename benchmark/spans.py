"""The port's spans (``spotlight_tpu_torch.utils.profiling.span``) that
lie inside a window: started at or after its first call's start and ended
at or before its last call's end, both on ``time.perf_counter``, the clock
the harness times its calls with.  The port keeps spans while a profiler
records, so a traced window has them; a port without spans gives none."""


def in_window(window, names):
    """The window's span records whose name is one of ``names``."""
    if not window.calls:
        return []
    from spotlight_tpu_torch.utils import profiling

    spans = getattr(profiling, 'spans', None)
    if spans is None:
        return []
    start, end = window.calls[0]['start'], window.calls[-1]['end']
    return [r for r in spans()
            if r.name in names and start <= r.start and r.end <= end]


def total_ms(records):
    """The records' durations summed, in milliseconds."""
    return 1e3 * sum(r.end - r.start for r in records)
