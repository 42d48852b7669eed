"""Entry points the window drives, one file each, named after the port's
call: ``setup``, ``call``, ``counters``, ``release`` and ``verify`` (and
``control``, for the control's readings, which the benchmark's own runs
never make)."""
