"""One run of one cell: set-up, the measured window, the metrics, the
judgement of the window's answers, the result line.

The window is closed-loop with one client: the entry's calls run back to
back until ``seconds`` have passed, the last call ending the window, each
timed on the host's clock from the moment it is made until its result is
on the host.  Rates are all the work of the window over its whole time;
tails are over all its calls.  With ``trace`` the window runs under
``torch.profiler`` and the run reports the per-layer metrics instead of
the end-to-end ones.
"""

from __future__ import annotations

import gc
import math
import sys
import time
import traceback
from types import SimpleNamespace

import torch

from benchmark import spec as spec_module
from benchmark import trace as trace_module

#: Top-level module names that may not be loaded when the window closes.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'spotlight_tpu')


class Run:
    """What a cell's entry and model family read: the cell, its
    configuration and traffic, the seed, the device."""

    def __init__(self, spec, seed, device):
        self.cell = spec.cell
        self.cfg = spec.cfg
        self.traffic = spec.traffic
        self.seed = seed
        self.device = torch.device(device)
        self.on_card = self.device.type == 'cuda'
        self.family = spec_module.family(spec.cfg)
        self.entry = spec_module.entry(spec.traffic)
        self.counters = {}

    def synchronize(self):
        if self.on_card:
            torch.cuda.synchronize()

    def set_up_data(self):
        """Called once the harness's own data is made: the peak memory
        counts from here, the port's set-up and the window."""
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()


def forbidden_modules(names=None):
    """Of the loaded modules (or ``names``), the top-level names (before
    the first dot) that are one of :data:`FORBIDDEN`."""
    names = sys.modules if names is None else names
    return sorted({name.split('.')[0] for name in names} & set(FORBIDDEN))


def window(run, state, seconds, traced):
    """The measured window: ``(calls, failed, window_s, trace)``."""
    from torch.profiler import record_function

    calls, failed = [], 0
    with trace_module.profiled(traced, run.on_card) as profiled:
        with record_function(trace_module.WINDOW):
            start = time.perf_counter()
            deadline = start + seconds
            index = 0
            while True:
                t0 = time.perf_counter()
                try:
                    with record_function(trace_module.CALL):
                        info = run.entry.call(run, state, index)
                except Exception:  # noqa: BLE001 - a failed call is counted
                    if not failed:
                        traceback.print_exc()
                    failed += 1
                    info = {'work': 0}
                t1 = time.perf_counter()
                calls.append(dict(info, start=t0, end=t1))
                index += 1
                if t1 >= deadline:
                    break
            window_s = time.perf_counter() - start
    summary = (trace_module.summarize(profiled.profile) if traced
               else None)
    return calls, failed, window_s, summary


def run_cell(spec, seed, seconds, traced, device='cuda', started=None,
             controls=()):
    """One run of the cell ``spec``; returns ``(result, checks)``: the
    result line's object and the compared numbers with their limits.
    ``started`` is the host clock when the process began (set-up counts
    from there).  Each of ``controls`` (none in the benchmark's own runs)
    adds the entry's readings of that control to the result, under
    ``controls``."""
    started = time.perf_counter() if started is None else started
    run = Run(spec, seed, device)
    state = run.entry.setup(run)
    run.synchronize()
    setup_s = time.perf_counter() - started

    before = run.entry.counters(run, state)
    calls, failed, window_s, summary = window(run, state, seconds, traced)
    after = run.entry.counters(run, state)
    run.counters = {name: after[name] - before[name] for name in before}
    memory_peak = (torch.cuda.max_memory_allocated(run.device)
                   if run.on_card else 0)

    measured = SimpleNamespace(
        cell=run.cell, cfg=run.cfg, traffic=run.traffic, calls=calls,
        window_s=window_s, setup_s=setup_s, counters=run.counters,
        trace=summary)
    metrics = {}
    for metric in (spec.per_layer if traced else spec.end_to_end):
        value = spec_module.reader(metric['name'])(measured)
        if value is not None:
            metrics[metric['name']] = {'value': value,
                                       'unit': metric['unit']}

    run.entry.release(run, state)
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
    numbers = run.entry.verify(run, state)
    # A reading that is no number (a NaN loss, say) prints as 1e30, far
    # past every limit.
    checks = {name: {'value': value if math.isfinite(value) else 1e30,
                     'limit': spec.limits[name]['limit']}
              for name, value in numbers.items()}
    correct = (failed == 0 and bool(calls)
               and all(c['value'] <= c['limit'] for c in checks.values()))

    device_info = {'platform': 'gpu' if run.on_card else 'cpu',
                   'kind': (torch.cuda.get_device_name(run.device)
                            if run.on_card else 'cpu'),
                   'count': run.cell['chips'],
                   'memory_peak_bytes': memory_peak}
    result = {'correct': correct, 'attempted': len(calls), 'failed': failed,
              'metrics': metrics, 'device': device_info}
    if summary is not None:
        device_info['busy_s'] = summary.busy_s
        device_info['window_s'] = summary.window_s
        result['breakdown'] = {'device_ops': summary.device_ops,
                               'idle_gaps': summary.idle_gaps}
    if controls:
        result['controls'] = {name: run.entry.control(run, state, name)
                              for name in controls}
    result['checks'] = checks
    return result, checks
