"""The device trace of a window, from ``torch.profiler``, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

The window runs under one ``torch.profiler`` run that records the host's
operations and the card's activities; the harness marks the window
(``bench.window``) and each call (``bench.call``) with
``record_function``.  The raw events are read once the profiler stops
(``kineto_results.events()``, without building the profiler's own event
tree, which takes minutes for a window of 10^5 kernels), and nothing is
written to disk.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch

WINDOW = 'bench.window'
CALL = 'bench.call'
#: The port's hand-written CUDA kernels, by the names they carry in the
#: trace (``spotlight_tpu_torch/ops/kernels/csrc``).
PORT_KERNELS = ('rank_kernel', 'matched_kernel', 'topk_stage1',
                'topk_stage2', 'gather_sum_kernel', 'scatter_rows_kernel',
                'row_adam_kernel')
#: Entries of each list of the result's ``breakdown``.
BREAKDOWN = 10


@contextlib.contextmanager
def profiled(enabled, on_card):
    """Run the block under ``torch.profiler`` (host operations, and the
    card's activities ``on_card``) when ``enabled``; yields a namespace
    whose ``profile`` is the stopped profiler, or None."""
    out = SimpleNamespace(profile=None)
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    try:
        yield out
    finally:
        profiler.stop()
        out.profile = profiler


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _label_gaps(gaps, host_events):
    """The innermost host operation (of the window's thread) open at each
    gap's midpoint, or 'host outside any operation'."""
    events = sorted(host_events, key=lambda e: (e[1], -e[2]))
    order = sorted(range(len(gaps)),
                   key=lambda g: gaps[g][0] + gaps[g][1])
    labels = [None] * len(gaps)
    stack, j = [], 0
    for g in order:
        mid = 0.5 * (gaps[g][0] + gaps[g][1])
        while j < len(events) and events[j][1] <= mid:
            while stack and stack[-1][2] < events[j][1]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        labels[g] = stack[-1][0] if stack else 'host outside any operation'
    return labels


def summarize(profiler):
    """The window's device activity: ``window_s``, ``busy_s`` (the union of
    the card's activities), ``by_name`` (device seconds by activity name),
    ``device_ops`` and ``idle_gaps`` (the breakdown's lists)."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = profiler.profiler.kineto_results.events()
    window = [e for e in raw if e.name() == WINDOW
              and e.device_type() != cuda]
    if len(window) != 1:
        raise RuntimeError('the trace holds {} windows'.format(len(window)))
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    thread = window[0].start_thread_id()
    device, host = [], []
    for e in raw:
        start, end = e.start_ns(), e.end_ns()
        if end <= w0 or start >= w1:
            continue
        if e.is_user_annotation():
            # The harness's own marks, which the profiler also draws on
            # the device's timeline around the kernels they hold.
            continue
        if e.device_type() == cuda:
            device.append((e.name(), max(start, w0), min(end, w1)))
        elif e.start_thread_id() == thread:
            host.append((e.name(), start, end))
    busy = _union([(s, e) for _, s, e in device])
    by_name = {}
    for name, start, end in device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e9
    edges = [w0] + [x for interval in busy for x in interval] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    idle = {}
    for (start, end), label in zip(gaps, _label_gaps(gaps, host)):
        idle[label] = idle.get(label, 0.0) + (end - start) / 1e9
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return SimpleNamespace(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        by_name=by_name,
        device_ops=[[name, seconds] for name, seconds in ranked[:BREAKDOWN]],
        idle_gaps=[[name, seconds] for name, seconds in sorted(
            idle.items(), key=lambda kv: -kv[1])[:BREAKDOWN]])


def idle_percent(window):
    """The share of the traced ``window`` in which no activity ran on the
    card, in percent; None untraced."""
    if window.trace is None:
        return None
    return 100.0 * (1.0 - window.trace.busy_s / window.trace.window_s)


def device_seconds(trace, names):
    """Device seconds of the activities whose name holds one of ``names``
    (a kernel's trace name is its signature, templates included)."""
    return sum(seconds for name, seconds in trace.by_name.items()
               if any(n in name for n in names))
