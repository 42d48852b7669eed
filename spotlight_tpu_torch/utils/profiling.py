"""Profiling and throughput instrumentation.

Counterpart of ``spotlight_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  records the host's activity, and the card's when the caller's device is
  the card, writes a Chrome trace into ``log_dir`` and yields that
  directory, as the JAX package's yields its own;
- :class:`ThroughputMeter`: examples/s with warm-up steps excluded.  On the
  card it synchronises before each reading of the clock, so a step's time
  includes its device work.

``torch.profiler`` loses device events after several profiling sessions in
one process: profile the card in a fresh process where every event counts.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _on_card(device):
    return device is not None and torch.device(device).type == 'cuda'


class TraceDir(str):
    """The directory :func:`trace` writes into, which is what the JAX
    package's ``trace`` yields, carrying the ``torch.profiler.profile``
    object as :attr:`profiler` (``key_averages()`` sums its events by name
    once the block has ended)."""

    profiler = None


@contextlib.contextmanager
def trace(log_dir='/tmp/spotlight_tpu_trace', device=None):
    """Profile the enclosed block and write ``<log_dir>/trace.json``.

    Yields ``log_dir`` as a :class:`TraceDir`, whose ``profiler`` is the
    ``torch.profiler.profile`` object.  ``device`` is the device of the
    traced work: on the card (``'cuda'``) CUDA activity is recorded too,
    after a synchronisation at each end of the block.  The profiler stops
    and the trace is written when the block ends, also when it raises.
    View the file in Perfetto or ``chrome://tracing``.
    """
    from torch.profiler import ProfilerActivity, profile

    on_card = _on_card(device)
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    traced = TraceDir(log_dir)
    traced.profiler = profile(activities=activities)
    traced.profiler.start()
    try:
        yield traced
        if on_card:
            torch.cuda.synchronize()
    finally:
        traced.profiler.stop()
        traced.profiler.export_chrome_trace(os.path.join(log_dir,
                                                         'trace.json'))


class ThroughputMeter:
    """Examples/s counter with warm-up exclusion.

    Usage::

        meter = ThroughputMeter(warmup_steps=1, device='cuda')
        for epoch in range(n):
            with meter.step(num_examples):
                run_epoch()
        print(meter.examples_per_second())

    ``device``: where the measured work runs; on the card each step
    synchronises before it reads the clock at its start and at its end.
    """

    def __init__(self, warmup_steps=1, device=None):
        self._warmup_steps = warmup_steps
        self._on_card = _on_card(device)
        self._steps = 0
        self._examples = 0
        self._elapsed = 0.0

    def _clock(self):
        if self._on_card:
            torch.cuda.synchronize()
        return time.perf_counter()

    @contextlib.contextmanager
    def step(self, num_examples):
        start = self._clock()
        yield
        elapsed = self._clock() - start
        self._steps += 1
        if self._steps > self._warmup_steps:
            self._examples += num_examples
            self._elapsed += elapsed

    def examples_per_second(self, num_chips=1):
        if not self._elapsed:
            return 0.0
        return self._examples / self._elapsed / num_chips

    @property
    def measured_steps(self):
        return max(0, self._steps - self._warmup_steps)
