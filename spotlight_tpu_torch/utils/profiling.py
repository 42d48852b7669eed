"""Profiling and throughput instrumentation.

Counterpart of ``spotlight_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  records the host's activity, and the card's when the caller's device is
  the card, and writes a Chrome trace into ``log_dir``;
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


@contextlib.contextmanager
def trace(log_dir='spotlight_trace', device=None):
    """Profile the enclosed block and write ``<log_dir>/trace.json``.

    Yields the ``torch.profiler.profile`` object (``key_averages()`` sums
    the events by name).  ``device`` is the device of the traced work: on
    the card (``'cuda'``) CUDA activity is recorded too, after a
    synchronisation at each end of the block.  View the file in Perfetto or
    ``chrome://tracing``.
    """
    from torch.profiler import ProfilerActivity, profile

    on_card = _on_card(device)
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


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
