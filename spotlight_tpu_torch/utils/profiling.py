"""Profiling and throughput instrumentation.

Counterpart of ``spotlight_tpu/utils/profiling.py``:

- :func:`trace`: a context manager around ``torch.profiler.profile`` that
  records the host's activity, and the card's when the caller's device is
  the card, writes a Chrome trace into ``log_dir`` and yields that
  directory, as the JAX package's yields its own;
- :class:`ThroughputMeter`: examples/s with warm-up steps excluded.  On the
  card it synchronises before each reading of the clock, so a step's time
  includes its device work;
- :class:`span`: a named interval of the host's time at a layer boundary
  of the port (the metrics, ``fit``, the host's preparation, the factors,
  the steps).  Off, it costs one check.  Under a ``torch.profiler`` run it
  is a host operation of the trace, beside the card's activities on one
  clock, and under a profiler or :func:`recording` it is also kept in a
  bounded log in memory (:func:`spans`, :func:`self_time`).

``torch.profiler`` loses device events after several profiling sessions in
one process: profile the card in a fresh process where every event counts.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
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


#: Records the span log holds; a span that ends once it is full is counted
#: in :data:`SPANS_DROPPED` instead.
SPAN_LOG_LIMIT = 2 ** 18
#: Spans left out of the full log since the last :func:`clear_spans`.
SPANS_DROPPED = 0

#: One span of the log: its ``name``; ``start`` and ``end`` on
#: ``time.perf_counter``; its ``id``; the ``id`` of the span open around it
#: on its thread (``parent``, None for an outermost span); and ``request``,
#: the ``id`` of the outermost span (the entry point) it lies in.
SpanRecord = collections.namedtuple(
    'SpanRecord', 'name start end id parent request')

_log = []
_log_lock = threading.Lock()
_ids = itertools.count(1)
_open = threading.local()
_recording = 0
_profiler_enabled = torch._C._autograd._profiler_enabled
_marker = torch._C._profiler._RecordFunctionFast


def _append(record):
    global SPANS_DROPPED
    with _log_lock:
        if len(_log) < SPAN_LOG_LIMIT:
            _log.append(record)
        else:
            SPANS_DROPPED += 1


class span:
    """``with span(name):`` names the host's time in the block.

    Off (no ``torch.profiler`` run recording and no :func:`recording`
    block open) it reads two flags and does nothing else.  On, it

    - opens ``torch._C._profiler._RecordFunctionFast(name)``, while a
      profiler records: the span is then a host operation of the trace on
      the caller's thread (not a user annotation), on the clock of the
      card's activities, so a gap in the card's work is labelled with the
      span open across it;
    - appends a :class:`SpanRecord` to the log when the block ends (also
      when it raises): its parent is the span open around it on the same
      thread, its request the outermost one.

    The port opens spans at its layer boundaries, none inside a kernel's
    wrapper.
    """

    __slots__ = ('name', '_stack', '_mark', '_start', '_id', '_parent',
                 '_request')

    def __init__(self, name):
        self.name = name
        self._stack = None

    def __enter__(self):
        profiling = _profiler_enabled()
        if not (profiling or _recording):
            return self
        stack = getattr(_open, 'stack', None)
        if stack is None:
            stack = _open.stack = []
        self._id = next(_ids)
        if stack:
            self._parent, self._request = stack[-1]._id, stack[-1]._request
        else:
            self._parent, self._request = None, self._id
        self._mark = None
        if profiling:
            self._mark = _marker(self.name)
            self._mark.__enter__()
        stack.append(self)
        self._stack = stack
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc_info):
        stack = self._stack
        if stack is None:
            return False
        end = time.perf_counter()
        self._stack = None
        stack.pop()
        if self._mark is not None:
            self._mark.__exit__(*exc_info)
        _append(SpanRecord(self.name, self._start, end, self._id,
                           self._parent, self._request))
        return False


@contextlib.contextmanager
def recording():
    """Keep the port's spans in the log within the block, without a
    profiler (and without the profiler's cost).  Blocks nest."""
    global _recording
    with _log_lock:
        _recording += 1
    try:
        yield
    finally:
        with _log_lock:
            _recording -= 1


def spans():
    """A copy of the span log, in the order the spans ended."""
    with _log_lock:
        return list(_log)


def clear_spans():
    """Empty the span log and zero :data:`SPANS_DROPPED`."""
    global SPANS_DROPPED
    with _log_lock:
        _log.clear()
        SPANS_DROPPED = 0


def self_time(record, records=None):
    """Seconds of ``record`` that none of its children (the spans of
    ``records``, default the log, whose parent it is) covers."""
    records = spans() if records is None else records
    covered, reach = 0.0, record.start
    for child in sorted((r for r in records if r.parent == record.id),
                        key=lambda r: r.start):
        start, end = max(child.start, reach), min(child.end, record.end)
        if end > start:
            covered += end - start
            reach = end
    return (record.end - record.start) - covered
