"""Matched-pair scoring times (K1c ``matched_target_scores`` and K4
``matched_candidate_scores``) of a checkout of the port, for comparing two
trees on one card in one call.

Usage::

    python3 tools/matched_times.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or a ``git archive``
of another commit unpacked into an ignored directory).  The script first
builds every distinct ROOT's ranking kernels, all at once; then, for each
ROOT in the order given and in a process of its own, it times that tree's
two wrappers at the shapes ``chip_smoke.py``'s main paths hand them, on
ids drawn from the same seeds:

- K1c, implicit MF (phase 4, ``mrr_score`` with a train mask): B=2,048
  users over 200,000 items at D=64, their T=4 test targets, and their
  train rows (padded with -1 to the batch's widest row, then clipped into
  the catalogue as ``evaluation`` does);
- K1c, the bloom model (phase 7): B=2,048 sequences over 1,000,000 items,
  the targets (T=1) and the 49-item prefixes of ``exclude_preceding``;
- K4, the mixture model (phase 6, M=4): B=2,048 sequences over 200,000
  items, the targets (T=1) and the prefixes (T=49).

Factors are seeded normals (their values do not move the times).  Each
case prints the median of 30 launches, each bracketed by CUDA events
(``event_ms``: mostly the host's enqueue when the device work is short),
and, from ``torch.profiler`` over 20 calls, the device time of one call
(``device_ms``: the sum of its device activities' durations) and its
number of device activities (kernels, copies, fills).  One JSON line per
ROOT, and the card's name and power limit.  Give the trees in turns
(parent, change, change, parent) to see the card's drift beside the
change.  Needs one CUDA card and ``nvcc``.
"""

import json
import os
import statistics
import subprocess
import sys

import numpy as np

DIM, MIXTURES, BATCH, REPS, PROFILED = 64, 4, 2048, 30, 20
MF_ITEMS, MF_USERS, MF_PAIRS = 200_000, 50_000, 500_000
EVAL_USERS, TEST_PER_USER = 20_000, 4
BLOOM_ITEMS, SEQ_LENGTH = 1_000_000, 50


def mf_ids():
    """The first batch's test targets and clipped train rows of
    ``chip_smoke.py``'s implicit-MF data (RandomState(7))."""
    rs = np.random.RandomState(7)
    users = rs.randint(0, MF_USERS, MF_PAIRS)
    items = rs.randint(0, MF_ITEMS, MF_PAIRS)
    targets = rs.randint(0, MF_ITEMS, EVAL_USERS * TEST_PER_USER).reshape(
        EVAL_USERS, TEST_PER_USER)[:BATCH]
    keep = users < BATCH
    order = np.argsort(users[keep], kind='stable')
    rows_of = users[keep][order]
    counts = np.bincount(rows_of, minlength=BATCH)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    width = int(counts.max())
    train = np.zeros((BATCH, width), np.int64)   # -1 pads, clipped to 0
    cols = np.arange(len(rows_of)) - starts[rows_of]
    train[rows_of, cols] = items[keep][order]
    return targets.astype(np.int64), train


def sequence_ids(num_items):
    """Targets and prefixes of the first 2,048 of ``chip_smoke.py``'s
    sequences (RandomState(42))."""
    rows = np.random.RandomState(42).randint(
        1, num_items, (2 * BATCH, SEQ_LENGTH))[:BATCH].astype(np.int64)
    return rows[:, -1:], rows[:, :-1]


def measure(root):
    """Time the cases with the tree at ``root`` (run in a child process:
    each tree has its own ``spotlight_tpu_torch``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, root)
    from spotlight_tpu_torch.ops.kernels import _build, ranking

    _build.SOURCES = ('ranking',)               # the only kernels timed
    _build.build()

    def event_ms(fn):
        fn()
        torch.cuda.synchronize()
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
        for start, end in marks:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in marks)

    def device_work(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.end - e.time_range.start for e in events)
        return (busy_us / 1e3 / PROFILED, len(events) / PROFILED,
                sorted({e.name[:60] for e in events}))

    generator = torch.Generator(device='cuda')
    generator.manual_seed(0)

    def normal(*shape):
        return torch.randn(*shape, generator=generator,
                           device='cuda') / DIM ** .5

    mf_targets, mf_train = mf_ids()
    bloom_targets, bloom_prefixes = sequence_ids(BLOOM_ITEMS)
    seq_targets, seq_prefixes = sequence_ids(MF_ITEMS)
    cases = []
    for num_items, mixtures, named in (
            (MF_ITEMS, None, (('K1c MF targets', mf_targets),
                              ('K1c MF train rows', mf_train))),
            (BLOOM_ITEMS, None, (('K1c bloom targets', bloom_targets),
                                 ('K1c bloom prefixes', bloom_prefixes))),
            (MF_ITEMS, MIXTURES, (('K4 targets', seq_targets),
                                  ('K4 prefixes', seq_prefixes)))):
        width = DIM if mixtures is None else 2 * mixtures * DIM
        users = normal(BATCH, width)
        items = normal(num_items, DIM)
        bias = 0.1 * normal(num_items)
        for name, ids in named:
            ids = torch.as_tensor(ids, device='cuda')
            if mixtures is None:
                def call(ids=ids, users=users, items=items, bias=bias):
                    return ranking.matched_target_scores(users, items, bias,
                                                         ids)
            else:
                def call(ids=ids, users=users, items=items, bias=bias):
                    return ranking.matched_candidate_scores(
                        users, items, bias, ids, MIXTURES)
            cases.append(('{} B={} N={} T={}'.format(
                name, BATCH, num_items, ids.shape[1]), call))
    result = {'root': root}
    for name, call in cases:
        ms = event_ms(call)
        device_ms, activities, kernels = device_work(call)
        result[name] = dict(event_ms=ms, device_ms=device_ms,
                            device_activities=activities, kernels=kernels)
    return result


def build(root):
    sys.path.insert(0, root)
    from spotlight_tpu_torch.ops.kernels import _build

    _build.SOURCES = ('ranking',)
    return _build.build()


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    if sys.argv[1] in ('--child', '--build'):
        root = os.path.abspath(sys.argv[2])
        out = measure(root) if sys.argv[1] == '--child' else build(root)
        print(json.dumps(out), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit('matched_times: no CUDA device is available')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    script = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, script, '--build', root])
              for root in dict.fromkeys(sys.argv[1:])]
    if any(proc.wait(timeout=1800) for proc in builds):
        sys.exit('matched_times: a build failed')
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, script, '--child', root],
                       check=True, timeout=1800)


if __name__ == '__main__':
    main()
