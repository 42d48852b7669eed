"""Streaming top-k (K2) times of a checkout of the port, for comparing two
trees on one card in one call.

Usage::

    python3 tools/topk_times.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or a ``git archive``
of another commit unpacked into an ignored directory).  For each ROOT, in
the order given and in a process of its own, the script builds that tree's
top-k kernel, then times that tree's ``streaming_topk`` over 200,000 items
at D=64 on seeded operands (``chip_smoke.py``'s ``kernel_inputs``): dot
scoring at B=2,048 with k=34 and 143 and at B=256 with k=10 and 300, and
mixture scoring with M=4 at B=2,048 with k=10 and at B=256 with k=10 and
59.  Each time is the median of 30 launches by CUDA events after one
warm-up.  It prints one JSON line per ROOT, and the card's name and power
limit.  Give the trees in turns (parent, change, change, parent) to see the
card's drift beside the change.  Needs one CUDA card and ``nvcc``.
"""

import json
import os
import statistics
import subprocess
import sys

NUM_ITEMS, DIM, MIXTURES, REPS = 200_000, 64, 4, 30
CASES = ((None, 2048, 34), (None, 2048, 143), (None, 256, 10),
         (None, 256, 300), (MIXTURES, 2048, 10), (MIXTURES, 256, 10),
         (MIXTURES, 256, 59))


def measure(root):
    """Time the cases with the tree at ``root`` (run in a child process:
    each tree has its own ``spotlight_tpu_torch``)."""
    import torch

    sys.path.insert(0, root)
    from spotlight_tpu_torch.ops.kernels import _build, topk

    _build.SOURCES = ('topk',)                  # the only kernel timed
    _build.build()

    def median_ms(fn):
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

    generator = torch.Generator(device='cuda')
    generator.manual_seed(0)
    items = torch.randn(NUM_ITEMS, DIM, generator=generator,
                        device='cuda') / DIM ** .5
    bias = 0.1 * torch.randn(NUM_ITEMS, generator=generator, device='cuda')
    result = {'root': root}
    for mixtures, batch, k in CASES:
        width = DIM if mixtures is None else 2 * mixtures * DIM
        users = torch.randn(batch, width, generator=generator,
                            device='cuda') / DIM ** .5
        name = '{} B={} k={}'.format(
            'dot' if mixtures is None else 'mixture M={}'.format(mixtures),
            batch, k)
        result[name] = median_ms(
            lambda: topk.streaming_topk(users, items, bias, k, mixtures))
    return result


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    if sys.argv[1] == '--child':
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit('topk_times: no CUDA device is available')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), '--child',
                        root], check=True, timeout=1800)


if __name__ == '__main__':
    main()
