"""The readings that a cell's limits are set from, on the card: for each
seed, one run of the cell (a short window), the port's readings, and the
readings of the controls that the entry knows: the reference put in the
port's place in the nearest precision below the configuration's, and for
training the fault of half of each batch left out.  The benchmark's own
runs never make these.

    python3 benchmark/control.py --workload <name> --seconds <s> \
        --controls <name>[,<name>...] --seeds <n> [<n> ...]

One JSON line a seed, on standard output; the process's set-up is paid
once for all seeds.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--controls', default='')
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    args = parser.parse_args(argv)
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or '.') != os.path.dirname(
                                os.path.abspath(__file__))]
    import torch

    from benchmark import harness, spec

    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 2
    controls = [c for c in args.controls.split(',') if c]
    for seed in args.seeds:
        started = time.perf_counter()
        result, _ = harness.run_cell(spec.load(args.workload), seed,
                                     args.seconds, False, 'cuda', started,
                                     controls)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'correct': result['correct'],
                          'attempted': result['attempted'],
                          'metrics': result['metrics'],
                          'checks': result['checks'],
                          'controls': result.get('controls', {}),
                          'run_s': time.perf_counter() - started}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
