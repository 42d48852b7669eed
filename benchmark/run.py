"""Runs one cell of ``BENCHMARK.json`` on the card and prints its result as
the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Exits with 2 and prints no result when no card (or too few) is present,
and with 3 when a JAX module or the JAX package is loaded once the window
has closed.  Build and kernel caches stay inside the checkout
(``build/kernels``); nothing is written elsewhere but under ``TMPDIR``.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    # The checkout's root, not this folder, is where the harness and the
    # port are imported from.
    sys.path[:] = [ROOT] + [p for p in sys.path
                            if os.path.abspath(p or '.') != os.path.dirname(
                                os.path.abspath(__file__))]
    from benchmark import harness, spec

    cell_spec = spec.load(args.workload)
    import torch

    chips = cell_spec.cell['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print('{} CUDA device(s) present; the cell {} needs {}'.format(
            torch.cuda.device_count() if torch.cuda.is_available() else 0,
            args.workload, chips), file=sys.stderr)
        return 2
    result, checks = harness.run_cell(cell_spec, args.seed, args.seconds,
                                      bool(args.trace), 'cuda', STARTED)
    found = harness.forbidden_modules()
    if found:
        print('loaded when the window closed: {}'.format(', '.join(found)),
              file=sys.stderr)
        return 3
    for name, check in checks.items():
        print('check {} {!r} limit {!r}'.format(name, check['value'],
                                                check['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
