"""Training throughput of a checkout of the port, for comparing two trees on
one card in one call.

Usage::

    python3 tools/train_throughput.py ROOT [ROOT ...]

Each ROOT is a checkout of the repository (this one, or a ``git archive``
of another commit unpacked into an ignored directory).  For each ROOT, in
the order given and in a process of its own, the script builds that tree's
P1 kernel, then times ``ImplicitFactorizationModel.fit`` of that tree's
``spotlight_tpu_torch`` at ``chip_smoke.py``'s phase 9 widths: the lazy
engine (BPR, D=64, 2e6 users x 5e5 items, 1e6 pairs from
``RandomState(42)``, batch 8,192) and the dense engine (1e5 x 2e4), one
warm epoch each, then three timed fits (4 and 10 epochs).  It prints one
JSON line per ROOT with the examples/s of each fit and their median, and
the card's name and power limit.  Give the trees in turns (parent, change,
change, parent) to see the host's drift beside the change.  Needs one
CUDA card and ``nvcc``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

PAIRS, BATCH, DIM, FITS = 1_000_000, 8_192, 64, 3
ENGINES = (('lazy', 2_000_000, 500_000, 4, True),
           ('dense', 100_000, 20_000, 10, False))


def measure(root):
    """Time both engines of the tree at ``root`` (run in a child process:
    each tree has its own ``spotlight_tpu_torch``)."""
    import numpy as np
    import torch

    sys.path.insert(0, root)
    from spotlight_tpu_torch.data import Interactions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.ops.kernels import _build

    _build.SOURCES = ('row_update',)            # the only kernel trained with
    _build.build()
    result = {'root': root}
    for engine, users, items, epochs, sparse in ENGINES:
        rs = np.random.RandomState(42)
        data = Interactions(rs.randint(0, users, PAIRS).astype(np.int64),
                            rs.randint(0, items, PAIRS).astype(np.int64),
                            num_users=users, num_items=items)
        model = ImplicitFactorizationModel(
            loss='bpr', embedding_dim=DIM, n_iter=1, batch_size=BATCH,
            learning_rate=1e-2, sparse=sparse,
            random_state=np.random.RandomState(42))
        model.fit(data)
        rates = []
        for _ in range(FITS):
            model._n_iter = epochs
            torch.cuda.synchronize()
            start = time.perf_counter()
            model.fit(data)
            torch.cuda.synchronize()
            rates.append(epochs * PAIRS / (time.perf_counter() - start))
        result[engine] = {'examples_per_s': statistics.median(rates),
                          'fits': rates}
        del model, data
        torch.cuda.empty_cache()
    return result


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    if sys.argv[1] == '--child':
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit('train_throughput: no CUDA device is available')
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
