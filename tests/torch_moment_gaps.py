"""How far the port's optimizer moments lie from JAX's after one step.

Runs every case of ``tests/test_torch_training.py``'s one-step and epoch
comparisons (the same state, the same draws) and prints, per case and
moment table, the number of elements that differ, the largest gap in ulps
of the element itself and the largest gap relative to the table's largest
moment: the measurements behind that file's ``MOMENT_SCALE``.

    python -m tests.torch_moment_gaps
"""

import json
import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests import test_torch_training as cases  # noqa: E402
from spotlight_tpu_torch.utils.convert import opt_state_from_jax  # noqa: E402


def gaps(jax_model, port):
    want = opt_state_from_jax(port._net, cases.tree(jax_model._opt_state))
    out = {}
    for moment in ('mu', 'nu'):
        for name, value in want[moment].items():
            got = port._opt_state[moment][name].float().numpy()
            ref = value.float().numpy()
            ulps = np.abs(got.view(np.int32).astype(np.int64)
                          - ref.view(np.int32).astype(np.int64))
            scale = np.abs(ref.astype(np.float64)).max()
            out['{} {}'.format(moment, name.split('.')[0])] = {
                'differ': int((got != ref).sum()), 'of': int(ref.size),
                'max_ulps': int(ulps.max()),
                'max_gap_over_scale': float(
                    np.abs(got.astype(np.float64) - ref).max() / scale)}
    return out


def main():
    torch.set_num_threads(1)
    one_step = cases.BATCH - 5
    runs = [(loss, sampling, sparse, 'float32', one_step, 1e-6)
            for loss in cases.LOSSES for sampling in ('uniform', 'in_batch')
            for sparse in (True, False)]
    runs += [('bpr', sampling, True, 'bfloat16', one_step, 1e-6)
             for sampling in ('uniform', 'in_batch')]
    runs += [('bpr', 'uniform', True, 'float32', 3 * cases.BATCH - 7, 0.0),
             ('adaptive_hinge', 'in_batch', True, 'float32',
              3 * cases.BATCH - 7, 0.0),
             ('hinge', 'uniform', False, 'float32', 3 * cases.BATCH - 7, 0.0)]
    worst_ulps = worst_scale = 0
    for loss, sampling, sparse, table, n, l2 in runs:
        jax_model, port, _ = cases.compare_epoch(loss, sampling, sparse, n,
                                                 table=table, l2=l2)
        by_table = gaps(jax_model, port)
        worst_ulps = max([worst_ulps] + [g['max_ulps']
                                         for g in by_table.values()])
        worst_scale = max([worst_scale] + [g['max_gap_over_scale']
                                           for g in by_table.values()])
        print(json.dumps({'loss': loss, 'negatives': sampling,
                          'engine': 'lazy' if sparse else 'dense',
                          'table': table, 'examples': n, 'l2': l2,
                          'gaps': by_table}), flush=True)
    print(json.dumps({'cases': len(runs), 'max_ulps': worst_ulps,
                      'max_gap_over_scale': worst_scale,
                      'moment_scale': cases.MOMENT_SCALE}))


if __name__ == '__main__':
    main()
