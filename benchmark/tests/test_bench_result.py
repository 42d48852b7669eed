"""The result line: the contract's keys, in order, with the compared
numbers last; no result without a card."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec
from benchmark.tests.conftest import ROOT, run_tiny

WORKLOADS = [w['name'] for w in json.loads(
    (ROOT / 'BENCHMARK.json').read_text())['workloads']]


@pytest.mark.parametrize('traced', [False, True])
@pytest.mark.parametrize('workload', WORKLOADS)
def test_result_has_the_contract_keys(workload, traced):
    result, checks = run_tiny(workload, traced=traced)
    keys = list(result)
    assert keys[:5] == ['correct', 'attempted', 'failed', 'metrics',
                        'device']
    assert keys[-1] == 'checks' and set(keys[5:-1]) <= {'breakdown'}
    assert result['correct'] is True and result['failed'] == 0
    assert result['attempted'] >= 1
    assert set(result['device']) >= {'platform', 'kind', 'count',
                                     'memory_peak_bytes'}
    cell = spec.load(workload)
    wanted = cell.per_layer if traced else cell.end_to_end
    units = {m['name']: m['unit'] for m in wanted}
    assert set(result['metrics']) <= set(units)
    for name, metric in result['metrics'].items():
        assert metric['unit'] == units[name]
        assert isinstance(metric['value'], (int, float))
    if traced:
        assert {'busy_s', 'window_s'} <= set(result['device'])
        assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
        assert all(len(v) <= 10 for v in result['breakdown'].values())
    else:
        assert {'setup_s'} < set(result['metrics'])
    assert set(checks) == set(cell.limits)
    json.dumps(result, allow_nan=False)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    done = subprocess.run(
        [sys.executable, str(ROOT / 'benchmark' / 'run.py'), '--workload',
         'mf-msd.mrr', '--seed', str(2 ** 31 + 3), '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert done.returncode == 2
    assert done.stdout == ''
