"""Each cell's control, the reference put in the port's place in the
nearest precision below the configuration's (TF32 products for ranking,
bfloat16 for training), comes out not correct against the cell's limits,
at a size a test run holds.  (On the card, at the cells' own sizes,
``python3 benchmark/control.py`` reads the same controls.)"""

import json

import pytest

from benchmark.tests.conftest import ROOT, run_tiny


def _limits(workload):
    return json.loads((ROOT / 'benchmark' / 'limits'
                       / (workload + '.json')).read_text())


def _fails(readings, limits):
    return any(readings[name] > limits[name]['limit'] for name in readings)


@pytest.mark.parametrize('workload,control', [
    ('mf-msd.train-dense', 'bfloat16'),
    ('mf-msd.train-dense', 'half_batch'),
    ('mf-msd.mrr', 'tf32'),
    ('mixture-1e6.mrr', 'tf32')])
def test_the_control_of_a_cell_is_not_correct(workload, control):
    result, checks = run_tiny(workload, controls=(control,),
                              traffic=dict(check_answers=10 ** 6))
    assert result['correct'] is True
    assert _fails(result['controls'][control], _limits(workload))
