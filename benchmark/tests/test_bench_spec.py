"""The harness finds every piece of a cell by name, from the files alone."""

import json

import pytest

from benchmark import spec
from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
WORKLOADS = [w['name'] for w in BENCH['workloads']]
METRICS = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]


@pytest.mark.parametrize('workload', WORKLOADS)
def test_cell_pieces_are_found_by_name(workload):
    cell = spec.load(workload)
    assert cell.cell['name'] == workload
    assert cell.cfg['model'] and cell.traffic['entry']
    for name in ('setup', 'call', 'counters', 'release', 'verify',
                 'control'):
        assert callable(getattr(spec.entry(cell.traffic), name))
    assert callable(spec.family(cell.cfg).make_weights)
    # Every compared number of the cell has a limit.
    assert all('limit' in v for v in cell.limits.values())
    # The cell reports setup_s, another end-to-end metric and a per-layer
    # metric.
    names = [m['name'] for m in cell.end_to_end]
    assert 'setup_s' in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize('name', METRICS)
def test_every_metric_has_its_reader(name):
    assert callable(spec.reader(name))


def test_each_config_file_lies_under_paths():
    for config in BENCH['configs']:
        assert any(config['file'].startswith(p + '/')
                   for p in BENCH['paths'])
        assert (ROOT / config['file']).is_file()


def test_per_layer_metrics_report_where_their_end_to_end_metric_does():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for metric in BENCH['per_layer']:
        moved = e2e[metric['moves']]
        cells = metric.get('workloads', WORKLOADS)
        assert set(cells) <= set(moved.get('workloads', WORKLOADS))


def test_a_metric_in_a_new_file_is_found(tmp_path):
    (tmp_path / 'benchmark' / 'metrics').mkdir(parents=True)
    (tmp_path / 'benchmark' / 'metrics' / 'calls.count.py').write_text(
        'def read(window):\n    return len(window.calls)\n')
    read = spec.reader('calls.count', root=tmp_path)
    assert read(type('W', (), {'calls': [1, 2, 3]})) == 3
