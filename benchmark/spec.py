"""Finds a cell's pieces by name from the files alone.

``BENCHMARK.json`` names the cells, configurations and metrics; a cell's
configuration file is the ``file`` its configuration names, its traffic
is ``benchmark/traffic/<traffic>.json``, its limits
``benchmark/limits/<workload>.json``, each metric's reader
``benchmark/metrics/<metric>.py``, a configuration's model family
``benchmark/models/<model>.py`` and a traffic's entry point
``benchmark/entries/<entry>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def _by_name(entries, name, what):
    found = [e for e in entries if e['name'] == name]
    if len(found) != 1:
        raise KeyError('{} {!r}: {} entries in BENCHMARK.json'.format(
            what, name, len(found)))
    return found[0]


def _applies(metric, workload):
    return 'workloads' not in metric or workload in metric['workloads']


def load(workload, root=ROOT):
    """The cell ``workload``: its entry, configuration, traffic, limits and
    the metrics it reports (``end_to_end`` with ``--trace 0``,
    ``per_layer`` with ``--trace 1``)."""
    root = Path(root)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    cell = _by_name(bench['workloads'], workload, 'workload')
    config = _by_name(bench['configs'], cell['config'], 'config')
    here = root / 'benchmark'
    return SimpleNamespace(
        cell=cell,
        cfg=json.loads((root / config['file']).read_text()),
        traffic=json.loads((here / 'traffic' / (cell['traffic'] + '.json'))
                           .read_text()),
        limits=json.loads((here / 'limits' / (workload + '.json'))
                          .read_text()),
        end_to_end=[m for m in bench['end_to_end']
                    if _applies(m, workload)],
        per_layer=[m for m in bench['per_layer'] if _applies(m, workload)])


def reader(name, root=ROOT):
    """The ``read(window)`` function of ``benchmark/metrics/<name>.py``."""
    path = Path(root) / 'benchmark' / 'metrics' / (name + '.py')
    module_spec = importlib.util.spec_from_file_location(
        'benchmark.metrics.' + name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def family(cfg):
    return importlib.import_module('benchmark.models.' + cfg['model'])


def entry(traffic):
    return importlib.import_module('benchmark.entries.' + traffic['entry'])
