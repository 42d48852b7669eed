"""The per-layer metrics read from the port's spans: a traced run of each
cell reports those listed for it, as finite numbers of at least 0; an
untraced run reports none of them; a port without spans gives none and
does not raise."""

import json
import math
from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.tests.conftest import ROOT, run_tiny

BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
SPAN_METRICS = [m for m in BENCH['per_layer']
                if m['source'] == 'program_span']
WORKLOADS = [w['name'] for w in BENCH['workloads']]


def _listed(workload):
    return {m['name'] for m in SPAN_METRICS
            if workload in m.get('workloads', WORKLOADS)}


@pytest.mark.parametrize('traced', [True, False])
@pytest.mark.parametrize('workload', WORKLOADS)
def test_span_metrics_in_traced_runs_only(workload, traced):
    result, _ = run_tiny(workload, traced=traced)
    reported = set(result['metrics']) & {m['name'] for m in SPAN_METRICS}
    if not traced:
        assert reported == set()
        return
    assert _listed(workload) and reported == _listed(workload)
    for name in reported:
        value = result['metrics'][name]['value']
        assert math.isfinite(value) and value >= 0, (name, value)


@pytest.mark.parametrize('name', [m['name'] for m in SPAN_METRICS])
def test_a_port_without_spans_gives_none(name, monkeypatch):
    from spotlight_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, 'spans')
    window = SimpleNamespace(calls=[{'start': 0.0, 'end': 1e12}])
    assert spec.reader(name)(window) is None


@pytest.mark.parametrize('name', [m['name'] for m in SPAN_METRICS])
def test_spans_outside_the_window_are_not_read(name):
    from spotlight_tpu_torch.utils import profiling

    with profiling.recording():
        for span_name in ('spotlight.fit', 'spotlight.fit.step',
                          'spotlight.fit.epoch_data', 'spotlight.eval.rows',
                          'spotlight.eval.upload', 'spotlight.eval.factors'):
            with profiling.span(span_name):
                pass
    latest = max(r.end for r in profiling.spans())
    window = SimpleNamespace(calls=[{'start': latest, 'end': latest + 1.0}])
    assert spec.reader(name)(window) is None
