"""Shared pieces of the benchmark's CPU tests: cells cut to a size a test
run holds, run on the CPU through the harness (past its look for a card).
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Sizes a CPU test run holds, by configuration.
TINY = {
    'mf_bpr_msd': dict(num_users=3000, num_items=700, num_interactions=60000,
                       max_user_interactions=200, fit_interactions=3000,
                       batch_size=256),
    'mixture_lstm_1e6': dict(num_items=3000, num_sequences=600),
}
TINY_TRAFFIC = dict(rows_per_call=64, pool_calls=4, check_answers=96)


def tiny_spec(workload, traffic=None, **config):
    """The cell ``workload`` as ``BENCHMARK.json`` and its files give it,
    cut to :data:`TINY` (and ``config``; ``traffic`` over
    :data:`TINY_TRAFFIC`)."""
    from benchmark import spec

    cell = spec.load(workload)
    cell.cfg.update(TINY[cell.cell['config']], **config)
    for key, value in dict(TINY_TRAFFIC, **(traffic or {})).items():
        if key in cell.traffic:
            cell.traffic[key] = value
    return cell


def run_tiny(workload, seed=7, seconds=0.5, traced=False, controls=(),
             traffic=None, **config):
    """One CPU run of the cut cell: ``(result, checks)``."""
    from benchmark import harness

    return harness.run_cell(tiny_spec(workload, traffic, **config), seed,
                            seconds, traced, 'cpu', controls=controls)


@pytest.fixture
def card():
    """The card, or a skip where none is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.cuda.get_device_name(0)
