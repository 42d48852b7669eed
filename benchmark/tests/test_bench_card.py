"""Each cell on the card, through the benchmark's own command, with a
short window: it prints one result line, correct, from the card.  Skips
without a card (run on the card with ``python -m pytest -m cuda
benchmark/tests``)."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT

WORKLOADS = [w['name'] for w in json.loads(
    (ROOT / 'BENCHMARK.json').read_text())['workloads']]


@pytest.mark.cuda
@pytest.mark.parametrize('workload', WORKLOADS)
def test_cell_runs_correct_on_the_card(card, workload):
    done = subprocess.run(
        [sys.executable, str(ROOT / 'benchmark' / 'run.py'), '--workload',
         workload, '--seed', str(2 ** 32 + 17), '--seconds', '3',
         '--trace', '0'], capture_output=True, text=True, cwd=ROOT,
        timeout=1200)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result['correct'] is True
    assert result['device']['kind'] == card
