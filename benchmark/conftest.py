"""The tiny sizes of the configurations added after the shared table of
``benchmark/tests/conftest.py`` (``TINY``), registered into it before any
test of ``benchmark/tests`` runs, so that the tests parametrized over every
cell of ``BENCHMARK.json`` cut these cells too."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.tests import conftest as shared  # noqa: E402

#: SASRec's ML-1M configuration cut for a CPU test run: every width but the
#: window kept, 400 users of 12 to 40 actions (a window of 40).
shared.TINY.setdefault('sasrec_ml1m', dict(
    num_items=3417, num_sequences=400, sequence_length=40,
    max_sequence_length=40, num_actions=8000, min_actions=12,
    max_actions=80))
