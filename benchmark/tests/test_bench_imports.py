"""Nothing the harness runs loads JAX or the JAX package, compared by
whole top-level names, and the reference loads nothing of the port."""

import subprocess
import sys

from benchmark.tests.conftest import ROOT

RUN = '''
import sys
sys.path.insert(0, {root!r})
from benchmark.tests.conftest import run_tiny
for workload in ('mf-msd.mrr', 'mixture-1e6.mrr', 'mf-msd.train-dense'):
    run_tiny(workload, seconds=0.2, traced=workload == 'mf-msd.mrr')
print(' '.join(sorted({{n.split('.')[0] for n in sys.modules}})))
'''
REFERENCE = '''
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.mf, benchmark.reference.ranks
import benchmark.reference.sequence, benchmark.reference.precision
print(' '.join(sorted({{n.split('.')[0] for n in sys.modules}})))
'''


def _top_level(source):
    done = subprocess.run([sys.executable, '-c',
                           source.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    return set(done.stdout.split())


def test_a_run_loads_no_jax_module():
    loaded = _top_level(RUN)
    assert 'spotlight_tpu_torch' in loaded
    assert not loaded & {'jax', 'jaxlib', 'flax', 'spotlight_tpu'}


def test_the_reference_loads_nothing_of_the_port():
    loaded = _top_level(REFERENCE)
    assert not loaded & {'spotlight_tpu_torch', 'spotlight_tpu', 'jax',
                         'jaxlib', 'flax'}


def test_forbidden_modules_compare_whole_top_level_names():
    from benchmark import harness

    assert harness.forbidden_modules(
        ['spotlight_tpu_torch.evaluation', 'jaxtyping', 'flaxen']) == []
    assert harness.forbidden_modules(
        ['spotlight_tpu.evaluation', 'jax.numpy', 'torch']) == [
            'jax', 'spotlight_tpu']
