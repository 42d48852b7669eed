"""The port's entry points against ``__graft_entry__.py``'s.

``entry()``: the JAX forward runs jitted on the CPU; its parameters go
through ``params_from_jax`` into the port's ``LSTMNet``, and both forwards
must agree on the same sequences to the sequence slice's tolerance: rtol
1e-5, atol 1e-6 (float32 sums in another order).  ``dryrun_multichip``:
the command line's dry run on four gloo CPU ranks prints
``dryrun_multichip OK``.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from spotlight_tpu_torch.entry import entry
from spotlight_tpu_torch.sequence import LSTMNet
from spotlight_tpu_torch.utils.convert import params_from_jax

RTOL, ATOL = 1e-5, 1e-6


def test_entry_matches_jax():
    jax_fn, (params, jax_sequences) = __graft_entry__.entry()
    want = jax.jit(jax_fn)(params, jax_sequences)

    fn, (net, sequences) = entry(device='cpu')
    assert isinstance(net, LSTMNet)
    assert (net.num_items, net.embedding_dim) == (2048, 64)
    np.testing.assert_array_equal(sequences.numpy(),
                                  np.asarray(jax_sequences))
    net.load_state_dict(params_from_jax(
        net, jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = fn(net, sequences)
    for port_out, jax_out, shape in zip(got, want, ((128, 64), (128, 2048))):
        assert port_out.shape == shape and port_out.dtype == torch.float32
        np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out),
                                   rtol=RTOL, atol=ATOL)


def test_entry_is_seeded():
    (_, (a, seq_a)), (_, (b, seq_b)) = entry('cpu'), entry('cpu')
    assert torch.equal(seq_a, seq_b)
    for name, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[name]), name


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        entry()


def test_dryrun_multichip_on_four_cpu_ranks():
    """``python -m spotlight_tpu_torch.entry 4 --cpu``: four gloo ranks
    joined through ``multihost.initialize`` run every distributed path of
    ``__graft_entry__.dryrun_multichip`` at 2 x 2."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    done = subprocess.run(
        [sys.executable, '-m', 'spotlight_tpu_torch.entry', '4', '--cpu'],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.splitlines()[-1] == 'dryrun_multichip OK'


def test_dryrun_multichip_needs_its_process_group():
    from spotlight_tpu_torch.entry import dryrun_multichip

    with pytest.raises(RuntimeError, match='process group of 4 ranks'):
        dryrun_multichip(4, device='cpu')
