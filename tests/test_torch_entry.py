"""The port's single-device entry point against ``__graft_entry__.entry()``.

The JAX forward runs jitted on the CPU; its parameters go through
``params_from_jax`` into the port's ``LSTMNet``, and both forwards must
agree on the same sequences to the sequence slice's tolerance: rtol 1e-5,
atol 1e-6 (float32 sums in another order).
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
