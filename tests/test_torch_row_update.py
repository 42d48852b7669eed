"""P1, the row-Adam update, against the JAX package on the CPU.

The plain version of the port's kernel (``ops/kernels/row_update.py``) and
the port's ``sparse_adam_rows`` run on the same numpy inputs as JAX's
``sparse_adam_rows``.  The moments must be equal bit for bit: both packages
sum each row's occurrence gradients in ascending sorted order from +0.0,
round every Python constant to float32 once and evaluate every expression
in the same order.  The parameters are held to atol 1e-6: XLA's CPU float32
``sqrt`` is not correctly rounded, the port's plain version takes the root
in float64 and rounds once (as the kernel's ``__fsqrt_rn``), so
``m_hat / sqrt(v_hat)`` can differ by an ulp.  The probe's Pallas kernel (``scripts/
fused_rowupdate_probe.py``, interpret mode) is held the same way.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.ops.lazy_adam import sparse_adam_rows as jax_sparse_adam
from spotlight_tpu_torch.ops.kernels import row_update
from spotlight_tpu_torch.ops.lazy_adam import lazy_adam_init, sparse_adam_rows
from spotlight_tpu_torch.utils.training import bias_correction

PROBE = (pathlib.Path(__file__).resolve().parents[1] / 'scripts'
         / 'fused_rowupdate_probe.py')
PARAM_ATOL = 1e-6


def probe_module():
    spec = importlib.util.spec_from_file_location('fused_rowupdate_probe',
                                                  PROBE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def operands(rs, num_rows, width, n, *, sentinel=False, negative_zero=False,
             warm=True):
    """(ids, param, mu, nu, grads) as numpy: ids with repeats (row 3
    named five times), warm moments unless ``warm`` is False."""
    ids = rs.randint(0, num_rows, n).astype(np.int32)
    ids[:5] = 3
    if sentinel:
        ids[-3:] = num_rows
    param = rs.randn(num_rows, width).astype(np.float32)
    mu = (0.01 * rs.randn(num_rows, width)).astype(np.float32) if warm else (
        np.zeros((num_rows, width), np.float32))
    nu = (1e-4 * rs.rand(num_rows, width)).astype(np.float32) if warm else (
        np.zeros((num_rows, width), np.float32))
    grads = (0.1 * rs.randn(n, width)).astype(np.float32)
    if negative_zero:
        grads[:5] = -0.0
    return ids, param, mu, nu, grads


def jax_update(ids, param, mu, nu, grads, t, lr, l2, table_dtype):
    out = jax_sparse_adam(jnp.asarray(ids), jnp.asarray(param, table_dtype),
                          jnp.asarray(mu), jnp.asarray(nu),
                          jnp.asarray(grads), jnp.int32(t), lr, l2)
    return [np.asarray(x.astype(jnp.float32)) for x in out]


def port_update(ids, param, mu, nu, grads, t, lr, l2, table_dtype):
    p = torch.from_numpy(param.copy()).to(table_dtype)
    m = torch.from_numpy(mu.copy())
    v = torch.from_numpy(nu.copy())
    out = sparse_adam_rows(torch.from_numpy(ids), p, m, v,
                           torch.from_numpy(grads), t, lr, l2)
    assert out[0] is p and out[1] is m and out[2] is v
    return [x.float().numpy() for x in out]


def assert_update_matches(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize('table', ['float32', 'bfloat16'])
@pytest.mark.parametrize('l2', [0.0, 1e-6])
@pytest.mark.parametrize('t', [1, 5, 1000])
def test_sparse_adam_rows_matches_jax(table, l2, t):
    rs = np.random.RandomState(t)
    ids, param, mu, nu, grads = operands(rs, 40, 9, 64)
    torch_dtype = getattr(torch, table)
    jax_dtype = getattr(jnp, table)
    if table == 'bfloat16':
        # Both packages start from the same bfloat16 table.
        param = torch.from_numpy(param).to(torch.bfloat16).float().numpy()
    want = jax_update(ids, param, mu, nu, grads, t, 1e-2, l2, jax_dtype)
    got = port_update(ids, param, mu, nu, grads, t, 1e-2, l2, torch_dtype)
    assert_update_matches(got, want)
    untouched = np.setdiff1d(np.arange(40), ids)
    np.testing.assert_array_equal(got[0][untouched], param[untouched])
    np.testing.assert_array_equal(got[1][untouched], mu[untouched])


def test_negative_zero_gradients_sum_from_positive_zero():
    """A row whose occurrence gradients are all -0.0 sums to +0.0, as JAX's
    segment_sum does: seen through a first moment of -0.0, which
    ``0.9 * -0.0 + 0.1 * g`` keeps at -0.0 only if ``g`` is -0.0."""
    rs = np.random.RandomState(3)
    ids, param, mu, nu, grads = operands(rs, 30, 7, 40, negative_zero=True,
                                         warm=False)
    ids[5:] = np.where(ids[5:] == 3, 4, ids[5:])
    mu[3] = -0.0
    want = jax_update(ids, param, mu, nu, grads, 1, 1e-2, 0.0, jnp.float32)
    got = port_update(ids, param, mu, nu, grads, 1, 1e-2, 0.0, torch.float32)
    assert_update_matches(got, want)
    assert not np.signbit(want[1][3]).any()
    assert not np.signbit(got[1][3]).any()


def test_sentinel_id_updates_nothing():
    """An id equal to the row count (the JAX mesh engine's "not mine"
    sentinel) drops its gradient in both packages."""
    rs = np.random.RandomState(4)
    ids, param, mu, nu, grads = operands(rs, 25, 6, 48, sentinel=True)
    want = jax_update(ids, param, mu, nu, grads, 3, 1e-2, 1e-6, jnp.float32)
    got = port_update(ids, param, mu, nu, grads, 3, 1e-2, 1e-6,
                      torch.float32)
    assert_update_matches(got, want)


def test_negative_id_updates_nothing_unlike_jax():
    """The deliberate difference (ROADMAP.md, Queue 3): an id outside
    [0, R) updates nothing in the port; JAX wraps -1 onto row R - 1.  No
    engine produces a negative id."""
    rs = np.random.RandomState(5)
    ids, param, mu, nu, grads = operands(rs, 20, 4, 16)
    ids = np.where(ids == 19, 18, ids)
    ids[-1] = -1
    got = port_update(ids, param, mu, nu, grads, 2, 1e-2, 0.0, torch.float32)
    np.testing.assert_array_equal(got[0][19], param[19])
    np.testing.assert_array_equal(got[1][19], mu[19])
    want = jax_update(ids, param, mu, nu, grads, 2, 1e-2, 0.0, jnp.float32)
    assert not np.array_equal(want[1][19], mu[19])
    keep = np.arange(19)
    np.testing.assert_array_equal(got[1][keep], want[1][keep])


def test_matches_the_probe_kernel_in_interpret_mode():
    """The probe's Pallas kernel (unique ids, pre-summed by its
    ``dedup_sum``, W=128, t=5, lr=1e-2) against the plain P1 on the same
    unique rows, and the port's ``sparse_adam_rows`` on the occurrences."""
    probe = probe_module()
    rs = np.random.RandomState(0)
    num_rows, width, n = 200, 128, 96
    padded_rows = num_rows + 8
    param = rs.randn(padded_rows, width).astype(np.float32)
    occ_ids = rs.randint(0, num_rows, n).astype(np.int32)
    occ_grads = (rs.randn(n, width) * 1e-2).astype(np.float32)
    zeros = np.zeros((padded_rows, width), np.float32)

    uids, summed = probe.dedup_sum(jnp.asarray(occ_ids),
                                   jnp.asarray(occ_grads), padded_rows - 1)
    want = [np.asarray(x) for x in probe.fused_row_update(
        uids, jnp.asarray(param), jnp.asarray(zeros), jnp.asarray(zeros),
        summed, t=5, interpret=True)]

    # The probe's own form: unique rows, pre-summed, one occurrence each.
    uids = np.array(uids)
    unique = torch.from_numpy(uids)
    segments = row_update.Segments(
        torch.arange(len(uids), dtype=torch.int32),
        torch.arange(len(uids) + 1, dtype=torch.int32), unique,
        torch.tensor(len(uids), dtype=torch.int32))
    p = torch.from_numpy(param.copy())
    m = torch.zeros(padded_rows, width)
    v = torch.zeros(padded_rows, width)
    row_update.row_adam(p, m, v, torch.from_numpy(np.asarray(summed)),
                        segments, row_update.adam_scalars(5, 1e-2))
    real = np.arange(num_rows)
    np.testing.assert_array_equal(m.numpy()[real], want[1][real])
    np.testing.assert_array_equal(v.numpy()[real], want[2][real])
    np.testing.assert_allclose(p.numpy()[real], want[0][real], rtol=0,
                               atol=PARAM_ATOL)

    got = port_update(occ_ids, param, zeros, zeros, occ_grads, 5, 1e-2, 0.0,
                      torch.float32)
    np.testing.assert_array_equal(got[1][real], want[1][real])
    np.testing.assert_allclose(got[0][real], want[0][real], rtol=0,
                               atol=PARAM_ATOL)


def test_bias_corrections_equal_jax_for_the_first_two_thousand_steps():
    steps = np.arange(1, 2001, dtype=np.int32)
    jitted = jax.jit(lambda t: (1 - 0.9 ** t, 1 - 0.999 ** t))
    want1, want2 = (np.asarray(x) for x in jitted(jnp.asarray(steps)))
    got1 = np.array([bias_correction(0.9, t) for t in steps])
    got2 = np.array([bias_correction(0.999, t) for t in steps])
    assert got1.dtype == np.float32
    np.testing.assert_array_equal(got1, want1)
    np.testing.assert_array_equal(got2, want2)


def test_segments_group_occurrences_without_host_values():
    ids = torch.tensor([[5, 2, 5], [7, 2, 5]])
    segments = row_update.prepare_segments(ids)
    assert all(x.dtype == torch.int32 for x in segments)
    assert segments.count.dim() == 0 and int(segments.count) == 3
    assert segments.order.tolist() == [1, 4, 0, 2, 5, 3]
    assert segments.offsets.tolist()[:4] == [0, 2, 5, 6]
    assert segments.offsets.tolist()[4:] == [6, 6, 6]
    assert segments.rows.tolist()[:3] == [2, 5, 7]
    empty = row_update.prepare_segments(torch.zeros(0, dtype=torch.int64))
    assert int(empty.count) == 0 and empty.offsets.tolist() == [0]


def test_lazy_adam_init_keeps_float32_moments():
    params = {'w': torch.zeros(3, 4, dtype=torch.bfloat16)}
    state = lazy_adam_init(params)
    assert state['t'] == 0
    assert state['mu']['w'].dtype == torch.float32
    assert state['nu']['w'].shape == (3, 4)


def test_operand_checks():
    param = torch.zeros(4, 3)
    segments = row_update.prepare_segments(torch.tensor([1, 2]))
    scalars = row_update.adam_scalars(1, 1e-2)
    with pytest.raises(ValueError, match='grads'):
        row_update.row_adam(param, torch.zeros(4, 3), torch.zeros(4, 3),
                            torch.zeros(3, 3), segments, scalars)
    with pytest.raises(ValueError, match='mu'):
        row_update.row_adam(param, torch.zeros(4, 3, dtype=torch.bfloat16),
                            torch.zeros(4, 3), torch.zeros(2, 3), segments,
                            scalars)
