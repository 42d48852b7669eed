"""The port's losses and in-batch weights against the JAX package's.

Each of the seven losses runs on the same seeded numpy predictions in both
packages, with and without a mask and with ``reduce=False``; values and
gradients agree to rtol 1e-6 (float32 elementwise math, summed in another
order).  The in-batch weight table is numpy in both and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spotlight_tpu.ops import losses as jax_losses
from spotlight_tpu.ops import sampling as jax_sampling
from spotlight_tpu_torch.ops import losses, sampling

RTOL, ATOL = 1e-6, 1e-7
IMPLICIT = ('pointwise', 'bpr', 'hinge', 'adaptive_hinge')
EXPLICIT = ('regression', 'poisson', 'logistic')


def inputs(name, rs, batch=64, negatives=3):
    """(first, second, mask) numpy operands for a loss."""
    mask = (rs.rand(batch) > 0.3).astype(np.float32)
    if name in IMPLICIT:
        positive = rs.randn(batch).astype(np.float32)
        shape = (negatives, batch) if name == 'adaptive_hinge' else (batch,)
        return positive, rs.randn(*shape).astype(np.float32), mask
    if name == 'logistic':
        observed = rs.choice([-1.0, 1.0], batch).astype(np.float32)
        return observed, rs.randn(batch).astype(np.float32), mask
    observed = rs.randint(1, 6, batch).astype(np.float32)
    predicted = (np.exp(rs.randn(batch)) if name == 'poisson'
                 else 3 + rs.randn(batch)).astype(np.float32)
    return observed, predicted, mask


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('name', IMPLICIT + EXPLICIT)
def test_loss_values_and_gradients_match_jax(name, masked):
    rs = np.random.RandomState(len(name))
    first, second, mask = inputs(name, rs)
    jax_fn = getattr(jax_losses, name + '_loss')
    port_fn = getattr(losses, name + '_loss')
    jax_mask = jnp.asarray(mask) if masked else None
    port_mask = torch.from_numpy(mask) if masked else None

    want, want_grads = jax.value_and_grad(
        lambda a, b: jax_fn(a, b, mask=jax_mask), argnums=(0, 1))(
            jnp.asarray(first), jnp.asarray(second))
    a = torch.from_numpy(first).requires_grad_()
    b = torch.from_numpy(second).requires_grad_()
    got = port_fn(a, b, mask=port_mask)
    got_grads = torch.autograd.grad(got, (a, b))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    if name in EXPLICIT:
        # Observed ratings are data: their gradient is nobody's.  (The
        # logistic loss clamps them to [0, 1]; at a bound JAX's clip splits
        # the gradient in half, torch's clamp passes it whole.)
        got_grads, want_grads = got_grads[1:], want_grads[1:]
    for got_grad, want_grad in zip(got_grads, want_grads):
        np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('name', IMPLICIT + EXPLICIT)
def test_unreduced_losses_match_jax(name):
    rs = np.random.RandomState(7)
    first, second, mask = inputs(name, rs)
    want = getattr(jax_losses, name + '_loss')(
        jnp.asarray(first), jnp.asarray(second), mask=jnp.asarray(mask),
        reduce=False)
    got = getattr(losses, name + '_loss')(
        torch.from_numpy(first), torch.from_numpy(second),
        mask=torch.from_numpy(mask), reduce=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_all_zero_mask_divides_by_one():
    zeros = torch.zeros(8)
    assert losses.bpr_loss(torch.ones(8), zeros, mask=zeros).item() == 0.0


@pytest.mark.parametrize('padding_idx', [None, 0])
def test_inbatch_weight_table_equals_jax(padding_idx):
    rs = np.random.RandomState(11)
    items = (rs.zipf(1.5, 500) % 40).astype(np.int64)
    want = jax_sampling.inbatch_importance_weight_table(
        items, 40, padding_idx=padding_idx)
    got = sampling.inbatch_importance_weight_table(items, 40,
                                                   padding_idx=padding_idx)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sampling.inbatch_importance_weights(items, 40, padding_idx),
        jax_sampling.inbatch_importance_weights(items, 40, padding_idx))


@pytest.mark.parametrize('num_negatives', [1, 4])
@pytest.mark.parametrize('loss', IMPLICIT)
def test_inbatch_pair_weights_and_elems_match_jax(loss, num_negatives):
    rs = np.random.RandomState(13)
    batch = 32
    weight = rs.rand(batch).astype(np.float32)
    shape = (num_negatives, batch) if num_negatives > 1 else (batch,)
    negative = rs.randn(*shape).astype(np.float32)
    positive = rs.randn(batch).astype(np.float32)
    want_w = jax_sampling.inbatch_pair_weights(
        jnp.asarray(weight), jnp.asarray(negative), num_negatives)
    got_w = sampling.inbatch_pair_weights(
        torch.from_numpy(weight), torch.from_numpy(negative), num_negatives)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))

    if (loss == 'adaptive_hinge') != (num_negatives > 1):
        return
    jax_fn = getattr(jax_losses, loss + '_loss')
    port_fn = getattr(losses, loss + '_loss')
    elems = jax_fn(jnp.asarray(positive), jnp.asarray(negative),
                   reduce=False)
    want = jax_sampling.weighted_inbatch_elems(loss, elems,
                                               jnp.asarray(negative), want_w)
    got = sampling.weighted_inbatch_elems(
        loss, port_fn(torch.from_numpy(positive), torch.from_numpy(negative),
                      reduce=False), torch.from_numpy(negative), got_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_host_and_device_samplers_draw_in_range():
    ids = sampling.sample_items(17, (4, 5), np.random.RandomState(0))
    np.testing.assert_array_equal(
        ids, jax_sampling.sample_items(17, (4, 5), np.random.RandomState(0)))
    generator = torch.Generator().manual_seed(3)
    drawn = sampling.sample_items_device(generator, 17, (3, 100))
    assert drawn.dtype == torch.int64 and drawn.shape == (3, 100)
    assert int(drawn.min()) >= 0 and int(drawn.max()) < 17
    again = sampling.sample_items_device(torch.Generator().manual_seed(3),
                                         17, (3, 100))
    assert torch.equal(drawn, again)
