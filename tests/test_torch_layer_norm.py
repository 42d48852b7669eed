"""``ops.kernels.layer_norm`` on the CPU: the plain version and its
``autograd.Function`` against ``F.layer_norm``, in values and in the
gradients of the input, the gain and the offset.  The kernel itself runs
only on the card (``-k layer_norm`` in ``tests/test_torch_cuda.py``); its
operand checks are held here on CPU tensors."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from spotlight_tpu_torch.ops.kernels import layer_norm as ln

#: float32 against ``F.layer_norm``: the same function summed in another
#: order, on outputs of order 1 (the gain near 1): a few roundings.
#: float64 agrees to its own rounding.
ATOL = {torch.float32: 2e-5, torch.float64: 1e-12}


def _operands(shape, dtype, seed=0, padding=True, grad=False):
    """Seeded rows of ``shape`` (the last dimension normalised), every
    third of the leading rows zero (SASRec's padding steps) when
    ``padding``, a gain near 1 and an offset near 0."""
    generator = torch.Generator().manual_seed(seed)
    dim = shape[-1]
    x = torch.randn(shape, generator=generator, dtype=dtype)
    if padding:
        x.view(-1, dim)[::3] = 0.0
    weight = 1 + 0.1 * torch.randn(dim, generator=generator, dtype=dtype)
    bias = 0.1 * torch.randn(dim, generator=generator, dtype=dtype)
    return [t.requires_grad_(grad) for t in (x, weight, bias)]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['float32', 'float64'])
@pytest.mark.parametrize('eps', [1e-8, 1e-5])
@pytest.mark.parametrize('dim', [1, 7, 50, 64])
def test_plain_version_matches_functional_layer_norm(dim, eps, dtype):
    x, weight, bias = _operands((8, 30, dim), dtype)
    y, mean, rstd = ln.layer_norm_plain(x, weight, bias, eps)
    torch.testing.assert_close(y, F.layer_norm(x, (dim,), weight, bias, eps),
                               rtol=0, atol=ATOL[dtype])
    torch.testing.assert_close(mean, x.mean(-1), rtol=0, atol=ATOL[dtype])
    var = x.var(-1, unbiased=False)
    torch.testing.assert_close(rstd, torch.rsqrt(var + eps),
                               rtol=ATOL[dtype], atol=0)
    # The wrapper without autograd is the plain version.
    torch.testing.assert_close(ln.layer_norm(x, weight, bias, eps), y,
                               rtol=0, atol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64],
                         ids=['float32', 'float64'])
@pytest.mark.parametrize('eps', [1e-8, 1e-5])
def test_gradients_match_functional_layer_norm_at_d50(eps, dtype):
    """Through the ``autograd.Function`` at SASRec's D=50, padding rows
    included: the gradients of the input, the gain and the offset against
    ``F.layer_norm``'s autograd, as a share of each gradient's largest
    element (a zero row's input gradient is scaled by rsqrt(eps), 1e4 at
    eps 1e-8, in both)."""
    x, weight, bias = _operands((6, 40, 50), dtype, seed=1, grad=True)
    cotangent = torch.randn(6, 40, 50, dtype=dtype,
                            generator=torch.Generator().manual_seed(2))
    y = ln.layer_norm(x, weight, bias, eps)
    assert y.grad_fn is not None and 'LayerNorm' in type(y.grad_fn).__name__
    want_y = F.layer_norm(x, (50,), weight, bias, eps)
    torch.testing.assert_close(y, want_y, rtol=0, atol=ATOL[dtype])
    got = torch.autograd.grad(y, (x, weight, bias), cotangent)
    want = torch.autograd.grad(want_y, (x, weight, bias), cotangent)
    for name, g, w in zip(('x', 'weight', 'bias'), got, want):
        gap = float((g - w).abs().max() / w.abs().max())
        assert gap <= ATOL[dtype], (name, gap)


def test_only_the_inputs_that_need_a_gradient_get_one():
    x, weight, bias = _operands((4, 10, 50), torch.float64, grad=True)
    bias.requires_grad_(False)
    y = ln.layer_norm(x, weight, bias, 1e-8)
    y.sum().backward()
    assert x.grad is not None and weight.grad is not None
    assert bias.grad is None


@pytest.mark.parametrize('eps', [1e-8, 1e-5])
@pytest.mark.parametrize('value', [0.0, 0.75, -2.0])
def test_constant_rows_give_the_offset(value, eps):
    """A row of zeros (a padding step) and a constant row have var = 0:
    the output is the offset.  The constants are dyadic, so their sum and
    mean are exact in float32 and ``x - mean`` is 0 exactly; the mean of
    another constant rounds, and eps 1e-8 scales that rounding by 1e4 in
    every implementation, ``F.layer_norm`` included."""
    _, weight, bias = _operands((3, 50), torch.float32)
    x = torch.full((3, 50), value)
    y = ln.layer_norm(x, weight, bias, eps)
    assert torch.equal(y, bias.expand_as(y))
    assert torch.equal(F.layer_norm(x, (50,), weight, bias, eps), y)


def test_the_card_takes_float32_and_float64_rows_up_to_1024():
    """The kernel's limits, checked before any launch (on CPU tensors
    here; the card tests see the same errors from the wrapper)."""
    for dtype in ln.DTYPES:
        x, weight, bias = _operands((2, ln.MAX_DIM), dtype)
        ln._check_card_operands(x, weight, bias)
    x, weight, bias = _operands((2, ln.MAX_DIM + 1), torch.float32)
    with pytest.raises(ValueError, match='at most 1024'):
        ln._check_card_operands(x, weight, bias)
    x, weight, bias = (t.to(torch.bfloat16)
                       for t in _operands((2, 50), torch.float32))
    with pytest.raises(ValueError, match='float32 or float64'):
        ln._check_card_operands(x, weight, bias)
    x, weight, bias = _operands((2, 50), torch.float32)
    with pytest.raises(ValueError, match='weight must be'):
        ln._check_card_operands(x, weight[:49], bias)


def test_the_cpu_launches_nothing():
    before = ln.LAYER_NORM_LAUNCHES
    x, weight, bias = _operands((4, 50), torch.float32)
    ln.layer_norm(x, weight, bias, 1e-8)
    assert ln.LAYER_NORM_LAUNCHES == before
