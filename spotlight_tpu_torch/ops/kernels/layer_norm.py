"""LayerNorm over the last dimension, for SASRec's narrow rows.

The port's own: the JAX package has no LayerNorm, and
:class:`~spotlight_tpu_torch.sequence.representations.SelfAttentionNet`
(SASRec) has no JAX counterpart.  :func:`layer_norm` normalises each row of
``x`` (..., D) by its mean and centred variance and applies the gain and
offset::

    mean = sum(x) / D;  var = sum((x - mean)^2) / D
    y = (x - mean) * rsqrt(var + eps) * gain + offset

On a CUDA tensor the forward launches ``layer_norm_warp``
(``csrc/layer_norm.cu``: one warp a row, the row loaded once into
registers, written once), float32 or float64 with ``D`` up to
:data:`MAX_DIM`; any other dtype or a wider row raises.  On a CPU tensor it
runs :func:`layer_norm_plain`, the same arithmetic written out.  The two
sum in other orders, so they agree to rounding, not bit for bit.  Nothing
falls back.

The backward is :func:`layer_norm_backward_plain`, plain PyTorch on either
device from the mean and the reciprocal deviation that the forward saved;
under ``torch.no_grad`` (the scoring paths) the forward writes only ``y``.
"""

from __future__ import annotations

import torch

from spotlight_tpu_torch.ops.kernels import _build
from spotlight_tpu_torch.ops.kernels.ranking import (_sm_count, on_cuda,
                                                     stream_handle)

#: Launches of ``layer_norm_warp`` made by :func:`layer_norm`.
LAYER_NORM_LAUNCHES = 0
#: The widest row the kernel takes (32 values a lane).
MAX_DIM = 1024
#: The dtypes the kernel takes.
DTYPES = (torch.float32, torch.float64)


def layer_norm_plain(x, weight, bias, eps):
    """Plain PyTorch version of the forward: ``(y, mean, rstd)``, ``mean``
    and ``rstd`` of shape ``x.shape[:-1]``."""
    # D as a tensor on x's device: torch divides a CUDA tensor by a Python
    # number as a product with its reciprocal, one rounding more than the
    # kernel's quotient (a constant row's mean would then miss the row by
    # that rounding, which rsqrt(eps) scales up to 1e-3).
    dim = x.new_tensor(x.shape[-1])
    mean = x.sum(-1, keepdim=True) / dim
    centred = x - mean
    rstd = torch.rsqrt((centred * centred).sum(-1, keepdim=True) / dim + eps)
    return centred * rstd * weight + bias, mean[..., 0], rstd[..., 0]


def layer_norm_backward_plain(grad, x, weight, mean, rstd, needs):
    """Gradients of ``x``, ``weight`` and ``bias`` (None where ``needs``, three
    flags, says no) from the forward's ``mean`` and ``rstd``."""
    dim = x.shape[-1]
    rstd = rstd[..., None]
    normed = (x - mean[..., None]) * rstd
    dx = dweight = dbias = None
    if needs[0]:
        scaled = grad * weight
        dx = rstd * (scaled - scaled.sum(-1, keepdim=True) / dim
                     - normed * (scaled * normed).sum(-1, keepdim=True)
                     / dim)
    if needs[1]:
        dweight = (grad * normed).reshape(-1, dim).sum(0)
    if needs[2]:
        dbias = grad.reshape(-1, dim).sum(0)
    return dx, dweight, dbias


def _check_card_operands(x, weight, bias):
    dim = x.shape[-1]
    if x.dtype not in DTYPES:
        raise ValueError('layer_norm takes float32 or float64 rows on the '
                         'card (the dtypes the kernel is built for); got {}'
                         .format(x.dtype))
    if dim > MAX_DIM:
        raise ValueError('layer_norm takes rows of at most {} values on the '
                         'card (32 a lane of one warp); got {}'
                         .format(MAX_DIM, dim))
    for name, param in (('weight', weight), ('bias', bias)):
        if param.shape != (dim,) or param.dtype != x.dtype:
            raise ValueError('{} must be ({},) {}, as the rows'
                             .format(name, dim, x.dtype))


def _forward(x, weight, bias, eps, stats):
    """``(y, mean, rstd)``; on the card ``mean`` and ``rstd`` are written
    only when ``stats``."""
    if not on_cuda(x, weight, bias):
        return layer_norm_plain(x, weight, bias, eps)
    global LAYER_NORM_LAUNCHES
    _check_card_operands(x, weight, bias)
    x, weight, bias = x.contiguous(), weight.contiguous(), bias.contiguous()
    y = torch.empty_like(x)
    mean = rstd = None
    if stats:
        mean = x.new_empty(x.shape[:-1])
        rstd = x.new_empty(x.shape[:-1])
    rows = x.numel() // max(x.shape[-1], 1)
    if rows == 0:
        return y, mean, rstd
    status = _build.load('layer_norm').spotlight_layer_norm(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        None if mean is None else mean.data_ptr(),
        None if rstd is None else rstd.data_ptr(), rows, x.shape[-1],
        float(eps), int(x.dtype == torch.float64), _sm_count(x.device),
        stream_handle(x.device))
    _build.check(status, 'layer_norm kernel')
    LAYER_NORM_LAUNCHES += 1
    return y, mean, rstd


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mean, rstd = _forward(x, weight, bias, eps, stats=True)
        ctx.save_for_backward(x, weight, mean, rstd)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, weight, mean, rstd = ctx.saved_tensors
        return (*layer_norm_backward_plain(grad, x, weight, mean, rstd,
                                           ctx.needs_input_grad[:3]), None)


def layer_norm(x, weight, bias, eps):
    """LayerNorm of ``x`` (..., D) over its last dimension with ``weight``
    (gain) and ``bias`` (offset) of shape (D,): ``F.layer_norm(x, (D,),
    weight, bias, eps)``, differentiable in all three."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, weight, bias, eps)
    return _forward(x, weight, bias, eps, stats=False)[0]
