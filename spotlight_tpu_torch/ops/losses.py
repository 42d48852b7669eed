"""Loss functions for recommender models.

Counterpart of ``spotlight_tpu/ops/losses.py``, as plain functions on
tensors with the same semantics:

- implicit (negative-sampling) losses: ``pointwise``, ``bpr``, ``hinge``,
  ``adaptive_hinge``; each takes positive and negative predictions and an
  optional binary ``mask``, returning ``sum(loss * mask) / max(sum(mask),
  1)`` when masked and the plain mean otherwise;
- explicit losses: ``regression`` (MSE), ``poisson``, ``logistic`` (binary
  cross-entropy with logits on +-1 targets).

``reduce=False`` returns the elementwise loss and ignores the mask: the
training engines reduce it themselves.  ``adaptive_hinge_loss`` takes a
``(num_negatives, ...)`` stack of negative predictions and keeps the
highest per entry (``amax``, whose gradient splits ties evenly, as JAX's
``max`` does).

:func:`sigmoid` differentiates in JAX's order, ``g * (y * (1 - y))``
(torch's own backward rounds ``(g * (1 - y)) * y``), so the gradients
repeat the JAX package's: Adam normalises each gradient, and where one is a
difference of near-equal terms an ulp there moves the step visibly.
"""

from __future__ import annotations

import torch


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.sigmoid(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        y, = ctx.saved_tensors
        return grad * (y * (1 - y))


def sigmoid(x):
    """``torch.sigmoid`` whose gradient is JAX's ``g * (y * (1 - y))``."""
    return _Sigmoid.apply(x)


def _masked_mean(loss, mask, reduce=True):
    if not reduce:
        return loss
    if mask is not None:
        mask = mask.to(loss.dtype)
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()


def pointwise_loss(positive_predictions, negative_predictions, mask=None,
                   reduce=True):
    """Logistic pointwise loss: ``(1 - sigmoid(pos)) + sigmoid(neg)``."""
    positives_loss = 1.0 - sigmoid(positive_predictions)
    negatives_loss = sigmoid(negative_predictions)
    return _masked_mean(positives_loss + negatives_loss, mask, reduce)


def bpr_loss(positive_predictions, negative_predictions, mask=None,
             reduce=True):
    """Bayesian Personalised Ranking: ``1 - sigmoid(pos - neg)``."""
    loss = 1.0 - sigmoid(positive_predictions - negative_predictions)
    return _masked_mean(loss, mask, reduce)


def hinge_loss(positive_predictions, negative_predictions, mask=None,
               reduce=True):
    """Hinge pairwise loss: ``max(neg - pos + 1, 0)``."""
    loss = torch.clamp(negative_predictions - positive_predictions + 1.0,
                       min=0.0)
    return _masked_mean(loss, mask, reduce)


def adaptive_hinge_loss(positive_predictions, negative_predictions,
                        mask=None, reduce=True):
    """Adaptive hinge loss (WARP approximation): the hinge loss against the
    highest-scoring of ``negative_predictions`` (``(num_negatives,) +
    pos.shape``) per entry."""
    highest_negative_predictions = torch.amax(negative_predictions, dim=0)
    return hinge_loss(positive_predictions, highest_negative_predictions,
                      mask=mask, reduce=reduce)


def regression_loss(observed_ratings, predicted_ratings, mask=None,
                    reduce=True):
    """Mean squared error."""
    return _masked_mean((observed_ratings - predicted_ratings) ** 2, mask,
                        reduce)


def poisson_loss(observed_ratings, predicted_ratings, mask=None,
                 reduce=True):
    """Poisson loss: ``mean(pred - observed * log(pred))``; the predictions
    must already be positive."""
    return _masked_mean(predicted_ratings
                        - observed_ratings * torch.log(predicted_ratings),
                        mask, reduce)


def logistic_loss(observed_ratings, predicted_ratings, mask=None,
                  reduce=True):
    """Binary cross-entropy with logits on (-1, 1) targets, clamped to
    (0, 1), in the stable form ``max(x, 0) - x * t + log(1 + exp(-|x|))``.
    """
    targets = torch.clamp(observed_ratings, 0.0, 1.0)
    x = predicted_ratings
    loss = (torch.clamp(x, min=0.0) - x * targets
            + torch.log1p(torch.exp(-torch.abs(x))))
    return _masked_mean(loss, mask, reduce)


IMPLICIT_LOSSES = {
    'pointwise': pointwise_loss,
    'bpr': bpr_loss,
    'hinge': hinge_loss,
    'adaptive_hinge': adaptive_hinge_loss,
}
