"""Training machinery shared by the estimators.

Counterpart of ``spotlight_tpu/utils/training.py`` on one device.  The JAX
package runs a jitted epoch: an on-device shuffle and a ``lax.scan`` over
minibatches, with one loss readback per epoch.  The port keeps that shape
without ``jit``:

- the dataset is padded to a whole number of batches and placed on the
  device once a ``fit``;
- each epoch draws its permutation and all of its negatives from the
  estimator's CPU ``torch.Generator`` (:func:`epoch_draws`) and moves them
  to the device in one copy, so the same seed gives the same stream on the
  CPU and on the card;
- the steps (:func:`run_epoch`) take the batch, its validity mask and its
  negatives as arguments and never read a value back to the host; the
  epoch loss is read one epoch late (:class:`EpochLossDrain`).

The default optimizer (:class:`Adam`) is optax's
``chain(add_decayed_weights(l2), adam(lr))``, the reference's coupled weight
decay, in optax's order of operations.
"""

from __future__ import annotations

import numpy as np
import torch

from spotlight_tpu_torch.ops.sampling import sample_items_device

#: Adam's defaults, optax's and the JAX package's (both engines).
B1, B2, EPS = 0.9, 0.999, 1e-8


def bias_correction(decay, t):
    """``1 - decay ** t`` in float32, equal to JAX's jitted value: numpy's
    scalar power of float32 operands (a float64 power rounded to float32
    differs, as does numpy's vectorised power)."""
    f32 = np.float32
    return f32(1) - f32(decay) ** f32(t)


def generator_from_random_state(random_state):
    """A ``torch.Generator`` seeded from a numpy RandomState.

    Counterpart of ``key_from_random_state``: one ``randint(0, 2**31 - 1)``
    draw seeds the generator, so the caller's RandomState advances exactly
    as it does in the JAX package.  The generator lives on the CPU;
    parameters, permutations and negatives are drawn there and then moved to
    their device, so the same seed gives the same values on every device.
    """
    generator = torch.Generator()
    generator.manual_seed(int(random_state.randint(0, 2 ** 31 - 1)))
    return generator


def pad_to_batches(n, batch_size):
    """Return (padded_length, num_batches) for a dataset of ``n`` rows."""
    num_batches = -(-n // batch_size)
    return num_batches * batch_size, num_batches


def pad_array(array, padded_length):
    """Pad the leading axis with zeros up to ``padded_length``."""
    pad = padded_length - array.shape[0]
    if pad == 0:
        return array
    pad_width = [(0, pad)] + [(0, 0)] * (array.ndim - 1)
    return np.pad(array, pad_width)


class Adam:
    """Adam with coupled ``l2`` weight decay, in optax's order.

    For each parameter ``p`` with gradient ``g``, each operation rounded in
    ``p``'s dtype (the constants too, as JAX's weak typing has it)::

        g = g + l2 * p                       (only when l2 != 0)
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        u = (mu / bc1) / (sqrt(nu / bc2) + eps) * -lr
        p = p + u

    with ``bc = 1 - b ** count`` (:func:`bias_correction`).  This is not
    ``torch.optim.Adam``, whose ``sqrt(v) / sqrt(bc2) + eps`` rounds
    otherwise.  The state is ``{'count': int, 'mu': {name: tensor},
    'nu': {name: tensor}}``, the moments in each parameter's dtype.
    """

    def __init__(self, learning_rate, l2=0.0, b1=B1, b2=B2, eps=EPS):
        self.learning_rate = learning_rate
        self.l2 = l2
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {'count': 0,
                'mu': {name: torch.zeros_like(p) for name, p in
                       params.items()},
                'nu': {name: torch.zeros_like(p) for name, p in
                       params.items()}}

    @torch.no_grad()
    def update(self, params, grads, state):
        """One step, in place on ``params`` and ``state``."""
        state['count'] += 1
        f32 = np.float32
        host = {'l2': f32(self.l2), 'omb1': f32(1 - self.b1),
                'b1': f32(self.b1), 'omb2': f32(1 - self.b2),
                'b2': f32(self.b2), 'eps': f32(self.eps),
                'neg_lr': f32(-self.learning_rate),
                'bc1': bias_correction(self.b1, state['count']),
                'bc2': bias_correction(self.b2, state['count'])}
        for name, p in params.items():
            # 0-d CPU tensors, which a CUDA kernel takes by value (no copy),
            # rounded to the parameter's dtype as JAX's weak typing rounds.
            # The divisors are filled on the device (no copy either):
            # PyTorch's CUDA division by a CPU scalar multiplies by its
            # reciprocal instead.
            c = {key: torch.tensor(value).to(p.dtype)
                 for key, value in host.items()}
            for key in ('bc1', 'bc2'):
                c[key] = torch.full((), float(c[key]), dtype=p.dtype,
                                    device=p.device)
            g = grads[name]
            if self.l2:
                g = g + c['l2'] * p
            mu = c['omb1'] * g + c['b1'] * state['mu'][name]
            nu = c['omb2'] * (g * g) + c['b2'] * state['nu'][name]
            update = ((mu / c['bc1']) / (torch.sqrt(nu / c['bc2']) + c['eps'])
                      * c['neg_lr'])
            p.copy_(p + update)
            state['mu'][name].copy_(mu)
            state['nu'][name].copy_(nu)


def make_optimizer(learning_rate, l2, optimizer_func=None):
    """The dense engine's optimizer: :class:`Adam`, or what the zero-argument
    ``optimizer_func`` returns (an object with :class:`Adam`'s ``init`` and
    ``update``; it overrides ``learning_rate`` and ``l2``)."""
    if optimizer_func is not None:
        try:
            return optimizer_func()
        except TypeError as error:
            raise TypeError(
                'optimizer_func must be a zero-argument callable returning '
                'an optimizer with init(params) and update(params, grads, '
                'state) (unlike the torch reference, it does not receive '
                'parameters): {}'.format(error)) from error
    return Adam(learning_rate, l2)


def epoch_draws(generator, padded_length, negatives_shape=None,
                num_items=None, device='cpu'):
    """One epoch's random draws from ``generator`` (on the CPU), moved to
    ``device`` in one copy: the permutation of the padded rows and, with
    ``negatives_shape`` (``(num_batches, n_neg, batch_size)``), uniform item
    ids in ``[0, num_items)``.  Returns ``(perm, negatives or None)``."""
    perm = torch.randperm(padded_length, generator=generator)
    if not negatives_shape:
        return perm.to(device), None
    negatives = sample_items_device(generator, num_items, negatives_shape)
    both = torch.cat([perm, negatives.reshape(-1)]).to(device)
    return both[:padded_length], both[padded_length:].reshape(
        negatives_shape)


def shuffle_and_batch(perm, data, n_valid, num_batches, batch_size):
    """The shuffled ``data`` as ``(num_batches, batch_size, ...)`` with a
    ``'mask'`` entry: the row-validity mask is derived from the permutation
    itself (``perm < n_valid``; rows past ``n_valid`` are padding)."""
    batched = {name: value[perm].reshape((num_batches, batch_size)
                                         + tuple(value.shape[1:]))
               for name, value in data.items()}
    batched['mask'] = (perm < n_valid).to(torch.float32).reshape(
        num_batches, batch_size)
    return batched


def run_epoch(step, data, n_valid, num_batches, batch_size, perm,
              negatives=None):
    """One epoch: ``step(batch, negatives_b)`` over the shuffled batches.
    Returns the mean batch loss as a device scalar (nothing is read back).
    """
    batched = shuffle_and_batch(perm, data, n_valid, num_batches, batch_size)
    losses = []
    for b in range(num_batches):
        batch = {name: value[b] for name, value in batched.items()}
        losses.append(step(batch, None if negatives is None
                           else negatives[b]))
    return torch.stack(losses).mean()


def masked_mean(elems, mask):
    """``sum(elems * mask) / max(sum(mask), 1)``."""
    mask = mask.to(elems.dtype)
    return (elems * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def build_dense_step(net, elems_fn, optimizer):
    """The dense engine's step, ``step(opt_state, batch, negatives) ->
    loss`` (a device scalar): autograd through the whole network, then
    ``optimizer.update`` over every parameter (whole tables), in place.
    ``elems_fn(batch, negatives) -> (elementwise loss, mask)``.  A
    parameter the loss does not reach gets a zero gradient, as JAX's
    ``grad`` gives it."""
    def step(opt_state, batch, negatives):
        params = dict(net.named_parameters())
        elems, mask = elems_fn(batch, negatives)
        loss = masked_mean(elems, mask)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {name: torch.zeros_like(p) if g is None else g
                 for (name, p), g in zip(params.items(), grads)}
        optimizer.update(params, grads, opt_state)
        return loss.detach()

    return step


def place_data(arrays, device):
    """The epoch data on ``device``: integer columns as int64, floating
    columns as float32."""
    placed = {}
    for name, value in arrays.items():
        value = np.asarray(value)
        dtype = (torch.float32 if np.issubdtype(value.dtype, np.floating)
                 else torch.int64)
        placed[name] = torch.as_tensor(value).to(device=device, dtype=dtype)
    return placed


class EpochLossDrain:
    """Depth-1 pipelined epoch-loss readback.

    Each epoch's device loss is held until the next epoch has been
    dispatched, so the readback overlaps device work.  The degenerate-loss
    guard still raises inside ``fit`` with the offending epoch's loss, at
    most one extra epoch of device work later.
    """

    def __init__(self, verbose=False):
        self._verbose = verbose
        self._pending = None
        self.last_loss = None

    def _drain(self):
        epoch_num, device_loss = self._pending
        self._pending = None
        epoch_loss = float(device_loss)
        self.last_loss = epoch_loss
        if self._verbose:
            print('Epoch {}: loss {}'.format(epoch_num, epoch_loss))
        check_degenerate(epoch_loss)

    def push(self, epoch_num, device_loss):
        """Register this epoch's (device) loss; reads back and checks the
        previous epoch's."""
        if self._pending is not None:
            self._drain()
        self._pending = (epoch_num, device_loss)

    def finish(self):
        if self._pending is not None:
            self._drain()


def check_degenerate(epoch_loss):
    """Raise on a non-finite (NaN or inf) or exactly-zero epoch loss."""
    if not np.isfinite(epoch_loss) or epoch_loss == 0.0:
        raise ValueError('Degenerate epoch loss: {}'.format(epoch_loss))
