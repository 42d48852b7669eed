"""``model.fit(interactions)``: each call is one whole fit of one epoch
(``n_iter=1``) over the configuration's fit interactions, on one model that
keeps training from call to call.

Set-up builds that model around seeded initial weights and drives it
through its first ``check_steps`` steps, in two ``fit`` calls on pairs
that all differ, through the same call and feed as the window
(:func:`check_fits`): one of a single batch, then one of the steps left
whose rows end as the window's fits end, short of a whole batch, so that
its epoch draws spread padding rows over its batches, under the mask.  The
reference follows those steps from the same weights, with the draws the
port's estimator makes worked out again, and three numbers compare them,
each by the worst of Spotlight's parameter groups (leaves):

- ``loss_gap``: each fit's loss as the port reports it (the mean of its
  steps' losses), relative to the reference's;
- ``grad_gap``: the first gradient's norm, as the port's Adam got it (from
  its first moments after one step);
- ``change_gap``: the norm of the parameters' change after the steps.

A leaf's gap is the distance between the port's norm and the reference's
over the larger of that leaf's reference norm and the median leaf's.
Leaves whose reference gradient is nought to rounding (under a thousandth
of the median leaf's: the user biases, which BPR's difference of scores
cancels) move by round-off alone and are left out of both.
"""

from __future__ import annotations

import contextlib
import io
import re
import statistics

import numpy as np
import torch

#: A leaf counts when its reference gradient norm is at least this share
#: of the median leaf's.
COUNTED = 1e-3
_LOSS = re.compile(r'Epoch 0: loss (\S+)')


def _fit_one(model, interactions):
    """One ``fit``, its loss read from the port's verbose line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model.fit(interactions, verbose=True)
    found = _LOSS.findall(out.getvalue())
    if len(found) != 1:
        raise RuntimeError('fit printed {!r}'.format(out.getvalue()))
    return float(found[0])


def _norms(tables, dim, family):
    return {name: float(leaf.double().norm())
            for name, leaf in family.leaves(tables, dim).items()}


def check_fits(cfg, steps):
    """Pairs of each check fit: one batch, then ``steps - 1`` batches
    short of whole by as many pairs as each window fit is (its pairs past
    whole batches are ``fit_interactions`` modulo the batch)."""
    batch = cfg['batch_size']
    tail = cfg['fit_interactions'] % batch or batch
    return [batch, (steps - 2) * batch + tail]


def setup(run):
    family, cfg = run.family, run.cfg
    state = family.training(run)
    model = state.model
    rows, start = [], 0
    for size in check_fits(cfg, run.traffic['check_steps']):
        rows.append((state.users[start:start + size],
                     state.items[start:start + size]))
        start += size
    state.rows = rows
    state.losses, state.grad_norms = [], None
    for s, (users, items) in enumerate(rows):
        state.losses.append(_fit_one(model, family.interactions(
            cfg, users, items)))
        if s == 0:
            state.grad_norms = _norms(family.program_first_grads(model),
                                      cfg['embedding_dim'], family)
    initial = family.initial_tables(run)
    state.change_norms = _norms(
        [p - p0 for p, p0 in zip(family.program_tables(model), initial)],
        cfg['embedding_dim'], family)
    del initial
    return state


def call(run, state, index):
    state.model.fit(state.fit)
    cfg = run.cfg
    n = len(state.users)
    params = sum(p.numel() for p in state.model._net.parameters())
    return {'work': n, 'steps': -(-n // cfg['batch_size']),
            'batch': cfg['batch_size'], 'dim': cfg['embedding_dim'],
            'num_params': params}


def counters(run, state):
    return {}


def release(run, state):
    state.model = None
    state.fit = None


def _leaf_gap(program, reference, counted):
    median = statistics.median(reference[name] for name in reference)
    return max((abs(program[name] - reference[name])
                / max(reference[name], median)
                for name in counted), default=float('nan'))


def readings(run, state, losses, grad_norms, change_norms):
    """The three numbers of answers (each fit's loss, first gradient norms
    and change norms by leaf) against the float32 reference."""
    family, cfg = run.family, run.cfg
    batches, fits = family.step_batches(run, state.rows,
                                        family.model_seed(run.seed))
    step_losses, first, tables = family.reference_steps(run, batches)
    ref_losses = _fit_losses(step_losses, fits)
    dim = cfg['embedding_dim']
    ref_grads = _norms(first, dim, family)
    median = statistics.median(ref_grads.values())
    counted = [name for name, norm in ref_grads.items()
               if norm >= COUNTED * median]
    initial = family.initial_tables(run)
    ref_change = _norms([t - t0 for t, t0 in zip(tables, initial)], dim,
                        family)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    return {'loss_gap': loss_gap if np.isfinite(loss_gap) else 1e30,
            'grad_gap': _leaf_gap(grad_norms, ref_grads, counted),
            'change_gap': _leaf_gap(change_norms, ref_change, counted)}


def _fit_losses(step_losses, fits):
    """Each fit's loss from its steps' (``fits`` steps a fit)."""
    out, start = [], 0
    for steps in fits:
        out.append(statistics.fmean(step_losses[start:start + steps]))
        start += steps
    return out


def verify(run, state):
    return readings(run, state, state.losses, state.grad_norms,
                    state.change_norms)


def control(run, state, precision):
    """The readings of the reference put in the port's place, in bfloat16
    (``precision`` 'bfloat16'), or with half of each batch left out and the
    mean taken over the rest (``precision`` 'half_batch')."""
    family, cfg = run.family, run.cfg
    batches, fits = family.step_batches(run, state.rows,
                                        family.model_seed(run.seed))
    if precision == 'bfloat16':
        losses, first, tables = family.reference_steps(
            run, batches, dtype=torch.bfloat16)
    elif precision == 'half_batch':
        n = cfg['batch_size']
        keep = torch.arange(n, device=run.device) < n // 2
        losses, first, tables = family.reference_steps(run, batches,
                                                       keep=keep)
    else:
        raise ValueError('unknown control {!r}'.format(precision))
    dim = cfg['embedding_dim']
    initial = family.initial_tables(run)
    change = _norms([t - t0 for t, t0 in zip(tables, initial)], dim, family)
    del initial, tables
    return readings(run, state, _fit_losses(losses, fits),
                    _norms(first, dim, family), change)
