"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the port at a size a test run holds."""

import numpy as np
import pytest

from benchmark.tests.conftest import run_tiny


def test_a_step_that_leaves_the_state_unchanged(monkeypatch):
    from spotlight_tpu_torch.utils import training

    monkeypatch.setattr(training.Adam, 'update',
                        lambda self, params, grads, state: None)
    result, checks = run_tiny('mf-msd.train-dense')
    assert result['correct'] is False
    assert checks['change_gap']['value'] == pytest.approx(1.0)


def test_half_of_the_batch_left_out(monkeypatch):
    from spotlight_tpu_torch.utils import training

    whole = training.masked_mean

    def half(elems, mask):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0
        return whole(elems, mask)

    monkeypatch.setattr(training, 'masked_mean', half)
    result, checks = run_tiny('mf-msd.train-dense')
    assert result['correct'] is False
    assert checks['grad_gap']['value'] > checks['grad_gap']['limit']


def test_a_fit_that_stops_after_its_first_batch(monkeypatch):
    from spotlight_tpu_torch.utils import training

    whole = training.run_epoch

    def first_only(step, data, n_valid, num_batches, batch_size, perm,
                   negatives=None):
        return whole(step, data, n_valid, 1, batch_size,
                     perm[:batch_size], negatives)

    monkeypatch.setattr(training, 'run_epoch', first_only)
    result, checks = run_tiny('mf-msd.train-dense')
    assert result['correct'] is False
    assert checks['change_gap']['value'] > checks['change_gap']['limit']


def _patched_metric(monkeypatch, name, change):
    from spotlight_tpu_torch import evaluation

    metric = getattr(evaluation, name)
    calls = []

    def broken(*args, **kwargs):
        out = metric(*args, **kwargs)
        calls.append(out)
        return change(out, calls)

    monkeypatch.setattr(evaluation, name, broken)


@pytest.mark.parametrize('workload,metric', [
    ('mf-msd.mrr', 'mrr_score'),
    ('mixture-1e6.mrr', 'sequence_mrr_score')])
def test_an_answer_altered_where_it_is_produced(monkeypatch, workload,
                                                metric):
    def alter(out, calls):
        out = out.copy()
        out[np.argmin(out)] *= 2
        return out

    _patched_metric(monkeypatch, metric, alter)
    result, checks = run_tiny(workload, traffic=dict(check_answers=10 ** 6))
    assert result['correct'] is False
    assert checks['rank_gap']['value'] > checks['rank_gap']['limit']


def test_half_of_the_batch_left_out_of_the_answers(monkeypatch):
    _patched_metric(monkeypatch, 'mrr_score',
                    lambda out, calls: out[:len(out) // 2])
    result, checks = run_tiny('mf-msd.mrr')
    assert result['correct'] is False
    assert checks['missing_answers']['value'] > 0


def test_answers_of_the_call_before(monkeypatch):
    _patched_metric(monkeypatch, 'sequence_mrr_score',
                    lambda out, calls: calls[-2] if len(calls) > 1 else out)
    result, checks = run_tiny('mixture-1e6.mrr',
                              traffic=dict(check_answers=10 ** 6))
    assert result['correct'] is False
