"""``evaluation.mrr_score(model, test)``: each call ranks every test item
of its users against the whole catalogue (no train mask) and returns one
mean reciprocal rank a user."""

from __future__ import annotations

from benchmark import serving


def answer(model, test):
    from spotlight_tpu_torch import evaluation

    return evaluation.mrr_score(model, test)


def setup(run):
    return serving.setup(run, answer)


def call(run, state, index):
    return serving.call(run, state, index, answer)


def counters(run, state):
    return {'materialize_routes': serving.routes()}


def release(run, state):
    serving.release(state)


def verify(run, state):
    return serving.verify_mrr(run, state)


def control(run, state, precision):
    return serving.verify_mrr(run, state, precision)
