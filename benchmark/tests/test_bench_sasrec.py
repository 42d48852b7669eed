"""The SASRec cell's own pieces at a size a test run holds: the operation
count pinned, the reference against a step-by-step loop, the histories
and calls, the TF32 control and the planted faults, each of which comes
out not correct, and a run that loads nothing of JAX."""

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import blocks, data
from benchmark.models import sasrec as family
from benchmark.reference import sasrec
from benchmark.tests.conftest import ROOT, TINY, run_tiny

WORKLOAD = 'sasrec-ml1m.mrr'


def _limits():
    return json.loads((ROOT / 'benchmark' / 'limits'
                       / (WORKLOAD + '.json')).read_text())


def test_block_ops_are_the_products_at_real_steps():
    # One step: the five D x D products and its one causal pair.
    assert blocks.block_ops([1], 50) == 10 * 50 * 50 + 2 * 50 * 2
    # A call of 2,048 histories filling the prefix's window (199 real
    # steps), two blocks, then 2 B N D over the 3,417 items.
    assert blocks.call_ops(np.full(2048, 199), 50, 2, 3417) == \
        37_379_481_600
    # The padding share of the profile lowers the count, not the products'
    # width: fewer steps, fewer pairs.
    assert blocks.block_ops([100, 99], 50) < blocks.block_ops([199], 50) \
        + blocks.block_ops([0], 50)


def _weights(dim=6, items=9, window=5, num_blocks=2, seed=3):
    cfg = dict(embedding_dim=dim, num_items=items, max_sequence_length=window,
               num_blocks=num_blocks)
    return family.make_weights(cfg, seed, 'cpu')


def test_reference_follows_the_blocks_step_by_step():
    weights = _weights()
    seqs = torch.tensor([[0, 0, 3, 4], [1, 2, 8, 5], [0, 0, 0, 7],
                         [0, 0, 0, 0]])
    got = sasrec.representations(weights, seqs, 2)
    table = weights['item_embeddings.weight']
    dim = table.shape[1] - 1

    def norm(x, stem):
        mean = x.mean()
        return ((x - mean) / math.sqrt(((x - mean) ** 2).mean() + 1e-8)
                * weights[stem + 'weight'] + weights[stem + 'bias'])

    for b in range(seqs.shape[0]):
        ids = [0] + seqs[b].tolist()
        steps = len(ids)
        x = [(table[i, :dim] + weights['position_embeddings'][
            5 - steps + j]) * (i != 0) if 5 - steps + j >= 0
            else torch.zeros(dim) for j, i in enumerate(ids)]
        for k in range(2):
            stem = 'blocks.{}.'.format(k)
            w = {n: weights[stem + n] for n in ('w_q', 'w_k', 'w_v', 'w_1',
                                                'w_2', 'b_1', 'b_2')}
            a = [norm(v, stem + 'norm_a_') for v in x]
            out = []
            for i in range(steps):
                keys = [j for j in range(i + 1) if ids[j] != 0]
                if keys:
                    logits = torch.stack([(a[i] @ w['w_q']) @ (a[j] @ w['w_k'])
                                          for j in keys]) / math.sqrt(dim)
                    p = torch.softmax(logits, 0)
                    att = sum(p[n] * (a[j] @ w['w_v'])
                              for n, j in enumerate(keys))
                else:
                    att = torch.zeros(dim)
                s = x[i] + att
                f = norm(s, stem + 'norm_f_')
                h = torch.relu(f @ w['w_1'] + w['b_1']) @ w['w_2'] + w['b_2']
                out.append((s + h) * (ids[i] != 0))
            x = out
        for i in range(steps):
            want = norm(x[i], 'output_norm.')
            assert torch.allclose(got[b, i], want, atol=1e-5), (b, i)


def test_histories_follow_the_profile_and_calls_hold_each_stratum():
    cfg = dict(TINY['sasrec_ml1m'], activity_exponent=1.0)
    rows, lengths = family.histories(cfg, 2 ** 33 + 1, 'cpu')
    again, _ = family.histories(cfg, 2 ** 33 + 1, 'cpu')
    assert np.array_equal(rows, again)
    profile = np.minimum(data.activity_counts(
        cfg['num_sequences'], cfg['num_actions'], cfg['min_actions'],
        cfg['max_actions'], 1.0), cfg['sequence_length'])
    assert np.array_equal(np.sort(lengths), np.sort(profile))
    # Left-padded: a history's items are its last `length` steps.
    assert np.array_equal((rows != 0).sum(1), lengths)
    assert np.all((rows != 0) == (np.arange(rows.shape[1])[None]
                                  >= (rows.shape[1] - lengths)[:, None]))
    one = family.call_rows(lengths, 64, 9, seed=3)
    other = family.call_rows(lengths, 64, 9, seed=4)
    # Every user of the population is called, none twice before all once.
    assert len(np.unique(np.concatenate(one[:7]))) == len(lengths)
    for a, b in zip(one, other):
        assert len(np.unique(a)) == 64
        assert abs(lengths[a].mean() - lengths[b].mean()) < 3


def test_the_tf32_control_is_not_correct():
    result, checks = run_tiny(WORKLOAD, controls=('tf32',),
                              traffic=dict(check_answers=10 ** 6))
    assert result['correct'] is True
    assert result['controls']['tf32']['rank_gap'] > \
        10 * _limits()['rank_gap']['limit']


def test_a_key_padding_mask_left_out(monkeypatch):
    from spotlight_tpu_torch.sequence.representations import SelfAttentionNet

    block = SelfAttentionNet._block

    def causal_only(self, x, params, hidden, has_key):
        steps = x.shape[1]
        later = ~torch.ones(steps, steps, dtype=torch.bool).tril()
        return block(self, x, params, later.expand_as(hidden),
                     torch.ones_like(has_key))

    monkeypatch.setattr(SelfAttentionNet, '_block', causal_only)
    result, checks = run_tiny(WORKLOAD, traffic=dict(check_answers=10 ** 6))
    assert result['correct'] is False
    assert checks['rank_gap']['value'] > checks['rank_gap']['limit']


def test_dropout_left_on_while_serving(monkeypatch):
    from spotlight_tpu_torch.sequence.representations import SelfAttentionNet

    monkeypatch.setattr(SelfAttentionNet, 'eval', lambda self: self)
    result, checks = run_tiny(WORKLOAD, traffic=dict(check_answers=10 ** 6))
    assert result['correct'] is False
    assert checks['rank_gap']['value'] > checks['rank_gap']['limit']


def test_the_attention_counters_read_the_padding_share():
    result, _ = run_tiny(WORKLOAD, traced=True)
    cfg = dict(TINY['sasrec_ml1m'], activity_exponent=1.0)
    lengths = np.minimum(data.activity_counts(
        cfg['num_sequences'], cfg['num_actions'], cfg['min_actions'],
        cfg['max_actions'], 1.0), cfg['sequence_length'])
    # Each call holds one history of every length stratum, so its share
    # of real rows is the profile's, within a stratum's spread.
    want = cfg['sequence_length'] / (lengths - 1).mean()
    assert result['metrics']['attention_rows.eval']['value'] == \
        pytest.approx(want, rel=0.05)
    assert result['metrics']['block_dispatch_ms.eval']['value'] > 0


RUN = '''
import sys
sys.path.insert(0, {root!r})
import benchmark.conftest
from benchmark.tests.conftest import run_tiny
run_tiny('sasrec-ml1m.mrr', seconds=0.2, traced=True)
print(' '.join(sorted({{n.split('.')[0] for n in sys.modules}})))
'''
REFERENCE = '''
import sys
sys.path.insert(0, {root!r})
import benchmark.reference.sasrec, benchmark.blocks
print(' '.join(sorted({{n.split('.')[0] for n in sys.modules}})))
'''


@pytest.mark.parametrize('source,port', [(RUN, True), (REFERENCE, False)])
def test_no_jax_and_a_reference_apart_from_the_port(source, port):
    done = subprocess.run([sys.executable, '-c',
                           source.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert done.returncode == 0, done.stderr[-2000:]
    loaded = set(done.stdout.split())
    assert not loaded & {'jax', 'jaxlib', 'flax', 'spotlight_tpu'}
    assert ('spotlight_tpu_torch' in loaded) == port
