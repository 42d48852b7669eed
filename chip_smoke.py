"""Smoke run of the PyTorch/CUDA port (``spotlight_tpu_torch``) on one GPU.

Usage::

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this file;
without a card, or run from a directory that holds only this file, it exits
non-zero before printing any result.  It imports nothing of JAX.  Phases,
each of which exits non-zero when it fails:

1. device: the card's name and power limit, as ``nvidia-smi`` reports them.
2. build: ``nvcc`` builds the kernels of
   ``spotlight_tpu_torch/ops/kernels/csrc`` (for ``sm_90a``).
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, on seeded inputs at D=64 over N=200,000 items, bit for bit; the
   median time of each, the plain version's, one PyTorch call's where one
   computes the same function, and the card's bound for the work.
4. slice: the implicit-MF serving path at full width: 50,000 users x
   200,000 items, D=64, ``predict``, ``mrr_score`` over 20,000 test users
   with a train mask and ``precision_recall_score`` at k=10 with a train
   mask holding a 120-item heavy user.  The launch counters are zeroed
   just before and read just after; every kernel must have launched.  On
   the first 2,048 users the streaming path must agree with the
   materialize path.
5. profile: a warm call of each metric on the host clock, then where the
   device time of one more call goes, by kernel, and the host's
   preprocessing time.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): float32
#: outside the tensor cores, and HBM3 bandwidth.
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

D = 64
NUM_USERS = 50_000
NUM_ITEMS = 200_000
TRAIN_PAIRS = 500_000
EVAL_USERS = 20_000
TEST_PER_USER = 4
HEAVY_EXTRA = 120
CHECK_USERS = 2_048
#: The main path's common top-k fetch: k=10 plus a 2,048-user batch's
#: widest train row (22 to 24 items in this data).
MAIN_TOPK_K = 34
KERNEL_REPS = 20
PLAIN_REPS = 5


def log(**fields):
    print(json.dumps(fields), flush=True)


def median_ms(torch, fn, reps):
    """Median device time of one call of ``fn``, over ``reps`` calls after
    one warm-up call, each bracketed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in marks)


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the float32
    peak and the bytes over the memory rate."""
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# -- phase 3: kernels against their plain versions ---------------------------

def kernel_inputs(torch, batch, generator):
    dev = 'cuda'
    users = torch.randn(batch, D, generator=generator, device=dev) / D ** .5
    items = torch.randn(NUM_ITEMS, D, generator=generator,
                        device=dev) / D ** .5
    bias = 0.1 * torch.randn(NUM_ITEMS, generator=generator, device=dev)
    return users, items, bias


def check_rank_kernels(torch, card, generator):
    """K1 and K1c at the main path's (B=2048, T=4) and a heavy target
    width (B=256, T=128).  Returns the kernel-table entries of the main
    path's case."""
    from spotlight_tpu_torch.ops.kernels import ranking

    entries = {}
    for batch, width in ((2048, 4), (256, 128)):
        users, items, bias = kernel_inputs(torch, batch, generator)
        ids = torch.randint(0, NUM_ITEMS, (batch, width),
                            generator=generator, device='cuda')
        ts = ranking.matched_target_scores(users, items, bias, ids)
        ts_plain = ranking.matched_target_scores_plain(users, items, bias,
                                                       ids)
        if not torch.equal(ts, ts_plain):
            raise AssertionError('matched_target_scores differs from its '
                                 'plain version at B={} T={}'
                                 .format(batch, width))
        weights = ranking.rank_weights(users, items, bias, ts)
        plain = ranking.rank_weights_plain(users, items, bias, ts)
        if not torch.equal(weights, plain):
            raise AssertionError(
                'rank_weights differs from its plain version at B={} T={}: '
                '{} of {} weights'.format(batch, width,
                                          int((weights != plain).sum()),
                                          weights.numel()))
        # Every target ties itself once (weight >= 0.5): the exact-tie
        # contract held on the card.
        if not bool((weights >= 0.5).all()):
            raise AssertionError('a target lost its self-tie')

        shape = 'B={} N={} D={} T={}'.format(batch, NUM_ITEMS, D, width)
        k1c_ops = 2 * batch * width * D
        k1c_bytes = 4 * batch * D + batch * width * (4 * D + 12)
        k1_ops = 2 * batch * NUM_ITEMS * D + 2 * batch * width * NUM_ITEMS
        k1_bytes = (4 * NUM_ITEMS * D + 4 * NUM_ITEMS + 4 * batch * D
                    + 8 * batch * width)
        cases = (
            ('matched_target_scores', 'ranking.cu',
             'spotlight_tpu/ops/kernels/ranking.py:459',
             lambda: ranking.matched_target_scores(users, items, bias, ids),
             lambda: ranking.matched_target_scores_plain(users, items, bias,
                                                         ids),
             k1c_ops, k1c_bytes, 0.0),
            ('rank_weights', 'ranking.cu',
             'spotlight_tpu/ops/kernels/ranking.py:107',
             lambda: ranking.rank_weights(users, items, bias, ts),
             lambda: ranking.rank_weights_plain(users, items, bias, ts),
             k1_ops, k1_bytes, 0.0),
        )
        for name, src, replaces, fn, plain_fn, ops, nbytes, err in cases:
            bound_ms, bound_by = bound(ops, nbytes)
            entry = dict(
                name=name, route='cuda',
                source='spotlight_tpu_torch/ops/kernels/csrc/' + src,
                replaces=replaces, shape=shape, max_abs_err=err,
                ms=median_ms(torch, fn, KERNEL_REPS),
                plain_ms=median_ms(torch, plain_fn, PLAIN_REPS),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            log(kernel_case=entry, card=card)
            if batch == 2048:
                entries[name] = entry
        del users, items, bias, ts, weights, plain
        torch.cuda.empty_cache()
    return entries


def check_topk_kernel(torch, card, generator):
    """K2 at B=256 with k=10, k=134 (P@10 plus a 124-wide train
    over-fetch) and k=300 (resume rounds), and at the main path's two
    shapes: B=2048 with k=34 (P@10 plus a batch's widest train row, ~24)
    and k=143 (the batch of the 120-item heavy user).  Returns the
    kernel-table entry of the main path's common case."""
    from spotlight_tpu_torch.ops.kernels import topk

    main = None
    for batch, k in ((256, 10), (256, 134), (256, 300), (2048, 143),
                     (2048, MAIN_TOPK_K)):
        users, items, bias = kernel_inputs(torch, batch, generator)
        scores, ids = topk.streaming_topk(users, items, bias, k)
        p_scores, p_ids = topk.streaming_topk_plain(users, items, bias, k)
        if not (torch.equal(ids, p_ids) and torch.equal(scores, p_scores)):
            raise AssertionError(
                'streaming_topk differs from its plain version at B={} '
                'k={}: {} ids differ'.format(batch, k,
                                             int((ids != p_ids).sum())))
        err = float((scores - p_scores).abs().max())

        def library():
            full = torch.addmm(bias, users, items.T)
            return torch.topk(full, k, dim=1)

        ops = 2 * batch * NUM_ITEMS * D + batch * NUM_ITEMS
        nbytes = (4 * NUM_ITEMS * D + 4 * NUM_ITEMS + 4 * batch * D
                  + 8 * batch * k)
        bound_ms, bound_by = bound(ops, nbytes)
        entry = dict(
            name='streaming_topk', route='cuda',
            source='spotlight_tpu_torch/ops/kernels/csrc/topk.cu',
            replaces='spotlight_tpu/ops/kernels/topk.py:62',
            shape='B={} N={} D={} k={}'.format(batch, NUM_ITEMS, D, k),
            max_abs_err=err,
            ms=median_ms(torch,
                         lambda: topk.streaming_topk(users, items, bias, k),
                         KERNEL_REPS),
            plain_ms=median_ms(
                torch,
                lambda: topk.streaming_topk_plain(users, items, bias, k),
                PLAIN_REPS),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=median_ms(torch, library, PLAIN_REPS))
        log(kernel_case=entry, card=card)
        if (batch, k) == (2048, MAIN_TOPK_K):
            main = entry
        del users, items, bias, scores, ids, p_scores, p_ids
        torch.cuda.empty_cache()
    return main


# -- phase 4: the slice at full width ----------------------------------------

def dyadic(values, step):
    """``values`` rounded to multiples of ``step`` (a power of two)."""
    return (np.round(values / step) * step).astype(np.float32)


def parameter_tree(rs):
    """A JAX-layout fused parameter tree for D=64.

    The factors are N(0, 1/D) draws (the JAX package's initialisation: a
    standard normal over D) rounded to multiples of 2^-12, and the biases
    small draws rounded to multiples of 2^-16.  Every product is then a
    multiple of 2^-24 and every score and partial sum stays below 1 in
    magnitude, so each is exact in float32 in any summation order: the
    streaming kernels and the materialize path (a cuBLAS product) must
    agree exactly, ties included."""
    def table(rows):
        weight = np.empty((rows, D + 1), np.float32)
        weight[:, :D] = dyadic(rs.randn(rows, D) / D, 2.0 ** -12)
        weight[:, D] = dyadic(2.0 ** -9 * rs.randn(rows), 2.0 ** -16)
        return {'weight': weight}

    return {'user_embeddings': table(NUM_USERS),
            'item_embeddings': table(NUM_ITEMS)}


def restrict(interactions, num_users):
    from spotlight_tpu_torch.data import Interactions

    keep = interactions.user_ids < num_users
    return Interactions(interactions.user_ids[keep],
                        interactions.item_ids[keep],
                        num_users=interactions.num_users,
                        num_items=interactions.num_items)


def counters():
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    return {'rank_weights': ranking.RANK_WEIGHTS_LAUNCHES,
            'matched_target_scores': ranking.MATCHED_SCORES_LAUNCHES,
            'streaming_topk': topk.STREAMING_TOPK_LAUNCHES}


def reset_counters():
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    ranking.RANK_WEIGHTS_LAUNCHES = 0
    ranking.MATCHED_SCORES_LAUNCHES = 0
    topk.STREAMING_TOPK_LAUNCHES = 0


def run_slice(torch, card):
    """Returns (launch counts of the main path, model, data)."""
    from spotlight_tpu_torch.data import Interactions
    from spotlight_tpu_torch.evaluation import (mrr_score,
                                                precision_recall_score)
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.utils.convert import params_from_jax

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('float32 products must not run in TF32')
    rs = np.random.RandomState(7)
    train = Interactions(
        rs.randint(0, NUM_USERS, TRAIN_PAIRS).astype(np.int64),
        rs.randint(0, NUM_ITEMS, TRAIN_PAIRS).astype(np.int64),
        num_users=NUM_USERS, num_items=NUM_ITEMS)
    test = Interactions(
        np.repeat(np.arange(EVAL_USERS, dtype=np.int64), TEST_PER_USER),
        rs.randint(0, NUM_ITEMS, TEST_PER_USER * EVAL_USERS).astype(
            np.int64),
        num_users=NUM_USERS, num_items=NUM_ITEMS)
    heavy = Interactions(
        np.concatenate([np.zeros(HEAVY_EXTRA, dtype=np.int64),
                        train.user_ids]),
        np.concatenate([rs.randint(0, NUM_ITEMS, HEAVY_EXTRA).astype(
            np.int64), train.item_ids]),
        num_users=NUM_USERS, num_items=NUM_ITEMS)

    model = ImplicitFactorizationModel(
        loss='bpr', embedding_dim=D, random_state=np.random.RandomState(42))
    model._initialize(train)
    tree = parameter_tree(np.random.RandomState(0))
    model._load_params(params_from_jax(model._net, tree))

    # The main path, with the launch counters zeroed just before it.
    torch.cuda.synchronize()
    reset_counters()
    start = time.perf_counter()
    predict_users = np.array([0, 1, NUM_USERS // 10, NUM_USERS - 1])
    catalogue = [model.predict(int(u)) for u in predict_users]
    pair_items = rs.randint(0, NUM_ITEMS, len(predict_users))
    pairs = model.predict(predict_users, pair_items)
    predict_s = time.perf_counter() - start

    start = time.perf_counter()
    mrr = mrr_score(model, test, train=train)
    mrr_s = time.perf_counter() - start

    start = time.perf_counter()
    precision, recall = precision_recall_score(model, test, train=heavy,
                                               k=10)
    pr_s = time.perf_counter() - start
    launches = counters()
    log(main_path_launches=launches)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError('{} never launched on the main path'
                                 .format(name))

    # predict against a float64 recomputation on the host.
    users64 = tree['user_embeddings']['weight'].astype(np.float64)
    items64 = tree['item_embeddings']['weight'].astype(np.float64)
    for u, got in zip(predict_users, catalogue):
        want = (items64[:, :D] @ users64[u, :D] + users64[u, D]
                + items64[:, D])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = ((users64[predict_users, :D] * items64[pair_items, :D]).sum(1)
            + users64[predict_users, D] + items64[pair_items, D])
    np.testing.assert_allclose(pairs, want, rtol=1e-5, atol=1e-5)

    # What comes out is finite and of the expected shape.
    if mrr.shape != (EVAL_USERS,) or not np.all(np.isfinite(mrr)):
        raise AssertionError('mrr_score: bad output {}'.format(mrr.shape))
    if not (np.all(mrr > 0) and np.all(mrr <= 1)):
        raise AssertionError('mrr_score: values outside (0, 1]')
    for name, values in (('precision', precision), ('recall', recall)):
        if values.shape != (EVAL_USERS,) or not (
                np.all(values >= 0) and np.all(values <= 1)):
            raise AssertionError('{}: bad output'.format(name))

    log(slice='predict', users=len(predict_users), seconds=predict_s,
        card=card)
    log(slice='mrr_score', users=EVAL_USERS, seconds=mrr_s,
        users_per_s=EVAL_USERS / mrr_s,
        g_item_ranks_per_s=EVAL_USERS * NUM_ITEMS / mrr_s / 1e9,
        mean_mrr=float(mrr.mean()), card=card)
    log(slice='precision_recall_score', k=10, users=EVAL_USERS,
        seconds=pr_s, users_per_s=EVAL_USERS / pr_s,
        g_item_ranks_per_s=EVAL_USERS * NUM_ITEMS / pr_s / 1e9,
        mean_precision=float(precision.mean()),
        mean_recall=float(recall.mean()), card=card)

    # Streaming against materialize on the first users.  The scores are
    # exact (see parameter_tree), so both paths see the same ties.
    sub = restrict(test, CHECK_USERS)
    streamed = mrr_score(model, sub, train=train, streaming=True)
    materialized = mrr_score(model, sub, train=train, streaming=False)
    np.testing.assert_allclose(streamed, materialized, rtol=1e-6, atol=0)
    p_s, r_s = precision_recall_score(model, sub, train=heavy, k=10,
                                      streaming=True)
    p_m, r_m = precision_recall_score(model, sub, train=heavy, k=10,
                                      streaming=False)
    np.testing.assert_array_equal(p_s, p_m)
    np.testing.assert_array_equal(r_s, r_m)
    log(check='streaming == materialize', users=CHECK_USERS,
        mrr_max_rel_err=float(np.max(np.abs(streamed - materialized)
                                     / materialized)))
    return launches, model, test, train, heavy


# -- phase 5: where the time goes --------------------------------------------

def profile_metrics(torch, card, model, test, train, heavy):
    """Per metric: one warm call timed on the host clock (the item factors
    are cached by now), then one call under the profiler for the device
    time by kernel.  Also the host's share: the CSR conversion and row
    padding that precede the first batch."""
    from torch.profiler import ProfilerActivity, profile

    from spotlight_tpu_torch import evaluation

    start = time.perf_counter()
    evaluation._eval_rows(test, heavy)
    log(host='_eval_rows (test + train CSR, padded rows)',
        ms=(time.perf_counter() - start) * 1e3, card=card)

    calls = (('mrr_score',
              lambda: evaluation.mrr_score(model, test, train=train)),
             ('precision_recall_score',
              lambda: evaluation.precision_recall_score(model, test,
                                                        train=heavy, k=10)))
    for metric, call in calls:
        torch.cuda.synchronize()
        start = time.perf_counter()
        call()
        warm_s = time.perf_counter() - start
        log(warm=metric, users=EVAL_USERS, seconds=warm_s,
            users_per_s=EVAL_USERS / warm_s,
            g_item_ranks_per_s=EVAL_USERS * NUM_ITEMS / warm_s / 1e9,
            card=card)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            call()
            wall_ms = (time.perf_counter() - start) * 1e3
        by_kernel = {}
        for event in prof.key_averages():
            device_us = getattr(event, 'self_device_time_total', None)
            if device_us is None:
                device_us = getattr(event, 'self_cuda_time_total', 0)
            if device_us > 0:
                by_kernel[event.key[:80]] = device_us / 1e3
        busy_ms = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
        log(profile=metric, wall_ms=wall_ms, device_busy_ms=busy_ms,
            device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
            top_kernels_ms=dict(top), card=card)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, ROOT)
    from spotlight_tpu_torch.ops.kernels import _build

    card = card_line()
    print(card, flush=True)

    start = time.perf_counter()
    built = _build.build()
    log(phase='build', seconds=time.perf_counter() - start, built=built)
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix('.log')
        if report.exists():
            log(ptxas=name, report=[
                line.strip() for line in report.read_text().splitlines()
                if 'Used' in line or 'spill' in line
                or 'Compiling entry' in line])

    generator = torch.Generator(device='cuda')
    generator.manual_seed(0)
    entries = check_rank_kernels(torch, card, generator)
    entries['streaming_topk'] = check_topk_kernel(torch, card, generator)

    launches, model, test, train, heavy = run_slice(torch, card)
    profile_metrics(torch, card, model, test, train, heavy)

    kernels = []
    for name in ('rank_weights', 'matched_target_scores', 'streaming_topk'):
        entry = dict(entries[name])
        entry['launches'] = launches[name]
        kernels.append(entry)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
