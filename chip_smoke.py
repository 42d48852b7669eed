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
   card, on seeded inputs at D=64 over N=200,000 items, bit for bit (the
   mixture kernels: M=4, B=2,048 for K4 and B=256 for K1 and K2, counts
   and ids exactly, scores within 2 ulp, the largest gap printed); the
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
6. sequences: the mixture-of-tastes serving path at full width, the
   repo's ``mixture_catalog_eval_200k`` (``scripts/bench_suite.py``):
   M=4, D=64, 200,000 items, 2,048 test sequences of length 50;
   ``predict``, ``sequence_mrr_score`` with and without
   ``exclude_preceding`` and ``sequence_precision_recall_score`` at k=10,
   with the launch counters zeroed just before and read just after; the
   mixture K1 and K2 once more at the main path's batch of 2,048 on its
   own operands, against their plain versions in 256-sequence slices; on
   the first 256 sequences the streaming path against the materialize
   path, each rank that differs printed and held to the exact rank of the
   plain catalogue pass; then a duplicated-row tie check (every rank
   k + 0.5), and where the device time of one more ``sequence_mrr_score``
   goes.
7. bloom sequences: the serving path of
   ``examples/bloom_embeddings/performance.py``'s model at 1e6 items: an
   untrained ``LSTMNet`` (D=64) with a ``BloomEmbedding`` item layer
   (200,000 compressed rows, 4 hashes), 2,048 test sequences of length 50;
   ``predict``, ``sequence_mrr_score`` with and without
   ``exclude_preceding`` and ``sequence_precision_recall_score`` at k=10,
   the launch counters of K1, K1c and K2 zeroed just before and read just
   after; streaming against materialize on the first 256 sequences as in
   phase 6.
8. kernel entry points on the bloom model's operands, driven once with
   their launch counters zeroed just before and read just after:
   ``reciprocal_ranks_streaming`` (K1c, K5) on the metric's operands,
   equal bit for bit to ``sequence_mrr_score``'s values; mixture K5 on
   phase 6's model; ``multihot_gather_sum(mask_row_zero=True)`` (K7f) and
   ``bloom_gather_sum`` (K6) over all 1e6 ids with their gradients (K7b,
   K6's backward).  Then K5 against its plain version and the K1
   identity, at the repo's K5 shape with four quarter-catalogue calls; the
   lookups and their gradients bit for bit against their plain versions,
   the backward in two launches and within 1e-5 of ``index_add_``, K7f
   within 1e-6 of the layer's own lookup; each timed beside its plain
   version and its ``embedding_bag`` yardstick; the lookup benchmark's
   shapes and one bfloat16 table; where the device time of one bloom
   ``sequence_mrr_score`` goes.
9. training: P1 (``row_adam``) against its plain version bit for bit, in
   two launches, at the probe's shapes (R = 100,000 + 8 and 2,000,000 + 8,
   W=128, 24,576 ids from ``RandomState(0)``) with
   ``torch.optim.SparseAdam`` as the yardstick (rtol 1e-5); the lazy engine
   at ``bench_lazy_knobs``' width (BPR, D=64, 2e6 users x 5e5 items, 1e6
   pairs, batch 8,192): one warm epoch, then 4 timed epochs with the P1
   counter zeroed just before and read just after (2 launches a step), one
   epoch profiled; P1 on that engine's own operands captured from one warm
   step (float32 and bfloat16 tables) at the engine's own l2 (0), timed,
   with ``SparseAdam`` from the captured moments as the yardstick, and once
   more bit for bit at l2=1e-6; the dense engine at
   ``bench.py``'s width (1e5 x 2e4): one warm epoch, 10 timed, one
   profiled; the JAX package's learning gates through ``fit`` and
   ``mrr_score`` on the card; one lazy step on the card against the same
   step on the CPU (gradients within rtol 1e-5, its P1 calls bit-equal to
   the plain version).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

import contextlib
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

#: Where the kernel checks put their operands (the card).
DEVICE = 'cuda'
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

#: The sequence slice: mixture_catalog_eval_200k.
MIXTURES = 4
SEQ_ROWS = 4_096
SEQ_LENGTH = 50
SEQ_EVAL = 2_048
SEQ_CHECK = 256
SEQ_K = 10
#: Users of a plain mixture pass: it holds several (N, B) float32
#: temporaries, 205 MB each at B=256, so larger batches run in slices.
MIX_BATCH = 256
#: The bloom slice: examples/bloom_embeddings/performance.py's model,
#: LSTMNet with a BloomEmbedding item layer (ratio 0.2, 4 hashes), at the
#: third of its catalogue sizes.
BLOOM_ITEMS = 1_000_000
BLOOM_RATIO = 0.2
BLOOM_HASHES = 4
BLOOM_ROWS = int(BLOOM_RATIO * BLOOM_ITEMS)
#: scripts/bloom_kernel_bench.py's lookup shapes.
LOOKUP_BATCH = 8_192
LOOKUP_ROWS = (4_096, 65_536, 262_144)
#: Phase 9, training: scripts/bench_suite.py's bench_lazy_knobs (the lazy
#: engine) and bench.py (the dense engine), not cut; the probe's P1 shapes.
TRAIN_DIM = 64
TRAIN_BATCH = 8_192
FIT_PAIRS = 1_000_000
LAZY_USERS, LAZY_ITEMS, LAZY_EPOCHS = 2_000_000, 500_000, 4
DENSE_USERS, DENSE_ITEMS, DENSE_EPOCHS = 100_000, 20_000, 10
#: The warm epoch's step whose row updates phase 9 captures.
CAPTURE_STEP = 60
PROBE_ROWS = (100_000, 2_000_000)
PROBE_WIDTH, PROBE_IDS = 128, 24_576
#: Model seeds whose mean the lazy bpr gate holds (one seed of a random
#: stream other than JAX's is a coin toss at that gate).
GATE_LAZY_SEEDS = (0, 1, 2, 3)
#: Largest gap between the materialize path's scores and the plain
#: catalogue pass's, relative to the row's largest score: float32
#: rounding of other summation orders, far above it a wrong score.
SCORE_RTOL = 1e-5


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


def kernel_entry(name, src, replaces, shape, ms, plain_ms, ops, nbytes,
                 err, library_ms=None, **extra):
    """A kernel-table entry: the measured times, and the bound worked from
    the operations and bytes of the call."""
    bound_ms, bound_by = bound(ops, nbytes)
    return dict(name=name, route='cuda',
                source='spotlight_tpu_torch/ops/kernels/csrc/' + src,
                replaces=replaces, shape=shape, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, **extra)


def ulp_gap(torch, a, b):
    """Largest distance in units in the last place between two float32
    tensors of finite values (0 when they are bit-equal)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(bits < 0, -(bits & 0x7fffffff), bits)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# -- phase 3: kernels against their plain versions ---------------------------

def kernel_inputs(torch, batch, generator):
    dev = DEVICE
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
                            generator=generator, device=DEVICE)
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
            entry = kernel_entry(name, src, replaces, shape,
                                 median_ms(torch, fn, KERNEL_REPS),
                                 median_ms(torch, plain_fn, PLAIN_REPS),
                                 ops, nbytes, err)
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
        entry = kernel_entry(
            'streaming_topk', 'topk.cu',
            'spotlight_tpu/ops/kernels/topk.py:62',
            'B={} N={} D={} k={}'.format(batch, NUM_ITEMS, D, k),
            median_ms(torch,
                      lambda: topk.streaming_topk(users, items, bias, k),
                      KERNEL_REPS),
            median_ms(torch,
                      lambda: topk.streaming_topk_plain(users, items, bias,
                                                        k), PLAIN_REPS),
            ops, nbytes, err,
            library_ms=median_ms(torch, library, PLAIN_REPS))
        log(kernel_case=entry, card=card)
        if (batch, k) == (2048, MAIN_TOPK_K):
            main = entry
        del users, items, bias, scores, ids, p_scores, p_ids
        torch.cuda.empty_cache()
    return main


def mixture_ops(batch, num_items, mixtures=MIXTURES):
    """float32 operations of mixture scores for batch x num_items pairs:
    2M dots of D multiplies and adds, then the combine (M - 1 maxima, M
    subtractions, M expf counted as one operation each, M - 1 adds to the
    denominator, M multiplies and M - 1 adds, a division and the bias)."""
    return batch * num_items * (2 * 2 * mixtures * D + 6 * mixtures)


def mixture_entry(torch, card, name, src, replaces, shape, fn, plain_fn,
                  ops, nbytes, gap, err, ms=None):
    """A mixture kernel's case: its median time over KERNEL_REPS launches
    (or ``ms``, for K3, which has no launch of its own), its plain
    version's, the bound; printed, and returned as a kernel-table entry."""
    out = kernel_entry(
        name, src, replaces, shape,
        median_ms(torch, fn, KERNEL_REPS) if ms is None else ms,
        median_ms(torch, plain_fn, PLAIN_REPS), ops, nbytes, err,
        max_ulp=gap)
    log(kernel_case=out, card=card)
    return out


def check_mixture_kernels(torch, card, generator):
    """K4 at the main path's widths (B=2048 with T=1, the targets, and
    T=49, the ``exclude_preceding`` prefixes), and K1 and K2 with mixture
    scoring at B=256 (T=1 and k=10, and the k=59 of a P@10 fetch over 49
    excluded ids).  Counts and ids must be equal, scores within 2 ulp.
    Returns K4's kernel-table entry; those of K1, K2 and K3 with mixture
    scoring come from the main path's operands (check_sequence_kernels)."""
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    width = 2 * MIXTURES * D

    def operands(batch):
        users, items, bias = kernel_inputs(torch, batch, generator)
        users = torch.randn(batch, width, generator=generator,
                            device=DEVICE) / D ** .5
        return users, items, bias

    def entry(*args):
        return mixture_entry(torch, card, *args)

    entries = {}
    users, items, bias = operands(2048)
    for width_t in (1, 49):
        ids = torch.randint(1, NUM_ITEMS, (2048, width_t),
                            generator=generator, device=DEVICE)
        got = ranking.matched_candidate_scores(users, items, bias, ids,
                                               MIXTURES)
        want = ranking.matched_candidate_scores_plain(users, items, bias,
                                                      ids, MIXTURES)
        gap = ulp_gap(torch, got, want)
        if gap > 2:
            raise AssertionError('matched_candidate_scores is {} ulp from '
                                 'its plain version'.format(gap))
        pairs = 2048 * width_t
        case = entry(
            'matched_candidate_scores', 'ranking.cu',
            'spotlight_tpu/ops/kernels/ranking.py:527',
            'B=2048 N={} D={} M={} T={}'.format(NUM_ITEMS, D, MIXTURES,
                                                width_t),
            lambda: ranking.matched_candidate_scores(users, items, bias,
                                                     ids, MIXTURES),
            lambda: ranking.matched_candidate_scores_plain(
                users, items, bias, ids, MIXTURES),
            mixture_ops(pairs, 1),
            4 * 2048 * width + pairs * (4 * D + 12), gap,
            float((got - want).abs().max()))
        if width_t == 1:
            entries['matched_candidate_scores'] = case
    del users, items, bias

    users, items, bias = operands(MIX_BATCH)
    ids = torch.randint(1, NUM_ITEMS, (MIX_BATCH, 1), generator=generator,
                        device=DEVICE)
    ts = ranking.matched_candidate_scores(users, items, bias, ids, MIXTURES)
    ts_plain = ranking.matched_candidate_scores_plain(users, items, bias,
                                                      ids, MIXTURES)
    weights = ranking.rank_weights(users, items, bias, ts, MIXTURES)
    plain = ranking.rank_weights_plain(users, items, bias, ts_plain,
                                       MIXTURES)
    if not torch.equal(weights, plain):
        raise AssertionError('mixture rank_weights differs from its plain '
                             'version: {} of {} weights'.format(
                                 int((weights != plain).sum()),
                                 weights.numel()))
    if not bool((weights >= 0.5).all()):
        raise AssertionError('a mixture target lost its self-tie')
    shape = 'B={} N={} D={} M={}'.format(MIX_BATCH, NUM_ITEMS, D, MIXTURES)
    scoring = mixture_ops(MIX_BATCH, NUM_ITEMS)
    table_bytes = 4 * NUM_ITEMS * (D + 1) + 4 * MIX_BATCH * width
    entry('rank_weights (mixture)', 'ranking.cu',
          'spotlight_tpu/ops/kernels/ranking.py:107', shape + ' T=1',
          lambda: ranking.rank_weights(users, items, bias, ts, MIXTURES),
          lambda: ranking.rank_weights_plain(users, items, bias, ts_plain,
                                             MIXTURES),
          scoring + 2 * MIX_BATCH * NUM_ITEMS, table_bytes + 8 * MIX_BATCH,
          0, 0.0)

    for k in (SEQ_K, 59):
        scores, top = topk.streaming_topk(users, items, bias, k, MIXTURES)
        p_scores, p_top = topk.streaming_topk_plain(users, items, bias, k,
                                                    MIXTURES)
        gap = ulp_gap(torch, scores, p_scores)
        if not torch.equal(top, p_top) or gap > 2:
            raise AssertionError(
                'mixture streaming_topk differs from its plain version at '
                'k={}: {} ids, {} ulp'.format(k, int((top != p_top).sum()),
                                              gap))
        entry('streaming_topk (mixture)', 'topk.cu',
              'spotlight_tpu/ops/kernels/topk.py:62',
              shape + ' k={}'.format(k),
              lambda: topk.streaming_topk(users, items, bias, k, MIXTURES),
              lambda: topk.streaming_topk_plain(users, items, bias, k,
                                                MIXTURES),
              scoring + MIX_BATCH * NUM_ITEMS,
              table_bytes + 8 * MIX_BATCH * k, gap,
              float((scores - p_scores).abs().max()))
    del users, items, bias, ts, ts_plain, weights, plain
    torch.cuda.empty_cache()
    return entries


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


# -- phase 6: the sequence slice at full width -------------------------------

def sequence_counters():
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    return {'rank_weights (mixture)': ranking.MIXTURE_RANK_WEIGHTS_LAUNCHES,
            'streaming_topk (mixture)':
                topk.MIXTURE_STREAMING_TOPK_LAUNCHES,
            'matched_candidate_scores': ranking.CANDIDATE_SCORES_LAUNCHES}


def sequence_model():
    """The untrained mixture model of mixture_catalog_eval_200k, seeded
    (its item biases are zero), and the sequences."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    sequences = np.random.RandomState(42).randint(
        1, NUM_ITEMS, (SEQ_ROWS, SEQ_LENGTH)).astype(np.int32)
    model = ImplicitSequenceModel(loss='bpr', representation='mixture',
                                  embedding_dim=D,
                                  random_state=np.random.RandomState(0))
    model._initialize(SequenceInteractions(sequences, num_items=NUM_ITEMS))
    return model, sequences


def run_sequence_slice(torch, card):
    """Returns (launch counts of the main path, model, test set)."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.evaluation import (
        sequence_mrr_score, sequence_precision_recall_score)
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    model, sequences = sequence_model()
    if model._net.num_mixtures != MIXTURES:
        raise AssertionError('the mixture model has {} tastes'.format(
            model._net.num_mixtures))
    test = SequenceInteractions(sequences[:SEQ_EVAL], num_items=NUM_ITEMS)

    # The main path, with the launch counters zeroed just before it.
    torch.cuda.synchronize()
    ranking.MIXTURE_RANK_WEIGHTS_LAUNCHES = 0
    ranking.CANDIDATE_SCORES_LAUNCHES = 0
    topk.MIXTURE_STREAMING_TOPK_LAUNCHES = 0
    seconds = {}
    start = time.perf_counter()
    scores = model.predict(sequences[0])
    seconds['predict'] = time.perf_counter() - start
    start = time.perf_counter()
    mrr = sequence_mrr_score(model, test)
    seconds['sequence_mrr_score'] = time.perf_counter() - start
    start = time.perf_counter()
    mrr_ex = sequence_mrr_score(model, test, exclude_preceding=True)
    seconds['sequence_mrr_score exclude_preceding'] = (time.perf_counter()
                                                       - start)
    start = time.perf_counter()
    precision, recall = sequence_precision_recall_score(model, test,
                                                        k=SEQ_K)
    seconds['sequence_precision_recall_score'] = (time.perf_counter()
                                                  - start)
    launches = sequence_counters()
    log(sequence_path_launches=launches)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError('{} never launched on the sequence path'
                                 .format(name))

    # predict against the plain K3 scores of the same representation.
    final, items, bias, mixtures = model._rank_factors_sequences(
        sequences[:1])
    want = ranking.plain_mixture_scores(final, items, bias, mixtures)[:, 0]
    if scores.shape != (NUM_ITEMS,) or not np.all(np.isfinite(scores)):
        raise AssertionError('predict: bad output {}'.format(scores.shape))
    np.testing.assert_allclose(scores, want.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
    for name, values in (('sequence_mrr_score', mrr),
                         ('sequence_mrr_score exclude_preceding', mrr_ex)):
        if values.shape != (SEQ_EVAL,) or not (
                np.all(values > 0) and np.all(values <= 1)):
            raise AssertionError('{}: bad output'.format(name))
    for name, values in (('precision', precision), ('recall', recall)):
        if values.shape != (SEQ_EVAL,) or not (
                np.all(values >= 0) and np.all(values <= 1)):
            raise AssertionError('{}: bad output'.format(name))

    calls = {
        'sequence_mrr_score': lambda: sequence_mrr_score(model, test),
        'sequence_mrr_score exclude_preceding': lambda: sequence_mrr_score(
            model, test, exclude_preceding=True),
        'sequence_precision_recall_score':
            lambda: sequence_precision_recall_score(model, test, k=SEQ_K)}
    for name, call in calls.items():
        torch.cuda.synchronize()
        start = time.perf_counter()
        call()
        warm_s = time.perf_counter() - start
        first_s = seconds[name]
        log(sequence_slice=name, sequences=SEQ_EVAL, first_s=first_s,
            warm_s=warm_s, sequences_per_s=SEQ_EVAL / warm_s,
            g_item_scores_per_s=SEQ_EVAL * NUM_ITEMS / warm_s / 1e9,
            card=card)
    log(sequence_slice='predict', seconds=seconds['predict'],
        mean_mrr=float(mrr.mean()), mean_mrr_exclude=float(mrr_ex.mean()),
        mean_precision=float(precision.mean()), card=card)

    check_streaming_against_materialize(torch, model, sequences[:SEQ_CHECK],
                                        NUM_ITEMS)
    return launches, model, test


def check_streaming_against_materialize(torch, model, sequences, num_items):
    """Streaming against materialize on ``sequences``.  The two sum in
    other orders, so a rank may differ at a near tie: each rank that
    differs is printed, with two witnesses.  Every streaming rank must be
    the exact average-tie rank of the plain catalogue pass (bit-equal to
    the kernels), and the materialize path's scores must lie within
    SCORE_RTOL of the plain pass's, so an item the two paths order
    differently against a target lies within that gap of it.  P@10 must
    be equal."""
    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.evaluation import (
        sequence_mrr_score, sequence_precision_recall_score)
    from spotlight_tpu_torch.ops.kernels import ranking

    sub = SequenceInteractions(sequences, num_items=num_items)
    prefixes = sub.sequences[:, :-1]
    targets = torch.as_tensor(sub.sequences[:, -1:].astype(np.int64),
                              device=DEVICE)
    reprs, items, bias, mixtures = model._rank_factors_sequences(prefixes)
    exact = ranking.plain_scores(reprs, items, bias, mixtures).T.contiguous()
    full = model._score_catalog_sequences(prefixes)
    scale = exact.abs().amax(dim=1, keepdim=True)
    drift = float(((full - exact).abs() / scale).max())
    if drift > SCORE_RTOL:
        raise AssertionError('the materialize path\'s scores are {} (of the '
                             'row\'s largest) from the plain pass\'s'
                             .format(drift))
    everywhere = torch.ones_like(targets, dtype=torch.bool)
    prefix_ids = torch.as_tensor(prefixes.astype(np.int64), device=DEVICE)
    for exclude in (False, True):
        streamed = sequence_mrr_score(model, sub, exclude_preceding=exclude)
        materialized = sequence_mrr_score(model, sub, streaming=False,
                                          exclude_preceding=exclude)
        witness, seen = exact, full
        if exclude:
            witness = evaluation._mask_scores(exact, prefix_ids)
            seen = evaluation._mask_scores(full, prefix_ids)
        exact_rr = evaluation._reciprocal_ranks(witness, targets,
                                                everywhere).cpu().numpy()
        np.testing.assert_allclose(streamed, exact_rr, rtol=1e-6, atol=0)
        differ = np.flatnonzero(np.abs(streamed - materialized)
                                > 1e-6 * materialized)
        ties = []
        for b in differ.tolist():
            own = witness[b] - witness[b, targets[b, 0]]
            mat = seen[b] - seen[b, targets[b, 0]]
            flipped = torch.sign(own) != torch.sign(mat)
            ties.append(dict(
                sequence=b, streamed_rank=float(1 / streamed[b]),
                materialized_rank=float(1 / materialized[b]),
                items_ordered_apart=int(flipped.sum()),
                widest_gap_of_scale=float(own[flipped].abs().max()
                                          / scale[b, 0])))
        log(check='sequence streaming vs materialize', items=num_items,
            exclude_preceding=exclude, sequences=len(sequences),
            streaming_equals_exact_rank=True, score_drift_of_scale=drift,
            ranks_apart=len(ties), near_ties=ties)
    del exact, full, witness, seen
    p_s, r_s = sequence_precision_recall_score(model, sub, k=SEQ_K)
    p_m, r_m = sequence_precision_recall_score(model, sub, k=SEQ_K,
                                               streaming=False)
    log(check='sequence P@10 streaming == materialize', items=num_items,
        sequences=len(sequences),
        precision_apart=np.flatnonzero(p_s != p_m).tolist())
    np.testing.assert_array_equal(p_s, p_m)
    np.testing.assert_array_equal(r_s, r_m)
    torch.cuda.empty_cache()


def sliced(fn, *rows):
    """``fn`` over MIX_BATCH-row slices of the row operands, in order."""
    return [fn(*(r[start:start + MIX_BATCH] for r in rows))
            for start in range(0, rows[0].shape[0], MIX_BATCH)]


def check_sequence_kernels(torch, card, model, test):
    """K1 and K2 with mixture scoring, once each on the main path's own
    operands at its batch of 2,048 sequences (the prefixes of
    ``sequence_mrr_score`` and of ``sequence_precision_recall_score`` at
    k=10), so the launch grid is the one the main path ran; their plain
    versions in MIX_BATCH-sequence slices.  Counts and ids must be equal,
    scores within 2 ulp.  K3, which has no launch of its own, is held by
    K4's target scores and K2's top-k scores against the plain catalogue
    pass.  Returns the kernel-table entries of K1, K2 and K3 with mixture
    scoring."""
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    reprs, items, bias, mixtures = model._rank_factors_sequences(
        test.sequences[:, :-1])
    targets = torch.as_tensor(test.sequences[:, -1:].astype(np.int64),
                              device=DEVICE)
    batch = reprs.shape[0]
    shape = 'B={} N={} D={} M={}'.format(batch, NUM_ITEMS, D, mixtures)
    scoring = mixture_ops(batch, NUM_ITEMS, mixtures)
    table_bytes = 4 * NUM_ITEMS * (D + 1) + 4 * reprs.numel()

    def catalogue_at(users, ids):
        return torch.gather(ranking.plain_mixture_scores(
            users, items, bias, mixtures).T, 1, ids.long())

    ts = ranking.matched_candidate_scores(reprs, items, bias, targets,
                                          mixtures)
    k3_gap = ulp_gap(torch, ts, torch.cat(sliced(catalogue_at, reprs,
                                                 targets)))
    weights = ranking.rank_weights(reprs, items, bias, ts, mixtures)
    plain = torch.cat(sliced(
        lambda u, t: ranking.rank_weights_plain(u, items, bias, t,
                                                mixtures), reprs, ts))
    if not torch.equal(weights, plain) or k3_gap > 2:
        raise AssertionError(
            'mixture rank_weights at B={} differs from its plain version: '
            '{} weights, K4 {} ulp from the catalogue pass'.format(
                batch, int((weights != plain).sum()), k3_gap))
    if not bool((weights >= 0.5).all()):
        raise AssertionError('a mixture target lost its self-tie')
    k1m = mixture_entry(
        torch, card, 'rank_weights (mixture)', 'ranking.cu',
        'spotlight_tpu/ops/kernels/ranking.py:107', shape + ' T=1',
        lambda: ranking.rank_weights(reprs, items, bias, ts, mixtures),
        lambda: sliced(lambda u, t: ranking.rank_weights_plain(
            u, items, bias, t, mixtures), reprs, ts),
        scoring + 2 * batch * NUM_ITEMS, table_bytes + 8 * batch, 0, 0.0)

    reprs_k = model._rank_factors_sequences(test.sequences[:, :-SEQ_K])[0]
    scores, top = topk.streaming_topk(reprs_k, items, bias, SEQ_K, mixtures)
    pairs = sliced(lambda u: topk.streaming_topk_plain(u, items, bias, SEQ_K,
                                                       mixtures), reprs_k)
    p_scores = torch.cat([p[0] for p in pairs])
    p_top = torch.cat([p[1] for p in pairs])
    # The plain top-k scores are the plain catalogue pass's.
    gap = ulp_gap(torch, scores, p_scores)
    if not torch.equal(top, p_top) or gap > 2:
        raise AssertionError(
            'mixture streaming_topk at B={} k={} differs from its plain '
            'version: {} ids, {} ulp'.format(batch, SEQ_K,
                                             int((top != p_top).sum()), gap))
    k2m = mixture_entry(
        torch, card, 'streaming_topk (mixture)', 'topk.cu',
        'spotlight_tpu/ops/kernels/topk.py:62', shape + ' k={}'.format(SEQ_K),
        lambda: topk.streaming_topk(reprs_k, items, bias, SEQ_K, mixtures),
        lambda: sliced(lambda u: topk.streaming_topk_plain(
            u, items, bias, SEQ_K, mixtures), reprs_k),
        scoring + batch * NUM_ITEMS, table_bytes + 8 * batch * SEQ_K, gap,
        float((scores - p_scores).abs().max()))

    # K3 runs inside K1, K2 and K4 and has no launch of its own: its time
    # is the T=1 rank pass's, whose work it is.
    k3 = mixture_entry(
        torch, card, 'mixture_score', 'common.cuh',
        'spotlight_tpu/ops/kernels/ranking.py:78', shape, None,
        lambda: sliced(lambda u: ranking.plain_mixture_scores(
            u, items, bias, mixtures), reprs),
        scoring, table_bytes + 4 * batch * NUM_ITEMS, max(k3_gap, gap), 0.0,
        ms=k1m['ms'])
    torch.cuda.empty_cache()
    return {'rank_weights (mixture)': k1m, 'streaming_topk (mixture)': k2m,
            'mixture_score': k3}


def check_duplicated_row_tie(torch, card, model, test):
    """Item 6 becomes a copy of item 5's fused row and 5 the target of
    every sequence: each streaming rank must equal the exact average-tie
    rank that the plain catalogue pass (bit-equal to the kernels) gives,
    with items 5 and 6 in one tie.  That rank is k + 0.5 unless a third
    item's score happens to equal the pair's exactly, which 200,000
    float32 scores make likely for a few of 256 sequences; those are
    counted and printed."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.evaluation import sequence_mrr_score
    from spotlight_tpu_torch.ops.kernels import ranking

    saved = {name: value.clone()
             for name, value in model._net.state_dict().items()}
    state = {name: value.clone() for name, value in saved.items()}
    table = state['item_embeddings.weight']
    table[6] = table[5]
    model._load_params(state)
    doctored = test.sequences[:SEQ_CHECK].copy()
    doctored[:, -1] = 5
    mrr = sequence_mrr_score(model, SequenceInteractions(
        doctored, num_items=NUM_ITEMS))
    reprs, items, bias, mixtures = model._rank_factors_sequences(
        doctored[:, :-1])
    scores = ranking.plain_mixture_scores(reprs, items, bias, mixtures)
    target = scores[5]
    if not torch.equal(scores[6], target):
        raise AssertionError('the duplicated row scored apart')
    greater = (scores > target).sum(dim=0).double()
    equal = (scores == target).sum(dim=0).double()
    want = (greater + (equal + 1) * 0.5).cpu().numpy()
    model._load_params(saved)
    np.testing.assert_allclose(1.0 / mrr.astype(np.float64), want,
                               rtol=1e-6, atol=0)
    extra = np.flatnonzero(equal.cpu().numpy() > 2)
    log(check='duplicated row ties', sequences=SEQ_CHECK,
        ranks_k_plus_half=int(np.sum(want % 1 == 0.5)),
        extra_exact_ties=[(int(b), int(equal[b]), float(want[b]))
                          for b in extra], card=card)


# -- phase 7: the bloom sequence slice at full width -------------------------

def bloom_model():
    """The untrained bloom LSTM model of
    examples/bloom_embeddings/performance.py at 1e6 items, seeded (row 0 of
    the compressed table and the item biases zero), and the sequences."""
    import torch

    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.ops.embeddings import BloomEmbedding
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel, LSTMNet

    sequences = np.random.RandomState(42).randint(
        1, BLOOM_ITEMS, (SEQ_ROWS, SEQ_LENGTH)).astype(np.int32)
    generator = torch.Generator().manual_seed(0)
    net = LSTMNet(BLOOM_ITEMS, embedding_dim=D,
                  item_embedding_layer=BloomEmbedding(
                      BLOOM_ITEMS, D, compression_ratio=BLOOM_RATIO,
                      num_hash_functions=BLOOM_HASHES, generator=generator),
                  generator=generator)
    model = ImplicitSequenceModel(loss='bpr', representation=net)
    model._initialize(SequenceInteractions(sequences, num_items=BLOOM_ITEMS))
    return model, sequences


def run_bloom_slice(torch, card):
    """Returns (launch counts of the main path, model, test set, the
    per-sequence values of ``sequence_mrr_score``)."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.evaluation import (
        sequence_mrr_score, sequence_precision_recall_score)
    from spotlight_tpu_torch.ops.kernels import ranking

    model, sequences = bloom_model()
    layer = model._net.item_embeddings
    if (model._net.fused or layer.compressed_num_embeddings != BLOOM_ROWS
            or bool(layer.weight[0].any())):
        raise AssertionError('the bloom model is not the configuration\'s')
    test = SequenceInteractions(sequences[:SEQ_EVAL], num_items=BLOOM_ITEMS)

    # The main path, with the launch counters zeroed just before it.
    torch.cuda.synchronize()
    reset_counters()
    seconds = {}
    start = time.perf_counter()
    scores = model.predict(sequences[0])
    seconds['predict'] = time.perf_counter() - start
    start = time.perf_counter()
    mrr = sequence_mrr_score(model, test)
    seconds['sequence_mrr_score'] = time.perf_counter() - start
    start = time.perf_counter()
    mrr_ex = sequence_mrr_score(model, test, exclude_preceding=True)
    seconds['sequence_mrr_score exclude_preceding'] = (time.perf_counter()
                                                       - start)
    start = time.perf_counter()
    precision, recall = sequence_precision_recall_score(model, test,
                                                        k=SEQ_K)
    seconds['sequence_precision_recall_score'] = (time.perf_counter()
                                                  - start)
    launches = counters()
    log(bloom_path_launches=launches)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError('{} never launched on the bloom path'
                                 .format(name))

    # predict against the plain catalogue pass of the same representation.
    final, items, bias, mixtures = model._rank_factors_sequences(
        sequences[:1])
    if mixtures is not None or items.shape != (BLOOM_ITEMS, D):
        raise AssertionError('the bloom catalogue is not (N, D) dot scoring')
    want = ranking.plain_scores(final, items, bias)[:, 0]
    if scores.shape != (BLOOM_ITEMS,) or not np.all(np.isfinite(scores)):
        raise AssertionError('predict: bad output {}'.format(scores.shape))
    np.testing.assert_allclose(scores, want.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)
    for name, values in (('sequence_mrr_score', mrr),
                         ('sequence_mrr_score exclude_preceding', mrr_ex)):
        if values.shape != (SEQ_EVAL,) or not (
                np.all(values > 0) and np.all(values <= 1)):
            raise AssertionError('{}: bad output'.format(name))
    for name, values in (('precision', precision), ('recall', recall)):
        if values.shape != (SEQ_EVAL,) or not (
                np.all(values >= 0) and np.all(values <= 1)):
            raise AssertionError('{}: bad output'.format(name))

    calls = {
        'sequence_mrr_score': lambda: sequence_mrr_score(model, test),
        'sequence_mrr_score exclude_preceding': lambda: sequence_mrr_score(
            model, test, exclude_preceding=True),
        'sequence_precision_recall_score':
            lambda: sequence_precision_recall_score(model, test, k=SEQ_K)}
    for name, call in calls.items():
        torch.cuda.synchronize()
        start = time.perf_counter()
        call()
        warm_s = time.perf_counter() - start
        log(bloom_slice=name, sequences=SEQ_EVAL, items=BLOOM_ITEMS,
            first_s=seconds[name], warm_s=warm_s,
            sequences_per_s=SEQ_EVAL / warm_s,
            g_item_scores_per_s=SEQ_EVAL * BLOOM_ITEMS / warm_s / 1e9,
            card=card)
    log(bloom_slice='predict', seconds=seconds['predict'],
        mean_mrr=float(mrr.mean()), mean_mrr_exclude=float(mrr_ex.mean()),
        mean_precision=float(precision.mean()), card=card)

    check_streaming_against_materialize(torch, model, sequences[:SEQ_CHECK],
                                        BLOOM_ITEMS)
    return launches, model, test, mrr


# -- phase 8: the kernel entry points on the bloom model's operands ----------

def bloom_counters():
    from spotlight_tpu_torch.ops.kernels import bloom, multihot, ranking

    return {'rank_counts': ranking.RANK_COUNTS_LAUNCHES,
            'rank_counts (mixture)': ranking.MIXTURE_RANK_COUNTS_LAUNCHES,
            'bloom_gather_sum': bloom.BLOOM_GATHER_LAUNCHES,
            'bloom_gather_sum backward':
                bloom.BLOOM_GATHER_BACKWARD_LAUNCHES,
            'multihot_gather_sum': multihot.MULTIHOT_LAUNCHES,
            'multihot_gather_sum backward':
                multihot.MULTIHOT_BACKWARD_LAUNCHES}


def reset_bloom_counters():
    from spotlight_tpu_torch.ops.kernels import bloom, multihot, ranking

    ranking.RANK_COUNTS_LAUNCHES = 0
    ranking.MIXTURE_RANK_COUNTS_LAUNCHES = 0
    bloom.BLOOM_GATHER_LAUNCHES = 0
    bloom.BLOOM_GATHER_BACKWARD_LAUNCHES = 0
    multihot.MULTIHOT_LAUNCHES = 0
    multihot.MULTIHOT_BACKWARD_LAUNCHES = 0


def bits(torch, x):
    """The raw bits of a float32 or bfloat16 tensor (-0.0 apart from
    +0.0), for comparisons bit for bit."""
    return x.detach().view(torch.int16 if x.dtype == torch.bfloat16
                           else torch.int32)


def rank_counts_bytes(batch, num_items, width, targets):
    """Bytes K5 must move: the items, their bias, the users, and per
    target a score and an id in, two counts out."""
    return 4 * num_items * (D + 1) + 4 * batch * width + 16 * batch * targets


def check_bloom_kernels(torch, card, model, test, mrr, mix_model, mix_test):
    """The kernel entry points K5, K6, K7f and K7b on the bloom model's
    operands, driven once with their launch counters zeroed just before
    and read just after (the returned launches); then each result held
    against its plain version and the yardsticks, and each timed.  Returns
    the kernel-table entries."""
    from spotlight_tpu_torch.ops.kernels import bloom, multihot, ranking

    reprs, items, bias, _ = model._rank_factors_sequences(
        test.sequences[:, :-1])
    targets = torch.as_tensor(test.sequences[:, -1:].astype(np.int64),
                              device=DEVICE)
    mask = torch.ones_like(targets, dtype=torch.bool)
    mix_reprs, mix_items, mix_bias, mixtures = (
        mix_model._rank_factors_sequences(mix_test.sequences[:MIX_BATCH,
                                                             :-1]))
    generator = torch.Generator(device=DEVICE)
    generator.manual_seed(3)
    mix_ids = torch.randint(1, NUM_ITEMS, (MIX_BATCH, 4), generator=generator,
                            device=DEVICE)
    layer = model._net.item_embeddings
    table = layer.weight
    all_items = torch.arange(BLOOM_ITEMS, device=DEVICE)
    rows = layer.hashed_rows(all_items)
    cotangent = torch.randn(BLOOM_ITEMS, D, generator=generator,
                            device=DEVICE)

    # The path: each entry point once, counters zeroed just before.
    torch.cuda.synchronize()
    reset_bloom_counters()
    rr = ranking.reciprocal_ranks_streaming(reprs, items, bias, targets,
                                            mask)
    mix_ts = ranking.matched_candidate_scores(mix_reprs, mix_items, mix_bias,
                                              mix_ids, mixtures)
    mix_counts = ranking.rank_counts(mix_reprs, mix_items, mix_bias, mix_ts,
                                     mix_ids, mixtures)
    multihot_out = multihot.multihot_gather_sum(table, rows,
                                                mask_row_zero=True)
    multihot_grad, = torch.autograd.grad((multihot_out * cotangent).sum(),
                                         table)
    bloom_out = bloom.bloom_gather_sum(table, rows)
    bloom_grad, = torch.autograd.grad((bloom_out * cotangent).sum(), table)
    torch.cuda.synchronize()
    launches = bloom_counters()
    log(bloom_kernel_path_launches=launches)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError('{} never launched on the kernel entry '
                                 'points\' path'.format(name))
    entries = {}

    # K5: the K1 identity on the metric's own operands, bit for bit.
    rr = rr.cpu().numpy()
    if not np.array_equal(rr.view(np.int32), mrr.view(np.int32)):
        raise AssertionError(
            'reciprocal_ranks_streaming differs from sequence_mrr_score on '
            '{} of {} sequences'.format(int((rr != mrr).sum()), len(mrr)))
    ts = ranking.matched_target_scores(reprs, items, bias, targets)
    greater, equal = ranking.rank_counts(reprs, items, bias, ts, targets)
    plain_greater, plain_equal = (torch.cat(part) for part in zip(*sliced(
        lambda u, t, i: ranking.rank_counts_plain(u, items, bias, t, i),
        reprs, ts, targets)))
    if not (torch.equal(greater, plain_greater)
            and torch.equal(equal, plain_equal)):
        raise AssertionError(
            'rank_counts differs from its plain version on the bloom '
            'model\'s operands: {} greater, {} equal counts'.format(
                int((greater != plain_greater).sum()),
                int((equal != plain_equal).sum())))
    del plain_greater, plain_equal
    weights = ranking.rank_weights(reprs, items, bias, ts)
    if not torch.equal(weights, greater + 0.5 * (equal + 1.0)):
        raise AssertionError('rank_weights != greater + (equal + 1) / 2')
    batch = reprs.shape[0]
    shape = 'B={} N={} D={} T=1'.format(batch, BLOOM_ITEMS, D)
    entries['rank_counts'] = kernel_entry(
        'rank_counts', 'ranking.cu',
        'spotlight_tpu/ops/kernels/ranking.py:273', shape,
        median_ms(torch, lambda: ranking.rank_counts(reprs, items, bias, ts,
                                                     targets), KERNEL_REPS),
        median_ms(torch, lambda: sliced(
            lambda u, t, i: ranking.rank_counts_plain(u, items, bias, t, i),
            reprs, ts, targets), 2),
        2 * batch * BLOOM_ITEMS * D + 3 * batch * BLOOM_ITEMS,
        rank_counts_bytes(batch, BLOOM_ITEMS, D, 1), 0.0)
    log(kernel_case=entries['rank_counts'], card=card)

    check_rank_counts_shapes(torch, card)

    # K5 with mixture scoring, on the mixture model's operands.
    mix_plain = ranking.rank_counts_plain(mix_reprs, mix_items, mix_bias,
                                          mix_ts, mix_ids, mixtures)
    if not (torch.equal(mix_counts[0], mix_plain[0])
            and torch.equal(mix_counts[1], mix_plain[1])):
        raise AssertionError('mixture rank_counts differs from its plain '
                             'version')
    mix_weights = ranking.rank_weights(mix_reprs, mix_items, mix_bias,
                                       mix_ts, mixtures)
    if not torch.equal(mix_weights, mix_counts[0]
                       + 0.5 * (mix_counts[1] + 1.0)):
        raise AssertionError('mixture rank_weights != greater + (equal + '
                             '1) / 2')
    entries['rank_counts (mixture)'] = kernel_entry(
        'rank_counts (mixture)', 'ranking.cu',
        'spotlight_tpu/ops/kernels/ranking.py:273',
        'B={} N={} D={} M={} T=4'.format(MIX_BATCH, NUM_ITEMS, D, mixtures),
        median_ms(torch, lambda: ranking.rank_counts(
            mix_reprs, mix_items, mix_bias, mix_ts, mix_ids, mixtures),
            KERNEL_REPS),
        median_ms(torch, lambda: ranking.rank_counts_plain(
            mix_reprs, mix_items, mix_bias, mix_ts, mix_ids, mixtures),
            PLAIN_REPS),
        mixture_ops(MIX_BATCH, NUM_ITEMS, mixtures) + 3 * 4 * MIX_BATCH
        * NUM_ITEMS,
        rank_counts_bytes(MIX_BATCH, NUM_ITEMS, 2 * mixtures * D, 4), 0.0)
    log(kernel_case=entries['rank_counts (mixture)'], card=card)
    del mix_plain, mix_weights
    torch.cuda.empty_cache()

    entries.update(check_lookups(torch, card, layer, rows, cotangent, items,
                                 multihot_out, multihot_grad, bloom_out,
                                 bloom_grad))
    return launches, entries


def check_rank_counts_shapes(torch, card):
    """K5 at the repo's own shape (scripts/bench_suite.py:355-381: B=256,
    D=64, N=100,000, T=16, RandomState(0) normals) against its plain
    version, and four quarter-catalogue calls with shifted target ids (the
    per-shard shape, :419-449), whose counts must add up to the one pass's
    exactly."""
    from spotlight_tpu_torch.ops.kernels import ranking

    rs = np.random.RandomState(0)
    batch, num_items, width = 256, 100_000, 16
    users, items, bias = (torch.as_tensor(part.astype(np.float32),
                                          device=DEVICE)
                          for part in (rs.randn(batch, D),
                                       rs.randn(num_items, D),
                                       rs.randn(num_items)))
    ids = torch.as_tensor(rs.randint(0, num_items, (batch, width)),
                          device=DEVICE)
    ts = ranking.matched_target_scores(users, items, bias, ids)
    greater, equal = ranking.rank_counts(users, items, bias, ts, ids)
    plain = ranking.rank_counts_plain(users, items, bias, ts, ids)
    if not (torch.equal(greater, plain[0]) and torch.equal(equal, plain[1])):
        raise AssertionError('rank_counts differs from its plain version at '
                             'B=256 N=100000 T=16')
    local = num_items // 4

    def quarters():
        counts = [torch.zeros_like(greater), torch.zeros_like(equal)]
        for shard in range(4):
            part = slice(shard * local, (shard + 1) * local)
            for total, count in zip(counts, ranking.rank_counts(
                    users, items[part], bias[part], ts,
                    ids - shard * local)):
                total += count
        return counts

    summed = quarters()
    if not (torch.equal(summed[0], greater) and torch.equal(summed[1],
                                                            equal)):
        raise AssertionError('four quarter-catalogue rank_counts do not add '
                             'up to the one pass')
    entry = kernel_entry(
        'rank_counts', 'ranking.cu',
        'spotlight_tpu/ops/kernels/ranking.py:273',
        'B={} N={} D={} T={}'.format(batch, num_items, D, width),
        median_ms(torch, lambda: ranking.rank_counts(users, items, bias, ts,
                                                     ids), KERNEL_REPS),
        median_ms(torch, lambda: ranking.rank_counts_plain(
            users, items, bias, ts, ids), PLAIN_REPS),
        2 * batch * num_items * D + 3 * batch * width * num_items,
        rank_counts_bytes(batch, num_items, D, width), 0.0,
        four_quarters_ms=median_ms(torch, quarters, KERNEL_REPS))
    log(kernel_case=entry, card=card)


def lookup_bytes(batch, hashes, dim, touched, size=4):
    """Bytes a gather-sum must move: the rows (int32), each table row it
    touches once, the (B, D) output.  The re-reads of a row are not
    counted (each input byte once); they are the ``gathered_bytes``."""
    return 4 * batch * hashes + size * dim * touched + size * batch * dim


def scatter_bytes(batch, hashes, dim, num_rows, size=4):
    """Bytes the backward must move: the (B, D) cotangent, the rows
    (int32), the (C, D) table gradient."""
    return size * batch * dim + 4 * batch * hashes + size * num_rows * dim


def check_lookups(torch, card, layer, rows, cotangent, items, multihot_out,
                  multihot_grad, bloom_out, bloom_grad):
    """K7f, K6 and their backward over the whole catalogue of the bloom
    model (the path's own results), each against its plain version bit for
    bit, the forward against the layer's own lookup (the densified
    catalogue ``items``), the backward against a second launch bit for bit
    and against ``index_add_``; then each timed beside its plain version
    and its ``embedding_bag`` yardstick, and K7f beside the layer's own
    forward (hashing included, and the hashing alone), which it could
    replace.  Returns the kernel-table entries."""
    import torch.nn.functional as F

    from spotlight_tpu_torch.ops.kernels import bloom, gather_sum, multihot

    table = layer.weight
    weight = table.detach()
    batch, hashes = rows.shape
    num_rows = weight.shape[0]
    flat = rows.reshape(-1).long()
    touched = int(torch.unique(flat).numel())
    touched_unmasked = touched - int(bool((flat == 0).any()))
    tiny = torch.finfo(torch.float32).tiny

    # Forward: bit-equal to the plain versions; the layer's forward sums
    # the same four terms (its mask where row == 0 is K7f's).
    if not torch.equal(bits(torch, multihot_out), bits(
            torch, multihot.multihot_gather_sum_plain(weight, rows, True))):
        raise AssertionError('multihot_gather_sum differs from its plain '
                             'version')
    if not torch.equal(bits(torch, bloom_out), bits(
            torch, bloom.bloom_gather_sum_plain(weight, rows))):
        raise AssertionError('bloom_gather_sum differs from its plain '
                             'version')
    magnitude = multihot.multihot_gather_sum_plain(weight.abs(), rows, True)
    gap = (multihot_out.detach() - items).abs()
    if bool((gap > 1e-6 * magnitude).any()):
        raise AssertionError('multihot_gather_sum is more than 1e-6 of the '
                             'terms\' magnitude from the layer\'s forward')
    log(check='multihot_gather_sum(mask_row_zero) == BloomEmbedding.forward',
        ids=batch, exact=bool(torch.equal(bits(torch, multihot_out),
                                          bits(torch, items))),
        elements_apart=int((multihot_out != items).sum()),
        largest_gap_of_magnitude=float((gap / magnitude.clamp(min=tiny))
                                       .max()), card=card)
    del gap, magnitude

    # Backward: bit-equal to the order-fixing plain version and to a second
    # launch, within 1e-5 of the terms' magnitude of index_add_.
    repeated = cotangent.repeat_interleave(hashes, dim=0)
    witness = torch.zeros_like(weight).index_add_(0, flat, repeated)
    magnitude = torch.zeros_like(weight).index_add_(0, flat, repeated.abs())
    del repeated
    backward_cases = (
        ('multihot_gather_sum backward', multihot_grad, True,
         lambda: multihot.multihot_gather_sum(table, rows, True),
         lambda: multihot.multihot_gather_sum_backward_plain(
             cotangent, rows, num_rows, True, weight.dtype)),
        ('bloom_gather_sum backward', bloom_grad, False,
         lambda: bloom.bloom_gather_sum(table, rows),
         lambda: bloom.bloom_gather_sum_backward_plain(cotangent, rows,
                                                       num_rows)))
    graphs = {}
    for name, grad, masked, forward, plain in backward_cases:
        out = forward()
        again, = torch.autograd.grad(out, table, cotangent,
                                     retain_graph=True)
        graphs[name] = out
        want = witness.clone()
        if masked:
            want[0] = 0.0
        gap = float(((grad - want).abs() - 1e-5 * magnitude).max())
        checks = {
            'equals its plain version': torch.equal(
                bits(torch, grad), bits(torch, plain())),
            'same bits in two launches': torch.equal(bits(torch, grad),
                                                     bits(torch, again)),
            'within 1e-5 of index_add_': gap <= 0.0,
            'row 0 zero under the mask': not masked or not bool(
                bits(torch, grad[0]).any())}
        log(check=name, rows=num_rows, **checks, card=card)
        failed = [what for what, ok in checks.items() if not ok]
        if failed:
            raise AssertionError('{}: {}'.format(name, ', '.join(failed)))
    del witness, magnitude

    shape = 'B={} k={} C={} D={} f32'.format(batch, hashes, num_rows, D)
    adds = batch * (hashes - 1) * D
    rows32 = rows.to(torch.int32)
    entries = {}
    for name, masked, fn, plain, library in (
            ('multihot_gather_sum', True,
             lambda: multihot.multihot_gather_sum(weight, rows, True),
             lambda: multihot.multihot_gather_sum_plain(weight, rows, True),
             lambda: F.embedding_bag(rows, weight, mode='sum',
                                     padding_idx=0)),
            ('bloom_gather_sum', False,
             lambda: bloom.bloom_gather_sum(weight, rows),
             lambda: bloom.bloom_gather_sum_plain(weight, rows),
             lambda: F.embedding_bag(rows, weight, mode='sum'))):
        replaces = ('spotlight_tpu/ops/kernels/multihot.py:74' if masked
                    else 'spotlight_tpu/ops/kernels/bloom.py:34')
        entries[name] = kernel_entry(
            name, 'gather_sum.cu', replaces, shape,
            median_ms(torch, fn, KERNEL_REPS),
            median_ms(torch, plain, PLAIN_REPS), adds,
            lookup_bytes(batch, hashes, D,
                         touched_unmasked if masked else touched), 0.0,
            library_ms=median_ms(torch, library, KERNEL_REPS),
            launch_only_ms=median_ms(torch, lambda: gather_sum.gather_sum_cuda(
                weight, rows32, masked, not masked), KERNEL_REPS),
            gathered_bytes=4 * batch * hashes * D)
        log(kernel_case=entries[name], card=card)
    all_items = torch.arange(batch, device=DEVICE)
    with torch.no_grad():
        entries['multihot_gather_sum'].update(
            layer_forward_ms=median_ms(torch, lambda: layer(all_items),
                                       KERNEL_REPS),
            layer_hash_ms=median_ms(torch, lambda: layer.hashed_rows(
                all_items), KERNEL_REPS))
    log(layer_forward=entries['multihot_gather_sum'], card=card)

    backward_ops = (batch * hashes - touched) * D
    for name, masked, plain in (
            ('multihot_gather_sum backward', True,
             lambda: multihot.multihot_gather_sum_backward_plain(
                 cotangent, rows, num_rows, True, weight.dtype)),
            ('bloom_gather_sum backward', False,
             lambda: bloom.bloom_gather_sum_backward_plain(cotangent, rows,
                                                           num_rows))):
        out = graphs[name]
        library_out = F.embedding_bag(rows, table, mode='sum',
                                      padding_idx=0 if masked else None)
        replaces = ('spotlight_tpu/ops/kernels/multihot.py:102' if masked
                    else 'spotlight_tpu/ops/kernels/bloom.py:151')
        entries[name] = kernel_entry(
            name, 'gather_sum.cu', replaces, shape,
            median_ms(torch, lambda: torch.autograd.grad(
                out, table, cotangent, retain_graph=True), KERNEL_REPS),
            median_ms(torch, plain, PLAIN_REPS), backward_ops,
            scatter_bytes(batch, hashes, D, num_rows), 0.0,
            library_ms=median_ms(torch, lambda: torch.autograd.grad(
                library_out, table, cotangent, retain_graph=True),
                KERNEL_REPS))
        log(kernel_case=entries[name], card=card)
    del graphs
    torch.cuda.empty_cache()
    return entries


def check_lookup_shapes(torch, card):
    """Forward and forward + backward of both gather-sums at the bloom
    benchmark's shapes (scripts/bloom_kernel_bench.py: B=8,192, k=4,
    C in {4,096, 65,536, 262,144}, D in {64, 128}, float32, RandomState(0)),
    each held against its plain version bit for bit, beside the
    ``embedding_bag`` yardstick; then one bfloat16 table through each entry
    point and its backward against the plain versions."""
    import torch.nn.functional as F

    from spotlight_tpu_torch.ops.kernels import bloom, multihot

    batch, hashes = LOOKUP_BATCH, BLOOM_HASHES

    def operands(num_rows, dim, dtype):
        rs = np.random.RandomState(0)
        table = torch.as_tensor(rs.randn(num_rows, dim).astype(np.float32),
                                device=DEVICE).to(dtype).requires_grad_(True)
        rows = torch.as_tensor(rs.randint(0, num_rows, (batch, hashes)),
                               device=DEVICE)
        cotangent = torch.as_tensor(rs.randn(batch, dim).astype(np.float32),
                                    device=DEVICE).to(dtype)
        return table, rows, cotangent

    def both(fn, table, rows, cotangent):
        out = fn(table, rows)
        return out, torch.autograd.grad(out, table, cotangent)[0]

    entry_points = (
        ('bloom_gather_sum', bloom.bloom_gather_sum,
         lambda t, r, g: (bloom.bloom_gather_sum_plain(t, r),
                          bloom.bloom_gather_sum_backward_plain(
                              g, r, t.shape[0]))),
        ('multihot_gather_sum', multihot.multihot_gather_sum,
         lambda t, r, g: (multihot.multihot_gather_sum_plain(t, r),
                          multihot.multihot_gather_sum_backward_plain(
                              g, r, t.shape[0], False, t.dtype))))
    for num_rows in LOOKUP_ROWS:
        for dim in (64, 128):
            table, rows, cotangent = operands(num_rows, dim, torch.float32)
            touched = int(torch.unique(rows).numel())
            case = dict(shape='B={} k={} C={} D={} f32'.format(
                batch, hashes, num_rows, dim))
            for name, fn, plain in entry_points:
                got = both(fn, table, rows, cotangent)
                want = plain(table.detach(), rows.to(torch.int32), cotangent)
                if not all(torch.equal(bits(torch, a), bits(torch, b))
                           for a, b in zip(got, want)):
                    raise AssertionError('{} differs from its plain version '
                                         'at {}'.format(name, case['shape']))
                case[name + ' ms'] = median_ms(
                    torch, lambda: fn(table.detach(), rows), KERNEL_REPS)
                case[name + ' fwd+bwd ms'] = median_ms(
                    torch, lambda: both(fn, table, rows, cotangent),
                    KERNEL_REPS)
            case['embedding_bag ms'] = median_ms(
                torch, lambda: F.embedding_bag(rows, table.detach(),
                                               mode='sum'), KERNEL_REPS)
            case['embedding_bag fwd+bwd ms'] = median_ms(
                torch, lambda: both(lambda t, r: F.embedding_bag(
                    r, t, mode='sum'), table, rows, cotangent), KERNEL_REPS)
            case['forward bound ms'] = bound(
                batch * (hashes - 1) * dim,
                lookup_bytes(batch, hashes, dim, touched))[0]
            case['backward bound ms'] = bound(
                (batch * hashes - touched) * dim,
                scatter_bytes(batch, hashes, dim, num_rows))[0]
            log(lookup_shape=case, card=card)

    table, rows, cotangent = operands(65_536, 64, torch.bfloat16)
    for name, fn, plain in entry_points:
        got = both(fn, table, rows, cotangent)
        want = plain(table.detach(), rows.to(torch.int32), cotangent)
        equal = [torch.equal(bits(torch, a), bits(torch, b))
                 for a, b in zip(got, want)]
        log(check=name + ' bf16 table', shape='B={} k={} C=65536 D=64'
            .format(batch, hashes), forward_equal=equal[0],
            backward_equal=equal[1], dtype=str(got[0].dtype), card=card)
        if not all(equal) or got[0].dtype != torch.bfloat16:
            raise AssertionError('{} with a bf16 table differs from its plain '
                                 'version'.format(name))


# -- phase 9: training -------------------------------------------------------

def row_update_bytes(distinct, n, width, param_size, fused=False):
    """Bytes P1 must move: each distinct row's parameters, ``mu`` and ``nu``
    read and written once, each occurrence's float32 gradient row read once,
    and the index arrays (order, offsets, segment rows, the count; with
    ``fused`` the occurrence ids and the sort's own output too)."""
    index = 12 * n + 8 + (8 * n if fused else 0)
    return distinct * width * 2 * (param_size + 8) + 4 * n * width + index


def row_update_ops(distinct, n, width):
    """float32 operations of P1: the occurrence sums, and per element of a
    distinct row the l2 term, the two moments, the bias corrections, the
    square root, the step and the addition (about 15)."""
    return n * width + 15 * distinct * width


def sparse_adam_yardstick(torch, param, mu, nu, ids, grads, t, lr):
    """``torch.optim.SparseAdam``'s step ``t`` from the moments ``mu`` and
    ``nu`` on the coalesced sparse gradient of the occurrences, against
    P1's step ``t`` (l2=0) from the same state: the same function in
    another rounding order (rtol 1e-5).  SparseAdam adds ``eps`` to
    ``sqrt(v)`` before the bias correction, P1 (as optax) to
    ``sqrt(v_hat)``: with its ``eps`` scaled by ``sqrt(1 - b2 ** t)`` the
    steps are one function.  Returns (median ms of one step, largest
    gap)."""
    from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows
    from spotlight_tpu_torch.utils.training import B2, EPS

    weight = torch.nn.Parameter(param.clone())
    optimizer = torch.optim.SparseAdam([weight], lr=lr,
                                       eps=EPS * (1 - B2 ** t) ** 0.5)
    optimizer.state[weight] = {'step': t - 1, 'exp_avg': mu.clone(),
                               'exp_avg_sq': nu.clone()}
    weight.grad = torch.sparse_coo_tensor(
        ids[None].long(), grads, param.shape,
        check_invariants=False).coalesce()
    optimizer.step()
    ours = param.clone()
    sparse_adam_rows(ids, ours, mu.clone(), nu.clone(), grads, t, lr)
    torch.testing.assert_close(weight.detach(), ours, rtol=1e-5, atol=1e-6)
    gap = float((weight.detach() - ours).abs().max())
    ms = median_ms(torch, optimizer.step, KERNEL_REPS)
    del weight, optimizer, ours
    return ms, gap


def check_row_update(torch, card, shape, param, mu, nu, ids, grads, t, lr,
                     l2, library=False, timed=True):
    """P1 against its plain version on one operand set: ``param``, ``mu``
    and ``nu`` bit for bit, in two launches, for the occurrence form and
    for the probe's pre-deduplicated form (unique rows, pre-summed
    gradients); then, with ``timed``: the kernel alone on the deduplicated
    rows (the probe's ``pallas_kernel_only``), the index preparation and
    the kernel (``pallas_fused``), the plain version and, with ``library``
    (l2=0, a float32 table), ``torch.optim.SparseAdam`` from the same
    moments.  Returns the kernel-table entry (None unless ``timed``)."""
    from spotlight_tpu_torch.ops.kernels import row_update

    segments = row_update.prepare_segments(ids)
    scalars = row_update.adam_scalars(t, lr, l2)
    distinct = int(segments.count)
    summed = row_update.segment_sums_plain(grads, segments, distinct)
    unique = row_update.Segments(
        torch.arange(distinct, dtype=torch.int32, device=ids.device),
        torch.arange(distinct + 1, dtype=torch.int32, device=ids.device),
        segments.rows[:distinct].contiguous(), segments.count)

    def run(fn, segs, rows):
        tables = (param.clone(), mu.clone(), nu.clone())
        fn(*tables, rows, segs, scalars)
        return tables

    want = run(row_update.row_adam_plain, segments, grads)
    for form, segs, rows in (('occurrences', segments, grads),
                             ('deduplicated', unique, summed)):
        for launch in range(2):
            got = run(row_update.row_adam, segs, rows)
            torch.cuda.synchronize()
            for name, a, b in zip(('param', 'mu', 'nu'), got, want):
                if not torch.equal(bits(torch, a), bits(torch, b)):
                    raise AssertionError(
                        'row_adam ({}, launch {}) differs from its plain '
                        'version in {} at {}: {} elements'.format(
                            form, launch, name, shape,
                            int((bits(torch, a) != bits(torch, b)).sum())))
            del got
    moved = float((want[0].float() - param.float()).abs().max())
    del want
    if not timed:
        log(check='row_adam bit-equal to its plain version, twice',
            shape=shape, card=card)
        return None

    p, m, v = param.clone(), mu.clone(), nu.clone()
    kernel_ms = median_ms(
        torch, lambda: row_update.row_adam(p, m, v, summed, unique, scalars),
        KERNEL_REPS)
    fused_ms = median_ms(
        torch, lambda: row_update.row_adam(
            p, m, v, grads, row_update.prepare_segments(ids), scalars),
        KERNEL_REPS)
    plain_ms = median_ms(
        torch, lambda: row_update.row_adam_plain(
            p, m, v, grads, row_update.prepare_segments(ids), scalars),
        PLAIN_REPS)
    del p, m, v
    library_ms = library_gap = None
    if library:
        library_ms, library_gap = sparse_adam_yardstick(
            torch, param, mu, nu, ids, grads, t, lr)
    width = param.shape[1]
    size = param.element_size()
    entry = kernel_entry(
        'row_adam (P1)', 'row_update.cu', 'scripts/fused_rowupdate_probe.py:78',
        shape, fused_ms, plain_ms,
        row_update_ops(distinct, ids.numel(), width),
        row_update_bytes(distinct, ids.numel(), width, size, fused=True),
        0.0, library_ms=library_ms, kernel_only_ms=kernel_ms,
        kernel_only_bound_ms=bound(
            row_update_ops(distinct, distinct, width),
            row_update_bytes(distinct, distinct, width, size))[0],
        distinct_rows=distinct, occurrences=ids.numel(),
        library_max_abs_gap=library_gap, largest_step=moved)
    torch.cuda.empty_cache()
    log(kernel_case=entry, card=card)
    return entry


def check_probe_shapes(torch, card):
    """P1 at the probe's shapes (``scripts/fused_rowupdate_probe.py``):
    R + 8 rows of W=128 (R = 100,000 and 2,000,000), 24,576 occurrence ids
    from ``RandomState(0)`` as the probe draws them, t=5, lr=1e-2."""
    rs = np.random.RandomState(0)
    for rows in PROBE_ROWS:
        padded = rows + 8
        param = torch.from_numpy(rs.randn(padded, PROBE_WIDTH).astype(
            np.float32)).to(DEVICE)
        zeros = torch.zeros_like(param)
        ids = torch.from_numpy(rs.randint(0, rows, PROBE_IDS).astype(
            np.int32)).to(DEVICE)
        grads = torch.from_numpy((rs.randn(PROBE_IDS, PROBE_WIDTH) * 1e-2)
                                 .astype(np.float32)).to(DEVICE)
        check_row_update(torch, card, 'R={} W={} n={} f32 (probe)'.format(
            padded, PROBE_WIDTH, PROBE_IDS), param, zeros, zeros.clone(),
            ids, grads, 5, 1e-2, 0.0, library=True)
        del param, zeros, ids, grads
        torch.cuda.empty_cache()


def fit_interactions(num_users, num_items):
    """``FIT_PAIRS`` random (user, item) pairs from ``RandomState(42)``, as
    ``bench.py`` and ``bench_lazy_knobs`` draw them."""
    from spotlight_tpu_torch.data import Interactions

    rs = np.random.RandomState(42)
    return Interactions(rs.randint(0, num_users, FIT_PAIRS).astype(np.int64),
                        rs.randint(0, num_items, FIT_PAIRS).astype(np.int64),
                        num_users=num_users, num_items=num_items)


def capture_row_updates(step):
    """Wrap the lazy engine's ``sparse_adam_rows`` so that the operands of
    its two calls at ``step`` (1-based; the user table, then the item
    table) are cloned before they update.  Returns (captured list, undo)."""
    from spotlight_tpu_torch.factorization import lazy

    original = lazy.sparse_adam_rows
    captured = []
    calls = [0]

    def wrapper(ids, param, mu, nu, grad_rows, t, lr, l2=0.0):
        calls[0] += 1
        if (calls[0] + 1) // 2 == step:
            captured.append(dict(ids=ids.clone(), param=param.clone(),
                                 mu=mu.clone(), nu=nu.clone(),
                                 grads=grad_rows.clone(), t=t, lr=lr, l2=l2))
        return original(ids, param, mu, nu, grad_rows, t, lr, l2)

    lazy.sparse_adam_rows = wrapper

    def undo():
        lazy.sparse_adam_rows = original

    return captured, undo


def timed_fit(torch, model, interactions, epochs):
    """Seconds of one ``fit`` of ``epochs`` epochs, host clock; ``fit`` ends
    in the last epoch's loss readback.  Every epoch's loss is read back and
    checked finite and non-zero by the estimator's own guard."""
    model._n_iter = epochs
    torch.cuda.synchronize()
    start = time.perf_counter()
    model.fit(interactions)
    torch.cuda.synchronize()
    return time.perf_counter() - start


def run_lazy_training(torch, card):
    """The lazy engine at ``bench_lazy_knobs``' width: BPR, D=64, 2e6 users
    x 5e5 items, 1e6 pairs, batch 8,192, lr 1e-2.  One warm epoch (whose
    step ``CAPTURE_STEP`` row updates are captured), then ``LAZY_EPOCHS``
    timed epochs with the P1 counter zeroed just before and read just
    after.  Returns (launches, captured operands)."""
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.ops.kernels import row_update

    interactions = fit_interactions(LAZY_USERS, LAZY_ITEMS)
    model = ImplicitFactorizationModel(
        loss='bpr', embedding_dim=TRAIN_DIM, n_iter=1, batch_size=TRAIN_BATCH,
        learning_rate=1e-2, sparse=True,
        random_state=np.random.RandomState(42))
    captured, undo = capture_row_updates(CAPTURE_STEP)
    try:
        warm_s = timed_fit(torch, model, interactions, 1)
    finally:
        undo()
    if not model._lazy or len(captured) != 2:
        raise AssertionError('the lazy engine did not run')
    num_batches = -(-FIT_PAIRS // TRAIN_BATCH)

    # The main path, with the P1 counter zeroed just before it.
    row_update.ROW_ADAM_LAUNCHES = 0
    seconds = timed_fit(torch, model, interactions, LAZY_EPOCHS)
    launches = row_update.ROW_ADAM_LAUNCHES
    expected = 2 * num_batches * LAZY_EPOCHS
    log(main_path_launches={'row_adam (P1)': launches}, expected=expected)
    if launches != expected:
        raise AssertionError('row_adam launched {} times, not {}'.format(
            launches, expected))
    loss = model._last_epoch_loss
    if not np.isfinite(loss):
        raise AssertionError('lazy engine: epoch loss {}'.format(loss))
    log(training='lazy', config='bpr D={} {}x{} n={} B={}'.format(
        TRAIN_DIM, LAZY_USERS, LAZY_ITEMS, FIT_PAIRS, TRAIN_BATCH),
        warm_epoch_s=warm_s, epochs=LAZY_EPOCHS, seconds=seconds,
        examples_per_s=LAZY_EPOCHS * FIT_PAIRS / seconds,
        ms_per_step=seconds * 1e3 / (LAZY_EPOCHS * num_batches),
        last_epoch_loss=loss, card=card)
    model._n_iter = 1
    profile_call(torch, card, 'lazy training epoch',
                 lambda: model.fit(interactions))
    del model
    torch.cuda.empty_cache()
    return launches, captured


def check_engine_operands(torch, card, captured):
    """P1 on the lazy engine's own operands at full width (W=65), captured
    from one warm step: the user table's call (8,192 ids) and the item
    table's (16,384 ids, the positives and their negatives), float32 and
    bfloat16 tables.  At the call's own l2 (the engine's default, 0) each is
    timed, the float32 tables beside ``SparseAdam`` from the captured
    moments; at l2=1e-6 each is held bit for bit once more.  Returns the
    item call's float32 entry."""
    main = None
    for table, operands in zip(('user', 'item'), captured):
        grads = operands['grads'].reshape(operands['ids'].numel(),
                                          -1).float()
        for dtype in (torch.float32, torch.bfloat16):
            param = operands['param'].to(dtype)
            for l2 in dict.fromkeys((operands['l2'], 1e-6)):
                shape = '{} table R={} W={} n={} {} t={} l2={} (engine)'.format(
                    table, param.shape[0], param.shape[1],
                    operands['ids'].numel(), str(dtype).split('.')[-1],
                    operands['t'], l2)
                main_l2 = l2 == operands['l2']
                entry = check_row_update(
                    torch, card, shape, param, operands['mu'], operands['nu'],
                    operands['ids'], grads, operands['t'], operands['lr'], l2,
                    library=main_l2 and l2 == 0 and dtype == torch.float32,
                    timed=main_l2)
                if main_l2 and table == 'item' and dtype == torch.float32:
                    main = entry
            del param
    torch.cuda.empty_cache()
    return main


def run_dense_training(torch, card):
    """The dense engine at ``bench.py``'s width: BPR, D=64, 1e5 users x 2e4
    items, 1e6 pairs, batch 8,192, lr 1e-2: one warm epoch, then
    ``DENSE_EPOCHS`` timed epochs, and one epoch profiled."""
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel

    interactions = fit_interactions(DENSE_USERS, DENSE_ITEMS)
    model = ImplicitFactorizationModel(
        loss='bpr', embedding_dim=TRAIN_DIM, n_iter=1, batch_size=TRAIN_BATCH,
        learning_rate=1e-2, random_state=np.random.RandomState(42))
    warm_s = timed_fit(torch, model, interactions, 1)
    if model._lazy:
        raise AssertionError('the dense engine did not run')
    seconds = timed_fit(torch, model, interactions, DENSE_EPOCHS)
    num_batches = -(-FIT_PAIRS // TRAIN_BATCH)
    log(training='dense', config='bpr D={} {}x{} n={} B={}'.format(
        TRAIN_DIM, DENSE_USERS, DENSE_ITEMS, FIT_PAIRS, TRAIN_BATCH),
        warm_epoch_s=warm_s, epochs=DENSE_EPOCHS, seconds=seconds,
        examples_per_s=DENSE_EPOCHS * FIT_PAIRS / seconds,
        ms_per_step=seconds * 1e3 / (DENSE_EPOCHS * num_batches),
        last_epoch_loss=model._last_epoch_loss, card=card)
    model._n_iter = 1
    profile_call(torch, card, 'dense training epoch',
                 lambda: model.fit(interactions))
    del model
    torch.cuda.empty_cache()


def run_learning_gates(torch, card):
    """The JAX package's learning gates, through ``fit`` on the card and the
    port's ``mrr_score`` (K1 on the card): the dense engine with each loss
    on ``tests/factorization/test_implicit.py``'s data (MRR > 0.030, the
    gate less its epsilon), an untrained model there (< 0.02), and the lazy
    engine on ``tests/test_lazy_adam.py``'s (bpr, 20 epochs, the mean over
    the model seeds 0-3 > 0.05; adaptive hinge, 10 epochs, > 0.04)."""
    from spotlight_tpu_torch.data import random_train_test_split
    from spotlight_tpu_torch.data.synthetic import generate_factorization
    from spotlight_tpu_torch.evaluation import mrr_score
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel

    def split(*shape, **kwargs):
        data = generate_factorization(
            *shape, random_state=np.random.RandomState(42), **kwargs)
        return random_train_test_split(
            data, random_state=np.random.RandomState(0))

    def mrr(model, train, test):
        return float(mrr_score(model, test, train=train).mean())

    results = {}
    train, test = split(600, 400, 30000, rank=8, noise=0.15)
    untrained = ImplicitFactorizationModel(
        n_iter=10, random_state=np.random.RandomState(42))
    untrained._initialize(train)
    results['untrained'] = (mrr(untrained, train, test), '<', 0.02)
    for loss in ('pointwise', 'bpr', 'hinge', 'adaptive_hinge'):
        model = ImplicitFactorizationModel(
            loss=loss, embedding_dim=32, n_iter=10, batch_size=1024,
            learning_rate=1e-2, l2=1e-6,
            random_state=np.random.RandomState(42)).fit(train)
        results['dense ' + loss] = (mrr(model, train, test), '>', 0.030)
    train, test = split(120, 90, 6000)
    scores = []
    for seed in GATE_LAZY_SEEDS:
        model = ImplicitFactorizationModel(
            loss='bpr', n_iter=20, batch_size=512, sparse=True,
            random_state=np.random.RandomState(seed)).fit(train)
        scores.append(mrr(model, train, test))
    results['lazy bpr (mean of seeds {})'.format(list(GATE_LAZY_SEEDS))] = (
        float(np.mean(scores)), '>', 0.05)
    model = ImplicitFactorizationModel(
        loss='adaptive_hinge', n_iter=10, batch_size=512, sparse=True,
        random_state=np.random.RandomState(42)).fit(train)
    results['lazy adaptive_hinge'] = (mrr(model, train, test), '>', 0.04)
    log(learning_gates={name: value for name, (value, _, _) in
                        results.items()}, lazy_bpr_seeds=scores, card=card)
    for name, (value, op, gate) in results.items():
        passed = value < gate if op == '<' else value > gate
        if not passed:
            raise AssertionError('learning gate {}: MRR {} is not {} {}'
                                 .format(name, value, op, gate))


@contextlib.contextmanager
def no_host_sync(torch, device):
    """On the card, make any synchronising CUDA call inside raise: a
    training step reads nothing back to the host."""
    if torch.device(device).type != 'cuda':
        yield
        return
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode('default')


def check_step_against_cpu(torch, card):
    """One lazy step on the card against the same step on the CPU, from the
    same parameters (the estimator's generator is on the CPU), batch and
    negatives, at ``bench.py``'s table sizes: the occurrence gradients
    within rtol 1e-5 (torch's CUDA reductions sum in another order), and
    the step's P1 calls on the card bit-equal to the plain version on the
    card's own gradients.  The card's step runs with CUDA's
    synchronisation check set to raise."""
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.ops.kernels import row_update
    from spotlight_tpu_torch.utils import training

    interactions = fit_interactions(DENSE_USERS, DENSE_ITEMS)
    steps = {}
    for device in ('cpu', DEVICE):
        model = ImplicitFactorizationModel(
            loss='adaptive_hinge', embedding_dim=TRAIN_DIM,
            batch_size=TRAIN_BATCH, sparse=True, l2=1e-6,
            random_state=np.random.RandomState(7), device=device)
        model._initialize(interactions)
        data, n_valid, _ = model._epoch_data(interactions)
        perm, negatives = training.epoch_draws(
            model._generator, TRAIN_BATCH, (1, model._num_step_negatives,
                                            TRAIN_BATCH),
            DENSE_ITEMS, device)
        captured, undo = capture_row_updates(1)
        step = model._step_fn()
        batch = {k: v[:TRAIN_BATCH] for k, v in data.items()}
        try:
            with no_host_sync(torch, device):
                loss = training.run_epoch(step, batch, n_valid, 1,
                                          TRAIN_BATCH, perm, negatives)
        finally:
            undo()
        steps[device] = (float(loss), captured)
    cpu_loss, cpu_ops = steps['cpu']
    card_loss, card_ops = steps[DEVICE]
    gaps = []
    for table, cpu, gpu in zip(('user', 'item'), cpu_ops, card_ops):
        if not torch.equal(cpu['ids'], gpu['ids'].cpu()):
            raise AssertionError('the draws differ between the devices')
        torch.testing.assert_close(gpu['param'].cpu(), cpu['param'],
                                   rtol=0, atol=0)
        scale = float(cpu['grads'].abs().max())
        torch.testing.assert_close(gpu['grads'].cpu(), cpu['grads'],
                                   rtol=1e-5, atol=1e-7 * scale)
        gaps.append(float((gpu['grads'].cpu() - cpu['grads']).abs().max())
                    / scale)
        segments = row_update.prepare_segments(gpu['ids'])
        scalars = row_update.adam_scalars(gpu['t'], gpu['lr'], gpu['l2'])
        grads = gpu['grads'].reshape(gpu['ids'].numel(), -1)
        tables = []
        for fn in (row_update.row_adam, row_update.row_adam_plain):
            out = (gpu['param'].clone(), gpu['mu'].clone(),
                   gpu['nu'].clone())
            fn(*out, grads, segments, scalars)
            tables.append(out)
        torch.cuda.synchronize()
        for a, b in zip(*tables):
            if not torch.equal(bits(torch, a), bits(torch, b)):
                raise AssertionError('the step\'s row_adam on the {} table '
                                     'differs from its plain version'
                                     .format(table))
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    log(check='lazy step: card against CPU', loss_card=card_loss,
        loss_cpu=cpu_loss, grad_max_rel_gap=gaps, card=card)


# -- phase 5: where the time goes --------------------------------------------

def profile_metrics(torch, card, model, test, train, heavy):
    """Per metric: one warm call timed on the host clock (the item factors
    are cached by now), then one call under the profiler for the device
    time by kernel.  Also the host's share: the CSR conversion and row
    padding that precede the first batch."""
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
        profile_call(torch, card, metric, call)


def profile_call(torch, card, name, call):
    """Device time by kernel, and the idle share, of one call of ``call``
    under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

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
        # An aten:: operator row repeats the device time of the kernels it
        # launched, which have rows of their own.
        if device_us > 0 and not event.key.startswith('aten::'):
            by_kernel[event.key[:80]] = device_us / 1e3
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(profile=name, wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
        top_kernels_ms=dict(top), card=card)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, ROOT)
    from spotlight_tpu_torch.evaluation import sequence_mrr_score
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
    entries.update(check_mixture_kernels(torch, card, generator))

    launches, model, test, train, heavy = run_slice(torch, card)
    profile_metrics(torch, card, model, test, train, heavy)
    del model, test, train, heavy
    torch.cuda.empty_cache()

    seq_launches, seq_model, seq_test = run_sequence_slice(torch, card)
    launches.update(seq_launches)
    entries.update(check_sequence_kernels(torch, card, seq_model, seq_test))
    # K3 runs inside K1, K2 and K4 with mixture scoring.
    launches['mixture_score'] = sum(seq_launches.values())
    check_duplicated_row_tie(torch, card, seq_model, seq_test)
    profile_call(torch, card, 'sequence_mrr_score',
                 lambda: sequence_mrr_score(seq_model, seq_test))
    torch.cuda.empty_cache()

    bloom_launches, bloom_model_, bloom_test, bloom_mrr = run_bloom_slice(
        torch, card)
    for name, count in bloom_launches.items():
        launches[name] += count
    kernel_launches, bloom_entries = check_bloom_kernels(
        torch, card, bloom_model_, bloom_test, bloom_mrr, seq_model,
        seq_test)
    launches.update(kernel_launches)
    entries.update(bloom_entries)
    check_lookup_shapes(torch, card)
    profile_call(torch, card, 'bloom sequence_mrr_score',
                 lambda: sequence_mrr_score(bloom_model_, bloom_test))
    del bloom_model_, bloom_test, seq_model, seq_test
    torch.cuda.empty_cache()

    check_probe_shapes(torch, card)
    p1_launches, captured = run_lazy_training(torch, card)
    launches['row_adam (P1)'] = p1_launches
    entries['row_adam (P1)'] = check_engine_operands(torch, card, captured)
    del captured
    torch.cuda.empty_cache()
    run_dense_training(torch, card)
    run_learning_gates(torch, card)
    check_step_against_cpu(torch, card)

    kernels = []
    for name in ('rank_weights', 'matched_target_scores', 'streaming_topk',
                 'rank_weights (mixture)', 'streaming_topk (mixture)',
                 'mixture_score', 'matched_candidate_scores', 'rank_counts',
                 'rank_counts (mixture)', 'bloom_gather_sum',
                 'bloom_gather_sum backward', 'multihot_gather_sum',
                 'multihot_gather_sum backward', 'row_adam (P1)'):
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
