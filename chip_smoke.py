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
   and ids exactly, K2's and K4's scores bit for bit); the median time of
   each but K1c and K4 (timed in phase 7, on the main paths' operands),
   the plain version's, one PyTorch call's where one computes the same
   function, and the card's bound for the work.  Then K1 on the rows of
   the benchmark's ``mf-msd.mrr`` calls (``benchmark/data.py``: that
   cell's configuration, split and draw; B=2,048 over its 384,546 items,
   D=64, each row's test count of targets and NaN after them, as
   ``mrr_score`` hands them over): ``rank_weights`` given the widths (the
   ragged launch plan) bit for bit against it without them (every row on
   every target chunk) on every call and against the plain version on the
   first, 0 on every pad; its launches and row passes, and both timed in
   turns beside the rank pass's bound.  Then the LayerNorm kernel
   (``ops/kernels/layer_norm.py``, port-only: SASRec's blocks) at the
   ``sasrec-ml1m.mrr`` cell's call, (2,048, 200, 50) with its left padding
   as zero rows, against its plain version and ``F.layer_norm`` (within
   ``LAYER_NORM_ATOL``; the padding rows give the offset exactly), timed in
   turns with both, and with the mean and rstd written as autograd wants
   them, beside its bound in bytes.
4. slice: the implicit-MF serving path at full width: 50,000 users x
   200,000 items, D=64, ``predict``, ``mrr_score`` over 20,000 test users
   with a train mask and ``precision_recall_score`` at k=10 with a train
   mask holding a 120-item heavy user.  The launch counters and
   ``evaluation.MATERIALIZE_ROUTES`` are zeroed just before and read just
   after; every kernel must have launched and no metric call may have
   taken the materialize route (so in phases 6 and 7).  On the first 2,048
   users the streaming path must agree with the materialize path.
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
   own operands, against their plain versions in 256-sequence slices (K2's
   scores bit for bit); on
   the first 256 sequences the streaming path against the materialize
   path, each rank that differs printed and held to the exact rank of the
   plain catalogue pass; then a duplicated-row tie check (every rank
   k + 0.5), and where the device time of one more ``sequence_mrr_score``
   goes.  Then SASRec's serving path at the ``sasrec-ml1m.mrr`` cell's
   widths (``SelfAttentionNet``: D=50, 2 blocks, 200 steps, 3,417 items)
   in ``ImplicitSequenceModel``: 4 ``sequence_mrr_score`` calls of 2,048
   left-padded histories with the launch counters zeroed just before and
   read just after (5 LayerNorm launches a forward pass, no
   ``F.layer_norm`` call, K1 and K1c launched, no materialize route), a
   profiled call holding ``layer_norm_warp`` and no torch LayerNorm
   kernel, and the final representations against the same network with
   ``F.layer_norm``.  Its launches are the kernel line's ``layer_norm``
   count.
7. bloom sequences: the serving path of
   ``examples/bloom_embeddings/performance.py``'s model at 1e6 items: an
   untrained ``LSTMNet`` (D=64) with a ``BloomEmbedding`` item layer
   (200,000 compressed rows, 4 hashes), 2,048 test sequences of length 50;
   ``predict``, ``sequence_mrr_score`` with and without
   ``exclude_preceding`` and ``sequence_precision_recall_score`` at k=10,
   the launch counters of K1, K1c and K2 zeroed just before and read just
   after; streaming against materialize on the first 256 sequences as in
   phase 6.  Then K1c and K4 on the operands that the metric calls of
   phases 4, 6 and 7 handed them (recorded during those calls: each
   batch's targets, and the train rows or ``exclude_preceding`` prefixes
   that follow its rank pass), bit for bit against their plain versions,
   every pair tied with its own catalogue score, each shape timed by CUDA
   events and, in a fresh process on those ids, by ``torch.profiler``
   (device time and device activities of a call) beside its bound, its
   plain version and its launches.
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
   shapes (int64 rows), the forward once more with int32 rows under
   ``torch.cuda.set_sync_debug_mode('error')`` (no host synchronisation)
   and one bfloat16 table; the device kernels of one backward at B=8,192
   counted by ``torch.profiler`` (the sort's and one, no host
   synchronisation); where the device time of one bloom
   ``sequence_mrr_score`` goes.
9. training: P1 (``row_adam``) against its plain version bit for bit, in
   two launches, at the probe's shapes (R = 100,000 + 8 and 2,000,000 + 8,
   W=128, 24,576 ids from ``RandomState(0)``) with
   ``torch.optim.SparseAdam`` as the yardstick (rtol 1e-5; timed with its
   sparse gradient built and coalesced, and its step alone); the lazy
   engine at ``bench_lazy_knobs``' width (BPR, D=64, 2e6 users x 5e5
   items, 1e6 pairs, batch 8,192): one warm epoch, then three timed fits
   of 4 epochs with the P1 counter zeroed just before and read just after
   (2 launches a step), one epoch profiled; P1 on that engine's own
   operands captured at one warm step (float32 and bfloat16 tables) and at
   the epoch's last step (each call's longest segment printed) at the
   engine's own l2 (0), timed, with ``SparseAdam`` from the captured
   moments as the yardstick, and once more bit for bit at l2=1e-6; the
   device kernels of one ``sparse_adam_rows`` call counted by
   ``torch.profiler`` (the sort's and one); the dense engine at
   ``bench.py``'s width (1e5 x 2e4): one warm epoch, three timed fits of
   10 epochs, one profiled; the JAX package's learning gates through
   ``fit`` and ``mrr_score`` on the card; one lazy step on the card against the same
   step on the CPU (gradients within rtol 1e-5, its P1 calls bit-equal to
   the plain version).
10. routes (run after phase 5): models the kernels do not take go through
   their metrics on the materialize path, chosen before any launch and
   counted once a call in ``evaluation.MATERIALIZE_ROUTES``: a
   ``BilinearNet`` of D=262 over phase 4's catalogue and first 2,048 test
   users (the rank kernel takes it, the top-10 fetch's stage 1 takes
   D <= 261), and phase 6's mixture model with 9 tastes (the kernels take
   8) over 256 sequences; each metric equal to ``streaming=False``'s.
11. explicit MF: ``bench_explicit_mf`` of ``scripts/bench_suite.py`` at its
   width (regression, D=64, 1e5 users x 2e4 items, 1e6 ratings uniform in
   [1, 5], batch 8,192): the dense and the lazy engine, one warm fit, then
   three timed fits of 5 epochs each (the suite times 10; cut for phase
   16's room in the run's time; the P1 counter zeroed just before
   the lazy fits and read just after: 2 launches a step), one epoch
   profiled; ``rmse_score`` warm over the 1e6 pairs; P1 bit for bit
   against its plain version on the lazy engine's captured user and item
   calls (8,192 ids each, the positives alone), timed beside its sort and
   ``SparseAdam``; a poisson and a logistic fit at that width with finite
   losses; the JAX package's explicit gates through ``fit`` and
   ``rmse_score`` on the card.
12. sequence training: ``bench_sequence``'s width (20,000 random sequences
   of 50 over 20,000 items, bpr, D=64, batch 256) for ``lstm`` and
   ``mixture`` (M=4): one warm fit, three timed fits of 1 epoch (the
   suite times 10; cut for the run's time limit), an epoch of 8 of those
   batches profiled with its device calls a step; ``bench_sequence_large_catalog``: both models
   trained one epoch on phase 6's sequences (200,000 items), then served
   by ``sequence_mrr_score`` and ``sequence_precision_recall_score(k=10)``
   over 2,048 sequences with the launch counters zeroed just before and
   read just after (K1, K1c, K2; K1m, K2m, K4; no materialize route), and
   streaming against materialize on 256; one in-batch epoch of the
   mixture; 8 steps of phase 7's bloom LSTM; the JAX package's LSTM and
   mixture gates on the card.
13. pooling, CNN and the sequence lazy engine: ``bench_sequence``'s width
   for ``pooling`` and ``cnn`` (JAX's default ``CNNNet``: kernel width 3,
   one layer, tanh, residual) as in phase 12, and
   ``bench_sequence_large_catalog``'s serving of both (K1, K1c, K2 counted,
   no materialize route, streaming ranks held to the plain pass's exact
   ranks); the sequence lazy engine (``sparse=True``) at the bloom
   study's exact-table width (``examples/bloom_embeddings/
   performance.py``: ``LSTMNet``, D=64, 20,000 sequences of 50, batch
   256, bpr) at 1e6 and 5e6 items beside the dense engine, in turns, one
   warm and one timed epoch each, and one ``pooling`` lazy epoch at 1e6
   (the P1 counter zeroed just before the timed epochs and read just
   after; the padding row and its moments zero after each fit); P1 on
   that engine's own item call (25,600 ids, W=65) bit for bit twice and
   timed with and without its sort beside ``SparseAdam``; one lazy step
   on the card against the CPU; the JAX package's pooling, CNN and lazy
   gates on the card; a save and load of a lazy pooling and a dense CNN
   model: the metric bit-equal, training resumed.
14. the ML-1M sweep: ``examples/movielens_sequence/movielens_sequence.py``
   end to end on the ML-1M stand-in, not cut.  The port's
   ``data.fixtures`` generates it (the native Markov walk must have
   built); where ``h5py`` imports it is installed as the '1M' cache file
   and read by ``get_movielens_dataset('1M')``, else built into
   ``Interactions`` from the columns as the loader builds them (the route
   is printed); two user-based splits of 0.2 from ``RandomState(42)`` and
   ``to_sequence(200, 20, step 200)`` (5,139 / 1,287 / 1,637 sequences
   over 3,707 items).  The best configuration by validation MRR of each
   committed ``results/ml1m`` log (CNN, pooling, LSTM), read by the port's
   ``Results`` (its hash equal to the log's); CNN and pooling fitted at
   full width and epochs with three model seeds each, timed by the port's
   ``ThroughputMeter`` (the first fit its warm-up), scored by
   ``sequence_mrr_score`` on validation and test and
   ``sequence_precision_recall_score(k=10)`` on test (warm calls timed),
   each fit's row saved to a port ``Results`` log; an epoch of 8 of each
   one's batches under ``utils.profiling.trace`` for device calls a step
   and the idle share; SWEEP_LSTM_STEPS timed LSTM steps (a quarter of an
   epoch) and one of its steps traced.
   The launch counters of K1, K1c and K2 are zeroed just before and read
   just after; then K1, K1c and K2 bit for bit against their plain
   versions on the last CNN's operands, and the gates: the mean test MRR
   of the three seeds at least 0.9 (CNN) and 0.8 (pooling) of the log's
   best.
15. sharded evaluation (``spotlight_tpu_torch.parallel``): (a) four ranks
   on the one card (``torch.multiprocessing.spawn``, a gloo group through
   a ``file://`` store, ``make_mesh(devices=['cuda:0'] * 4)``), each
   building phase 4's implicit-MF model (50,000 x 200,000, D=64; 20,000
   test users, the 120-item heavy user), phase 6's mixture model (M=4,
   2,048 sequences of 50) and an MF model over N=1,001 items (no multiple
   of 4) from their seeds, at data=1 x model=4 and data=2 x model=2:
   ``mrr_score`` and ``precision_recall_score(k=10)`` with and without the
   train mask, ``sequence_mrr_score`` and
   ``sequence_precision_recall_score(k=10)``, and the N=1,001 model's MRR
   and P@10, each once warm and once timed, with the launch counters and
   ``evaluation.MATERIALIZE_ROUTES`` zeroed just before and read just
   after; every rank's every result bit-equal to the single-device call on
   the card and no call on the materialize route; rank 0 holds K1, K2 and
   K5 on its block of the MF catalogue and on the padded last block of the
   N=1,001 one against their plain versions, bit for bit; each call's wall
   ms per rank beside one device's (four ranks share one card: not a
   scaling figure).  (b) A one-rank NCCL group: the four sharded functions
   at the MF width (2,048 users, model axis 1), counted, exactly equal to
   the single-device kernels.  The kernels are built before the ranks
   start; the ranks only load them.  A rank's exception fails the run, and
   a collective gives up after ``MESH_TIMEOUT_S``.  The models hold their
   ranks' blocks of the tables (as a model trained on the mesh does); K1,
   K2 and K5 are checked on the first block of the MF catalogue and on the
   padded last block of N=1,001, each on the rank that holds it.
16. mesh training (``spotlight_tpu_torch.parallel.training``): (a) four
   gloo ranks on the one card, as phase 15's, at data=1 x model=4 and
   data=2 x model=2: phase 4's implicit MF (50,000 x 200,000, D=64, fused,
   dense engine, BPR, uniform negatives) takes 8 steps of batch 8,192
   under each exchange ('psum', 'alltoall', 'alltoall_cf'), phase 6's
   mixture LSTM (M=4, 200,000 items) 4 steps of 256 at 2 x 2 and phase
   7's bloom LSTM (1e6 items, 200,000 compressed rows) 2 steps of 256 at
   1 x 4, all under 'psum'; each from the initial tables and draws of a
   one-device run of the same steps in this process.  Each rank's blocks
   of tables and Adam moments are held to that run's, bit for bit where
   they agree and within ``MESH_TRAIN_RTOL`` of each table's scale
   elsewhere (the largest gap and the least bit-equal share printed by
   run and layout); then ``mrr_score`` with the train mask and
   ``precision_recall_score(k=10)`` (MF) or ``sequence_mrr_score`` on the
   mesh, bit-equal to one device's metric of the tables gathered from the
   ranks.  The launch counters, ``MATERIALIZE_ROUTES`` and
   ``parallel.mesh.COLLECTIVE_BYTES`` are zeroed just before a run's
   training and read just after its metrics: no materialize route, K1,
   K1c, K2, K1m and K4 launched.  Ms a step per rank beside one device's,
   of the first fit and of a second, warm fit of the same steps;
   collective bytes a step by axis; for the sequence models, ms of one
   metric batch's ``_rank_factors_sequences`` on the mesh (the rows through
   the exchange) beside the gathered tables' (a plain gather).  (b) A
   one-rank NCCL group: 4 MF steps under each exchange, tables and
   moments bit-equal to one device's (an axis of one rank sends nothing),
   then NCCL's all-reduce, all-gather and all-to-all on the group at the
   step's shapes, each returning its input's bits.
17. lazy mesh training (the row-sparse engines on a mesh, P1 on each
   rank's rows): (a) four gloo ranks on the one card at 1 x 4 and 2 x 2:
   phase 9's lazy MF (2e6 users x 5e5 items, D=64, BPR, batch 8,192) takes
   4 steps under each exchange, its bfloat16 tables with in-batch
   negatives under 'psum' at 1 x 4; the lazy explicit MF at phase 11's
   width 4 steps under 'psum' and 'alltoall_cf' at 2 x 2; the lazy LSTM
   at 1e6 items (batch 256, T=50) 2 steps under 'psum' (and 'alltoall'
   at 2 x 2).  Each run is held as phase 16's are (blocks of tables and
   moments, metrics on the gathered tables, routes, bytes, first and warm
   ms a step per rank), every rank on the lazy engine with P1 launched
   once a table a step.  (b) A one-rank NCCL group: 4 lazy MF steps, bit
   for bit one device's.  (c) P1 on rank 0's captured item-table operands
   of the 2 x 2 'psum' run (the step's global item stream, the ids it does
   not own at the sentinel), bit for bit against its plain version and
   timed: ``row_adam (P1, mesh)`` in the ``kernels`` line.
18. sharded checkpoints (``spotlight_tpu_torch.parallel.checkpoint``), in
   phase 17's ranks on its trained 2 x 2 'psum' lazy MF (2e6 x 5e5): its
   metrics at the save, ``save_state`` (seconds, the bytes on disk: one
   copy, 1.95 GB; ``parallel.mesh.COLLECTIVE_BYTES`` the same before and
   after), one more fit, then fresh models restored and fitted as far: at
   2 x 2 bit for bit the continuation, at 1 x 4 every quarter of every
   table and moment with the continuation's md5; in this process, on the
   card with no mesh, the state restored, ``t`` as saved and the metrics
   on 2,048 users bit for bit the mesh model's, no materialize route, K1,
   K1c and K2 launched.  The lazy LSTM's hybrid state (1e6 items) saved
   at 2 x 2 and resumed at 1 x 4 within ``MESH_TRAIN_RTOL``.  Phase 15's
   N=1,001 dense MF fitted at 2 x 2 (1,002 rows), restored at 1 x 4
   (1,004: the padding rows zero) and on one device (1,001), metrics bit
   for bit.  The checkpoints are deleted.
19. multihost and the dry run: four ranks joined through
   ``parallel.multihost.initialize`` (TCP, gloo, on the one card) check
   ``is_primary`` (rank 0 alone) and ``global_batch_array`` (the
   concatenation of their slices), then run ``entry.dryrun_multichip(4)``
   (every distributed fit at 2 x 2, the streaming metrics, no
   materialize route); one NCCL rank runs ``dryrun_multichip(1)``.  The
   launches of phases 18 and 19 (K1, K1c, K2, P1 on a mesh) count in the
   ``kernels`` line.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

import collections
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
#: float32 instructions a second of the same card's CUDA cores when no
#: multiply and add may fuse (132 SMs x 128 lanes x ~1.98 GHz): the floor
#: of scores held to the exact-tie contract (csrc/common.cuh), which bars
#: FMA, so each multiply and each add is its own instruction.
NO_FMA_OPS_PER_S = 33.5e12

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
#: Calls of a kernel profiled for its device time.
DEVICE_REPS = 20

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
#: K1's ragged case: calls of the benchmark's mf-msd.mrr cell.
RAGGED_CONFIG = os.path.join('benchmark', 'configs', 'mf_bpr_msd.json')
RAGGED_BATCH = 2_048
RAGGED_CALLS = 4
RAGGED_SEED = 2_147_483_659
RAGGED_REPS = 5
#: The LayerNorm case: the sasrec-ml1m.mrr cell's call (2,048 histories x
#: 200 steps, D=50, eps 1e-8), each history's first 93 steps padding (zero
#: rows; 46.4% of the steps on the cell's profile).
LAYER_NORM_SHAPE = (2_048, 200, 50)
LAYER_NORM_PADDING = 93
LAYER_NORM_EPS = 1e-8
#: Kernel against plain version and F.layer_norm: the row's two sums in
#: other orders on outputs of order 1 (tests/test_torch_cuda.py).
LAYER_NORM_ATOL = 2e-5
#: The SASRec slice: the sasrec-ml1m.mrr cell's model at its published
#: ML-1M widths (benchmark/configs/sasrec_ml1m.json), served in calls of
#: 2,048 histories of 200 items, left-padded.
SASREC_ITEMS, SASREC_DIM, SASREC_BLOCKS, SASREC_WINDOW = 3_417, 50, 2, 200
SASREC_BATCH = 2_048
SASREC_CALLS = 4
#: Final representations of the main path against the same network with
#: F.layer_norm: the rows' sums in other orders through two blocks
#: (tests/test_torch_cuda.py's SASREC_REPR_ATOL).
SASREC_REPR_ATOL = 2e-5
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
#: Phase 10, routes: a BilinearNet wider than the top-10 fetch's stage 1
#: takes (D <= 261 at lists of up to 64 keys; the rank kernel takes
#: D <= 768), and a mixture of more tastes than the kernels take (8).
ROUTE_DIM = 262
ROUTE_MIXTURES = 9
#: Phase 9, training: scripts/bench_suite.py's bench_lazy_knobs (the lazy
#: engine) and bench.py (the dense engine), not cut; the probe's P1 shapes.
TRAIN_DIM = 64
TRAIN_BATCH = 8_192
FIT_PAIRS = 1_000_000
LAZY_USERS, LAZY_ITEMS, LAZY_EPOCHS = 2_000_000, 500_000, 4
DENSE_USERS, DENSE_ITEMS, DENSE_EPOCHS = 100_000, 20_000, 10
#: The warm epoch's step whose row updates phase 9 captures (beside its
#: last step).
CAPTURE_STEP = 60
#: Timed fits of each training engine (their median is reported).
TIMED_FITS = 3
PROBE_ROWS = (100_000, 2_000_000)
PROBE_WIDTH, PROBE_IDS = 128, 24_576
#: Model seeds whose mean the lazy bpr gate holds (one seed of a random
#: stream other than JAX's is a coin toss at that gate).
GATE_LAZY_SEEDS = (0, 1, 2, 3)
#: Phase 11, explicit MF: scripts/bench_suite.py's bench_explicit_mf at its
#: width (phase 9's dense width and batch), its 10 timed epochs a fit cut
#: to 5 to make room for phase 16 in the run's time.
EXPLICIT_EPOCHS = 5
#: Phase 12, sequence training: bench_sequence's width (its 10 timed
#: epochs cut to 1 a fit, for the run's time: 2 until phase 16 came), then
#: bench_sequence_large_catalog on phase 6's sequences, and phase 7's
#: bloom LSTM for a few steps.
SEQ_TRAIN_ROWS, SEQ_TRAIN_ITEMS, SEQ_TRAIN_BATCH = 20_000, 20_000, 256
SEQUENCE_EPOCHS = 1
PROFILED_STEPS = 8
BLOOM_STEPS = 8
#: Phase 13: the sequence lazy engine at the bloom scalability study's
#: exact-table catalogue sizes (docs/performance.md, "Sequence models").
LAZY_SEQ_ITEMS = (1_000_000, 5_000_000)
#: Phase 14: examples/movielens_sequence/movielens_sequence.py on the ML-1M
#: stand-in (spotlight_tpu_torch/data/fixtures.py), not cut: the committed
#: sweep logs name the configurations, each fitted with these model seeds.
SWEEP_LOG = os.path.join(ROOT, 'examples', 'movielens_sequence', 'results',
                         'ml1m', '{}_results.jsonl')
SWEEP_SEEDS = (0, 1, 2)
#: Fractions of the committed best configuration's test MRR that the mean
#: of SWEEP_SEEDS must reach on the card.
SWEEP_GATES = {'cnn': 0.9, 'pooling': 0.8}
#: Steps of each model's traced epoch (of its own batches): enough for calls
#: a step and the idle share; the trace of a whole CNN epoch (81 steps,
#: 88 MB) took 30 s to write and read on an H100 machine.
SWEEP_PROFILED_STEPS = {'cnn': 8, 'pooling': 8, 'lstm': 1}
#: Timed steps of the LSTM's fit: a quarter of its 161-step epoch (host
#: bound at ~9,100 device calls a step), cut from the whole epoch to make
#: room for phases 18 and 19 in the run's time.
SWEEP_LSTM_STEPS = 40
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


def interleaved_ms(torch, fns, reps, rounds=5):
    """Median device time of one call of each of ``fns`` (a dict), timed in
    alternating rounds of ``reps`` calls each, so that the host's drift
    over the measurement falls on all of them alike."""
    times = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, fn in fns.items():
            marks = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                     for _ in range(reps)]
            for start, end in marks:
                start.record()
                fn()
                end.record()
            torch.cuda.synchronize()
            times[name] += [s.elapsed_time(e) for s, e in marks]
    return {name: statistics.median(t) for name, t in times.items()}


def device_events(torch, fn, reps=1):
    """The device activities (kernels, copies, fills) of ``reps`` calls of
    ``fn``, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [event for event in prof.events()
            if event.device_type == torch.autograd.DeviceType.CUDA]


def device_work(torch, fn, reps=DEVICE_REPS):
    """(device ms, device activities) of one call of ``fn`` over ``reps``
    calls after one warm-up: the summed durations, and the number, of the
    device activities the calls made."""
    fn()
    events = device_events(torch, fn, reps)
    busy_us = sum(event.time_range.end - event.time_range.start
                  for event in events)
    return busy_us / 1e3 / reps, len(events) / reps


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


def no_fma_floor_ms(batch, num_items, width=D):
    """The exact-tie contract's floor of a catalogue pass: 2 B N K float32
    instructions at NO_FMA_OPS_PER_S, K the user width (D for dots, 2 M D
    for a mixture of M tastes)."""
    return 2 * batch * num_items * width / NO_FMA_OPS_PER_S * 1e3


def ulp_gap(torch, a, b):
    """Largest distance in units in the last place between two float32
    tensors of finite values (0 when they are bit-equal)."""
    def ordered(x):
        bits = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(bits < 0, -(bits & 0x7fffffff), bits)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def same_bits(torch, a, b):
    """Whether two float32 tensors hold the same bits (signs of zeros
    included)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


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
    width (B=256, T=128), K1c bit for bit (its times come from the main
    paths' own operands, check_matched_kernels); K1's kernel_case lines
    carry the no-FMA floor.  Returns the kernel-table entry of K1 at the
    main path's case."""
    from spotlight_tpu_torch.ops.kernels import ranking

    entries = {}
    for batch, width in ((2048, 4), (256, 128)):
        users, items, bias = kernel_inputs(torch, batch, generator)
        ids = torch.randint(0, NUM_ITEMS, (batch, width),
                            generator=generator, device=DEVICE)
        ts = ranking.matched_target_scores(users, items, bias, ids)
        ts_plain = ranking.matched_target_scores_plain(users, items, bias,
                                                       ids)
        if not same_bits(torch, ts, ts_plain):
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

        entry = kernel_entry(
            'rank_weights', 'ranking.cu',
            'spotlight_tpu/ops/kernels/ranking.py:107',
            'B={} N={} D={} T={}'.format(batch, NUM_ITEMS, D, width),
            median_ms(torch,
                      lambda: ranking.rank_weights(users, items, bias, ts),
                      KERNEL_REPS),
            median_ms(torch, lambda: ranking.rank_weights_plain(
                users, items, bias, ts), PLAIN_REPS),
            2 * batch * NUM_ITEMS * D + 2 * batch * width * NUM_ITEMS,
            4 * NUM_ITEMS * D + 4 * NUM_ITEMS + 4 * batch * D
            + 8 * batch * width, 0.0)
        log(kernel_case=dict(entry, no_fma_floor_ms=no_fma_floor_ms(
            batch, NUM_ITEMS)), card=card)
        if batch == 2048:
            entries['rank_weights'] = entry
        del users, items, bias, ts, weights, plain
        torch.cuda.empty_cache()
    return entries


def ragged_calls():
    """``(num_items, widths)``: the catalogue and each row's count of test
    items in ``RAGGED_CALLS`` calls of ``mf-msd.mrr`` at ``RAGGED_SEED``
    (the cell's own split and stratified draw)."""
    from benchmark import data

    with open(os.path.join(ROOT, RAGGED_CONFIG)) as f:
        cfg = json.load(f)
    split = data.interactions(cfg, RAGGED_SEED, DEVICE)
    indptr, _, population = data.test_rows(
        split.test_users, split.test_items, cfg['num_users'])
    del split
    counts = np.diff(indptr)
    pool = data.call_rows(population, counts[population], RAGGED_BATCH,
                          RAGGED_CALLS, RAGGED_SEED)
    return cfg['num_items'], [counts[rows] for rows in pool]


def check_ragged_rank_pass(torch, card, generator):
    """K1 on rows of ragged target counts, the ``mf-msd.mrr`` cell's calls
    (phase 3): each call's kernel-table line."""
    from benchmark import peaks
    from spotlight_tpu_torch.ops.kernels import _build, ranking

    num_items, calls = ragged_calls()
    torch.cuda.empty_cache()
    chunk = _build.load('ranking').spotlight_rank_max_targets(D, 0)
    users = torch.randn(RAGGED_BATCH, D, generator=generator,
                        device=DEVICE) / D ** .5
    items = torch.randn(num_items, D, generator=generator,
                        device=DEVICE) / D ** .5
    bias = 0.1 * torch.randn(num_items, generator=generator, device=DEVICE)
    for call, widths in enumerate(calls):
        num_targets = int(widths.max())
        shape = 'B={} N={} D={} T={} (mf-msd.mrr call {})'.format(
            RAGGED_BATCH, num_items, D, num_targets, call)
        ids = torch.randint(0, num_items, (RAGGED_BATCH, num_targets),
                            generator=generator, device=DEVICE)
        pads = (torch.arange(num_targets, device=DEVICE)[None, :]
                >= torch.as_tensor(widths, device=DEVICE)[:, None])
        ts = ranking.matched_target_scores(users, items, bias, ids
                                           ).masked_fill(pads, float('nan'))

        def ragged():
            return ranking.rank_weights(users, items, bias, ts,
                                        widths=widths)

        def chunk_loop():
            return ranking.rank_weights(users, items, bias, ts)

        before = (ranking.RANK_WEIGHTS_LAUNCHES,
                  ranking.RANK_WEIGHTS_ROW_PASSES)
        weights = ragged()
        launches = ranking.RANK_WEIGHTS_LAUNCHES - before[0]
        row_passes = ranking.RANK_WEIGHTS_ROW_PASSES - before[1]
        wants = [('rank_weights', chunk_loop())]
        if call == 0:
            wants.append(('rank_weights_plain', ranking.rank_weights_plain(
                users, items, bias, ts)))
        for name, want in wants:
            if not torch.equal(weights, want):
                raise AssertionError(
                    'ragged rank_weights differs from {} at {}: {} of {} '
                    'weights'.format(name, shape,
                                     int((weights != want).sum()),
                                     weights.numel()))
        del wants, want
        if not (bool((weights[pads] == 0).all())
                and bool((weights[~pads] >= 0.5).all())):
            raise AssertionError('a pad counted, or a target lost its '
                                 'self-tie, at ' + shape)
        times = interleaved_ms(torch, {'ragged': ragged,
                                       'chunk_loop': chunk_loop},
                               RAGGED_REPS)
        device_ms, activities = device_work(torch, ragged, RAGGED_REPS)
        case = kernel_entry(
            'rank_weights (ragged)', 'ranking.cu',
            'spotlight_tpu/ops/kernels/ranking.py:107', shape,
            times['ragged'], None,
            *peaks.rank_pass(RAGGED_BATCH, num_items, D, num_targets), 0.0,
            chunk_loop_ms=times['chunk_loop'], device_ms=device_ms,
            device_activities=activities, launches=launches,
            row_passes=row_passes,
            chunk_loop_row_passes=RAGGED_BATCH * -(-num_targets // chunk),
            rows_past_chunk=int((widths > chunk).sum()),
            rows_at_most_4=int((widths <= 4).sum()))
        log(kernel_case=case, card=card)
        del ids, pads, ts, weights
    del users, items, bias
    torch.cuda.empty_cache()


def check_layer_norm(torch, card, generator):
    """The LayerNorm kernel at SASRec's call (phase 3): against its plain
    version and ``F.layer_norm``, the padding rows to the offset, timed in
    turns with both.  Returns its kernel-table entry."""
    import torch.nn.functional as F
    from spotlight_tpu_torch.ops.kernels import layer_norm

    dim = LAYER_NORM_SHAPE[-1]
    x = torch.randn(LAYER_NORM_SHAPE, generator=generator, device=DEVICE)
    x[:, :LAYER_NORM_PADDING] = 0.0
    weight = 1 + 0.1 * (2 * torch.rand(dim, generator=generator,
                                       device=DEVICE) - 1)
    bias = 0.1 * (2 * torch.rand(dim, generator=generator,
                                 device=DEVICE) - 1)
    fns = {
        'kernel': lambda: layer_norm.layer_norm(x, weight, bias,
                                                LAYER_NORM_EPS),
        'plain': lambda: layer_norm.layer_norm_plain(x, weight, bias,
                                                     LAYER_NORM_EPS)[0],
        'library': lambda: F.layer_norm(x, (dim,), weight, bias,
                                        LAYER_NORM_EPS),
        # As autograd calls it: mean and rstd written besides y.
        'statistics': lambda: layer_norm._forward(
            x, weight, bias, LAYER_NORM_EPS, stats=True)[0]}
    with torch.no_grad():
        before = layer_norm.LAYER_NORM_LAUNCHES
        y = fns['kernel']()
        launches = layer_norm.LAYER_NORM_LAUNCHES - before
        err = max(float((y - fns[name]()).abs().max())
                  for name in ('plain', 'library'))
        if launches != 1 or err > LAYER_NORM_ATOL:
            raise AssertionError(
                'layer_norm: {} launches, {} from its plain version or '
                'F.layer_norm (tolerance {})'.format(launches, err,
                                                     LAYER_NORM_ATOL))
        if not torch.equal(y[:, :LAYER_NORM_PADDING],
                           bias.expand_as(y[:, :LAYER_NORM_PADDING])):
            raise AssertionError('layer_norm: a padding row is not the '
                                 'offset')
        times = interleaved_ms(torch, fns, KERNEL_REPS)
        device_ms, activities = device_work(torch, fns['kernel'])
    entry = kernel_entry(
        'layer_norm', 'layer_norm.cu', 'none (port-only SASRec)',
        'rows={} D={} ({} x {} steps; first {} steps zero)'.format(
            x.numel() // dim, dim, *LAYER_NORM_SHAPE[:2],
            LAYER_NORM_PADDING),
        times['kernel'], times['plain'], 8 * x.numel(),
        2 * x.numel() * 4 + 2 * dim * 4, err, library_ms=times['library'],
        device_ms=device_ms, device_activities=activities,
        launches=launches, statistics_ms=times['statistics'])
    log(kernel_case=entry, card=card)
    del x, y
    torch.cuda.empty_cache()
    return entry


def check_topk_kernel(torch, card, generator):
    """K2 at B=256 with k=10, k=134 (P@10 plus a 124-wide train
    over-fetch) and k=300 (resume rounds), and at the main path's two
    shapes: B=2048 with k=34 (P@10 plus a batch's widest train row, ~24)
    and k=143 (the batch of the 120-item heavy user).  Each kernel_case
    line carries, beside the bound, the exact-tie contract's no-FMA floor
    of the scoring (2 B N D instructions at NO_FMA_OPS_PER_S).  Returns the
    kernel-table entry of the main path's common case, without the floor."""
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
        log(kernel_case=dict(entry, no_fma_floor_ms=no_fma_floor_ms(
            batch, NUM_ITEMS)), card=card)
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
                  ops, nbytes, gap, err, ms=None, floor_ms=None):
    """A mixture kernel's case: its median time over KERNEL_REPS launches
    (or ``ms``, for K3, which has no launch of its own), its plain
    version's, the bound; printed with the catalogue pass's no-FMA floor
    ``floor_ms`` where given, and returned as a kernel-table entry."""
    out = kernel_entry(
        name, src, replaces, shape,
        median_ms(torch, fn, KERNEL_REPS) if ms is None else ms,
        median_ms(torch, plain_fn, PLAIN_REPS), ops, nbytes, err,
        max_ulp=gap)
    if floor_ms is None:
        log(kernel_case=out, card=card)
    else:
        log(kernel_case=dict(out, no_fma_floor_ms=floor_ms), card=card)
    return out


def check_mixture_kernels(torch, card, generator):
    """K4 at the main path's widths (B=2048 with T=1, the targets, and
    T=49, the ``exclude_preceding`` prefixes) bit for bit (its times come
    from the main path's own operands, check_matched_kernels), and K1 and
    K2 with mixture scoring at B=256 (T=1 and k=10, and the k=59 of a P@10
    fetch over 49 excluded ids), counts and ids equal, K2's scores bit for
    bit.  The kernel-table entries of K1, K2 and K3 with mixture scoring
    come from the main path's operands (check_sequence_kernels)."""
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    width = 2 * MIXTURES * D

    def operands(batch):
        users, items, bias = kernel_inputs(torch, batch, generator)
        users = torch.randn(batch, width, generator=generator,
                            device=DEVICE) / D ** .5
        return users, items, bias

    def entry(*args, **kwargs):
        return mixture_entry(torch, card, *args, **kwargs)

    users, items, bias = operands(2048)
    for width_t in (1, 49):
        ids = torch.randint(1, NUM_ITEMS, (2048, width_t),
                            generator=generator, device=DEVICE)
        got = ranking.matched_candidate_scores(users, items, bias, ids,
                                               MIXTURES)
        want = ranking.matched_candidate_scores_plain(users, items, bias,
                                                      ids, MIXTURES)
        if not same_bits(torch, got, want):
            raise AssertionError(
                'matched_candidate_scores is {} ulp from its plain version '
                'at T={}'.format(ulp_gap(torch, got, want), width_t))
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
          0, 0.0, floor_ms=no_fma_floor_ms(MIX_BATCH, NUM_ITEMS, width))

    for k in (SEQ_K, 59):
        scores, top = topk.streaming_topk(users, items, bias, k, MIXTURES)
        p_scores, p_top = topk.streaming_topk_plain(users, items, bias, k,
                                                    MIXTURES)
        gap = ulp_gap(torch, scores, p_scores)
        if not (torch.equal(top, p_top) and same_bits(torch, scores,
                                                      p_scores)):
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
              float((scores - p_scores).abs().max()),
              floor_ms=no_fma_floor_ms(MIX_BATCH, NUM_ITEMS, width))
    del users, items, bias, ts, ts_plain, weights, plain
    torch.cuda.empty_cache()


# -- phase 4: the slice at full width ----------------------------------------

def dyadic(values, step):
    """``values`` rounded to multiples of ``step`` (a power of two)."""
    return (np.round(values / step) * step).astype(np.float32)


def parameter_tree(rs, dim=D, num_users=NUM_USERS, num_items=NUM_ITEMS):
    """A JAX-layout fused parameter tree of width ``dim``.

    The factors are N(0, 1/D) draws (the JAX package's initialisation: a
    standard normal over D) rounded to multiples of 2^-12, and the biases
    small draws rounded to multiples of 2^-16.  Every product is then a
    multiple of 2^-24 and every score and partial sum stays below 1 in
    magnitude, so each is exact in float32 in any summation order: the
    streaming kernels and the materialize path (a cuBLAS product) must
    agree exactly, ties included."""
    def table(rows):
        weight = np.empty((rows, dim + 1), np.float32)
        weight[:, :dim] = dyadic(rs.randn(rows, dim) / dim, 2.0 ** -12)
        weight[:, dim] = dyadic(2.0 ** -9 * rs.randn(rows), 2.0 ** -16)
        return {'weight': weight}

    return {'user_embeddings': table(num_users),
            'item_embeddings': table(num_items)}


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
    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    ranking.RANK_WEIGHTS_LAUNCHES = 0
    ranking.MATCHED_SCORES_LAUNCHES = 0
    topk.STREAMING_TOPK_LAUNCHES = 0
    evaluation.MATERIALIZE_ROUTES = 0


def check_streamed(where):
    """No metric call of a main path took the materialize route."""
    from spotlight_tpu_torch import evaluation

    routes = evaluation.MATERIALIZE_ROUTES
    log(materialize_routes=routes, path=where)
    if routes:
        raise AssertionError('{} metric calls of the {} took the materialize '
                             'route'.format(routes, where))


def slice_data(num_users=NUM_USERS, num_items=NUM_ITEMS, eval_users=EVAL_USERS,
               train_pairs=TRAIN_PAIRS, seed=7):
    """(the generator, train, test, heavy): ``heavy`` is ``train`` with
    HEAVY_EXTRA more items for user 0.  The generator goes on to draw the
    rest of the slice's inputs."""
    from spotlight_tpu_torch.data import Interactions

    rs = np.random.RandomState(seed)
    train = Interactions(
        rs.randint(0, num_users, train_pairs).astype(np.int64),
        rs.randint(0, num_items, train_pairs).astype(np.int64),
        num_users=num_users, num_items=num_items)
    test = Interactions(
        np.repeat(np.arange(eval_users, dtype=np.int64), TEST_PER_USER),
        rs.randint(0, num_items, TEST_PER_USER * eval_users).astype(
            np.int64),
        num_users=num_users, num_items=num_items)
    heavy = Interactions(
        np.concatenate([np.zeros(HEAVY_EXTRA, dtype=np.int64),
                        train.user_ids]),
        np.concatenate([rs.randint(0, num_items, HEAVY_EXTRA).astype(
            np.int64), train.item_ids]),
        num_users=num_users, num_items=num_items)
    return rs, train, test, heavy


def slice_model(train, mesh=None, seed=0):
    """(the implicit-MF model over ``train`` with ``parameter_tree``'s
    weights, the tree), on ``mesh`` if one is given."""
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.utils.convert import params_from_jax

    model = ImplicitFactorizationModel(
        loss='bpr', embedding_dim=D, random_state=np.random.RandomState(42),
        mesh=mesh)
    model._initialize(train)
    tree = parameter_tree(np.random.RandomState(seed),
                          num_users=train.num_users,
                          num_items=train.num_items)
    model._load_params(params_from_jax(model._net, tree))
    return model, tree


def run_slice(torch, card, captured):
    """Returns (launch counts of the main path, model, data); records the
    K1c calls of its ``mrr_score`` into ``captured``."""
    from spotlight_tpu_torch.evaluation import (mrr_score,
                                                precision_recall_score)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('float32 products must not run in TF32')
    rs, train, test, heavy = slice_data()
    model, tree = slice_model(train)

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
    with capture_matched(captured, 'implicit MF'):
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
    check_streamed('main path')

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


def sequence_rows():
    """The sequences of mixture_catalog_eval_200k, seeded."""
    return np.random.RandomState(42).randint(
        1, NUM_ITEMS, (SEQ_ROWS, SEQ_LENGTH)).astype(np.int32)


def sequence_model(mesh=None):
    """The untrained mixture model of mixture_catalog_eval_200k, seeded
    (its item biases are zero), on ``mesh`` if one is given, and the
    sequences."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    sequences = sequence_rows()
    model = ImplicitSequenceModel(loss='bpr', representation='mixture',
                                  embedding_dim=D,
                                  random_state=np.random.RandomState(0),
                                  mesh=mesh)
    model._initialize(SequenceInteractions(sequences, num_items=NUM_ITEMS))
    return model, sequences


def run_sequence_slice(torch, card, captured):
    """Returns (launch counts of the main path, model, test set); records
    the K4 calls of its ``sequence_mrr_score`` calls into ``captured``."""
    from spotlight_tpu_torch import evaluation
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
    evaluation.MATERIALIZE_ROUTES = 0
    seconds = {}
    start = time.perf_counter()
    scores = model.predict(sequences[0])
    seconds['predict'] = time.perf_counter() - start
    with capture_matched(captured, 'mixture sequences'):
        start = time.perf_counter()
        mrr = sequence_mrr_score(model, test)
        seconds['sequence_mrr_score'] = time.perf_counter() - start
        start = time.perf_counter()
        mrr_ex = sequence_mrr_score(model, test, exclude_preceding=True)
        seconds['sequence_mrr_score exclude_preceding'] = (
            time.perf_counter() - start)
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
    check_streamed('sequence path')

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
    K2's scores bit for bit.  K3, which has no launch of its own, is held,
    bit for bit, by K4's target scores and K2's top-k scores against the
    plain catalogue pass.  Returns the kernel-table entries of K1, K2 and
    K3 with mixture scoring."""
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
    catalogue = torch.cat(sliced(catalogue_at, reprs, targets))
    k3_gap = ulp_gap(torch, ts, catalogue)
    weights = ranking.rank_weights(reprs, items, bias, ts, mixtures)
    plain = torch.cat(sliced(
        lambda u, t: ranking.rank_weights_plain(u, items, bias, t,
                                                mixtures), reprs, ts))
    if not (torch.equal(weights, plain) and same_bits(torch, ts, catalogue)):
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
        scoring + 2 * batch * NUM_ITEMS, table_bytes + 8 * batch, 0, 0.0,
        floor_ms=no_fma_floor_ms(batch, NUM_ITEMS, reprs.shape[1]))

    reprs_k = model._rank_factors_sequences(test.sequences[:, :-SEQ_K])[0]
    scores, top = topk.streaming_topk(reprs_k, items, bias, SEQ_K, mixtures)
    pairs = sliced(lambda u: topk.streaming_topk_plain(u, items, bias, SEQ_K,
                                                       mixtures), reprs_k)
    p_scores = torch.cat([p[0] for p in pairs])
    p_top = torch.cat([p[1] for p in pairs])
    # The plain top-k scores are the plain catalogue pass's.
    gap = ulp_gap(torch, scores, p_scores)
    if not (torch.equal(top, p_top) and same_bits(torch, scores, p_scores)):
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
        float((scores - p_scores).abs().max()),
        floor_ms=no_fma_floor_ms(batch, NUM_ITEMS, reprs_k.shape[1]))

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


def sasrec_histories(calls):
    """``calls`` x 2,048 seeded histories of 200 items over SASREC_ITEMS,
    each left-padded to its length, drawn uniform in [20, 200]."""
    rs = np.random.RandomState(27)
    rows = rs.randint(1, SASREC_ITEMS, (calls * SASREC_BATCH, SASREC_WINDOW))
    lengths = rs.randint(20, SASREC_WINDOW + 1, len(rows))
    rows[np.arange(SASREC_WINDOW)[None, :]
         < (SASREC_WINDOW - lengths)[:, None]] = 0
    return rows.reshape(calls, SASREC_BATCH, SASREC_WINDOW)


def run_sasrec_slice(torch, card):
    """SASRec's serving path (phase 6): ``sequence_mrr_score`` over
    SASREC_CALLS calls of 2,048 histories, with the launch counters zeroed
    just before and read just after: 2 x blocks + 1 LayerNorm launches a
    forward pass, no ``F.layer_norm`` call, K1 and K1c launched, no
    materialize route; a profiled call with ``layer_norm_warp`` and no
    torch LayerNorm kernel; the final representations against the same
    network with ``F.layer_norm``.  Returns the launch counts."""
    from torch.nn import functional as F
    from torch.profiler import ProfilerActivity, profile

    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.evaluation import sequence_mrr_score
    from spotlight_tpu_torch.ops.kernels import layer_norm
    from spotlight_tpu_torch.sequence import (ImplicitSequenceModel,
                                              SelfAttentionNet)

    generator = torch.Generator().manual_seed(27)
    net = SelfAttentionNet(SASREC_ITEMS, SASREC_DIM, num_blocks=SASREC_BLOCKS,
                           max_sequence_length=SASREC_WINDOW,
                           generator=generator)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=generator))
        net.item_embeddings.weight[0] = 0.0
    histories = sasrec_histories(SASREC_CALLS)
    tests = [SequenceInteractions(rows, num_items=SASREC_ITEMS)
             for rows in histories]
    model = ImplicitSequenceModel(loss='bpr', representation=net,
                                  embedding_dim=SASREC_DIM, device=DEVICE)
    model._initialize(tests[0])
    sequence_mrr_score(model, tests[0])  # warm

    forward, library_norm, passes = net.user_representation, F.layer_norm, []

    def counted(sequences):
        passes.append(len(sequences))
        return forward(sequences)

    def library_spy(*args, **kwargs):
        raise AssertionError('the SASRec path called F.layer_norm')

    # The main path, with the launch counters zeroed just before it.
    net.user_representation, F.layer_norm = counted, library_spy
    try:
        torch.cuda.synchronize()
        reset_counters()
        layer_norm.LAYER_NORM_LAUNCHES = 0
        call_ms = []
        for test in tests:
            start = time.perf_counter()
            mrr = sequence_mrr_score(model, test)
            call_ms.append((time.perf_counter() - start) * 1e3)
            if mrr.shape != (SASREC_BATCH,) or not (np.all(mrr > 0)
                                                    and np.all(mrr <= 1)):
                raise AssertionError('sasrec: bad sequence_mrr_score')
        counts = dict(counters(), layer_norm=layer_norm.LAYER_NORM_LAUNCHES)
    finally:
        F.layer_norm = library_norm
        del net.user_representation
    del counts['streaming_topk']
    log(sasrec_path_launches=counts, forward_passes=len(passes),
        histories=sum(passes))
    check_streamed('sasrec path')
    if (counts['layer_norm'] != (2 * SASREC_BLOCKS + 1) * len(passes)
            or sum(passes) != SASREC_CALLS * SASREC_BATCH
            or min(counts.values()) <= 0):
        raise AssertionError('sasrec path: {} over {} forward passes of {} '
                             'histories'.format(counts, len(passes),
                                                sum(passes)))
    log(sasrec_slice='sequence_mrr_score', histories=SASREC_BATCH,
        call_ms=call_ms, users_per_s=SASREC_BATCH * 1e3
        / statistics.median(call_ms), card=card)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        sequence_mrr_score(model, tests[0])
        wall_ms = (time.perf_counter() - start) * 1e3
    profile_summary(card, 'sasrec sequence_mrr_score', prof, wall_ms)
    names = {event.name for event in prof.events()
             if event.device_type == torch.autograd.DeviceType.CUDA}
    torch_norms = sorted(name for name in names if 'LayerNorm' in name
                         or 'RowwiseMoments' in name)
    if torch_norms or not any('layer_norm_warp' in name for name in names):
        raise AssertionError('sasrec profile: torch LayerNorm kernels {}, '
                             'layer_norm_warp {}'.format(
                                 torch_norms, any('layer_norm_warp' in name
                                                  for name in names)))

    prefixes = torch.as_tensor(histories[0][:, :-1], device=DEVICE)
    with torch.no_grad():
        final = forward(prefixes)[1]
        net._layer_norm = lambda x, weight, bias: F.layer_norm(
            x, (SASREC_DIM,), weight, bias, net.EPS)
        want = forward(prefixes)[1]
        del net._layer_norm
    gap = float((final - want).abs().max())
    log(sasrec_final_gap=gap, tolerance=SASREC_REPR_ATOL)
    if gap > SASREC_REPR_ATOL:
        raise AssertionError('sasrec: final representations {} from '
                             'F.layer_norm\'s'.format(gap))
    del model, net, final, want
    torch.cuda.empty_cache()
    return counts


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


def run_bloom_slice(torch, card, captured):
    """Returns (launch counts of the main path, model, test set, the
    per-sequence values of ``sequence_mrr_score``); records the K1c calls of
    its ``sequence_mrr_score`` calls into ``captured``."""
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
    with capture_matched(captured, 'bloom sequences'):
        start = time.perf_counter()
        mrr = sequence_mrr_score(model, test)
        seconds['sequence_mrr_score'] = time.perf_counter() - start
        start = time.perf_counter()
        mrr_ex = sequence_mrr_score(model, test, exclude_preceding=True)
        seconds['sequence_mrr_score exclude_preceding'] = (
            time.perf_counter() - start)
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
    check_streamed('bloom path')

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


# -- K1c and K4 on the main paths' own operands -------------------------------

@contextlib.contextmanager
def capture_matched(captured, path):
    """Records the K1c and K4 calls that the metric calls inside the block
    make, per (path, role): their number, and the operands of the widest.
    A batch's first call scores its targets; a call on the same users
    (the same tensor) scores the batch's train rows or
    ``exclude_preceding`` prefixes.  Each call runs the wrapper once, as it
    would have without the record."""
    from spotlight_tpu_torch import evaluation

    names = ('matched_target_scores', 'matched_candidate_scores')
    originals = {name: getattr(evaluation, name) for name in names}
    last_users = [None]

    def recorded(name):
        def call(users, items, bias, ids, *mixtures):
            role = 'rows' if users is last_users[0] else 'targets'
            last_users[0] = users
            case = captured.setdefault((path, role), dict(
                kernel=name, launches=0, operands=None))
            case['launches'] += 1
            if (case['operands'] is None
                    or ids.shape[1] > case['operands'][3].shape[1]):
                case['operands'] = (users, items, bias, ids) + mixtures
            return originals[name](users, items, bias, ids, *mixtures)
        return call

    for name in names:
        setattr(evaluation, name, recorded(name))
    try:
        yield
    finally:
        for name in names:
            setattr(evaluation, name, originals[name])


def matched_device_work(cases):
    """Run in a fresh process (a long run's profiler record can drop
    events): per case (wrapper name, users' shape, items' shape and dtype,
    ids as numpy, mixtures), the device time and device activities of one
    call (``device_work``) on seeded factors of those shapes with those
    ids.  The factors' values move no time: what the kernel reads follows
    from the ids and the shapes."""
    import torch

    sys.path.insert(0, ROOT)
    from spotlight_tpu_torch.ops.kernels import ranking

    generator = torch.Generator(device=DEVICE)
    generator.manual_seed(0)
    out = []
    for kernel, users_shape, items_shape, item_dtype, ids, mixtures in cases:
        users = torch.randn(users_shape, generator=generator, device=DEVICE)
        items = torch.randn(items_shape, generator=generator,
                            device=DEVICE).to(getattr(torch, item_dtype))
        bias = torch.randn(items_shape[0], generator=generator,
                           device=DEVICE)
        ids = torch.from_numpy(ids).to(DEVICE)
        fn = getattr(ranking, kernel)
        out.append(device_work(
            torch, lambda: fn(users, items, bias, ids, *mixtures)))
    return out


def check_matched_kernels(torch, card, captured):
    """K1c and K4 on the operands that the main paths handed them
    (``capture_matched``): each case bit for bit against its plain version
    on the same ids clipped into the catalogue, each pair tied with its own
    catalogue score (``rank_weights`` >= 0.5), timed by CUDA events, and by
    ``torch.profiler`` in a fresh process (``matched_device_work``), beside
    its bound (the users once, each distinct item row and bias once, an id
    in and a score out a pair) and its main-path launches.  Returns the
    kernel-table entries of the implicit MF targets (K1c) and the mixture
    targets (K4)."""
    import multiprocessing

    from spotlight_tpu_torch.ops.kernels import ranking

    replaces = {'matched_target_scores':
                    'spotlight_tpu/ops/kernels/ranking.py:459',
                'matched_candidate_scores':
                    'spotlight_tpu/ops/kernels/ranking.py:527'}
    cases, specs = [], []
    for (path, role), case in captured.items():
        users, items, bias, ids, *mixtures = case['operands']
        kernel = case['kernel']
        wrapper = getattr(ranking, kernel)
        plain = getattr(ranking, kernel + '_plain')
        safe = ids.clamp(0, items.shape[0] - 1)

        def call(wrapper=wrapper, users=users, items=items, bias=bias,
                 ids=ids, mixtures=mixtures):
            return wrapper(users, items, bias, ids, *mixtures)

        def plain_call(plain=plain, users=users, items=items, bias=bias,
                       safe=safe, mixtures=mixtures):
            return plain(users, items, bias, safe, *mixtures)

        got, want = call(), plain_call()
        if not same_bits(torch, got, want):
            raise AssertionError(
                '{} differs from its plain version on the {} {}: {} ulp'
                .format(kernel, path, role, ulp_gap(torch, got, want)))
        weights = ranking.rank_weights(users, items, bias, got, *mixtures)
        if not bool((weights >= 0.5).all()):
            raise AssertionError('a pair of the {} {} lost its self-tie'
                                 .format(path, role))
        batch, width = ids.shape
        num_items, dim = items.shape
        pairs = batch * width
        distinct = int(torch.unique(safe).numel())
        ops = (mixture_ops(pairs, 1, mixtures[0]) if mixtures
               else 2 * pairs * dim)
        nbytes = (4 * users.numel()
                  + distinct * (items.element_size() * dim + 4)
                  + pairs * (ids.element_size() + 4))
        shape = 'B={} N={} D={}{} T={}'.format(
            batch, num_items, dim,
            ' M={}'.format(mixtures[0]) if mixtures else '', width)
        cases.append((path, role, kernel, kernel_entry(
            kernel, 'ranking.cu', replaces[kernel], shape,
            median_ms(torch, call, KERNEL_REPS),
            median_ms(torch, plain_call, PLAIN_REPS), ops, nbytes, 0.0,
            path=path, role=role, distinct_rows=distinct,
            main_path_launches=case['launches'])))
        specs.append((kernel, tuple(users.shape), tuple(items.shape),
                      str(items.dtype).split('.')[-1], ids.cpu().numpy(),
                      tuple(mixtures)))
        del weights
    with multiprocessing.get_context('spawn').Pool(1) as pool:
        device = pool.apply(matched_device_work, (specs,))
    entries = {}
    for (path, role, kernel, entry), (device_ms, activities) in zip(
            cases, device):
        entry.update(device_ms=device_ms, device_activities=activities)
        log(kernel_case=entry, card=card)
        if role == 'targets' and path != 'bloom sequences':
            entries[kernel] = entry
    torch.cuda.empty_cache()
    return entries


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
    log(kernel_case=dict(entries['rank_counts'], no_fma_floor_ms=(
        no_fma_floor_ms(batch, BLOOM_ITEMS))), card=card)

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
    log(kernel_case=dict(entries['rank_counts (mixture)'],
                         no_fma_floor_ms=no_fma_floor_ms(
                             MIX_BATCH, NUM_ITEMS, 2 * mixtures * D)),
        card=card)
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
        four_quarters_ms=median_ms(torch, quarters, KERNEL_REPS),
        no_fma_floor_ms=no_fma_floor_ms(batch, num_items))
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
                weight, rows, masked, not masked), KERNEL_REPS),
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
    ``embedding_bag`` yardstick, and the backward alone beside
    ``embedding_bag``'s backward alone (the three timed in alternating
    rounds); the device work of one backward;
    then one bfloat16 table through each entry point and its backward
    against the plain versions."""
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

    def backward(out, table, cotangent):
        """The backward alone: one forward's graph, kept, differentiated
        again and again."""
        return lambda: torch.autograd.grad(out, table, cotangent,
                                           retain_graph=True)

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
            backwards = {name + ' bwd ms': backward(fn(table, rows), table,
                                                    cotangent)
                         for name, fn, _ in entry_points}
            backwards['embedding_bag bwd ms'] = backward(
                F.embedding_bag(rows, table, mode='sum'), table, cotangent)
            case.update(interleaved_ms(torch, backwards, KERNEL_REPS))
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

    # The forward reads nothing back: both entry points, int64 and int32
    # rows, with CUDA's synchronisation check set to raise.
    table, rows, _ = operands(65_536, 64, torch.float32)
    check_scatter_rows_launches(torch, card, rows, 65_536, 64)
    with no_host_sync(torch, DEVICE):
        outs = [fn(table.detach(), r) for r in (rows, rows.to(torch.int32))
                for _, fn, _ in entry_points]
    same = [torch.equal(bits(torch, outs[i]), bits(torch, outs[i + 2]))
            for i in range(2)]
    log(check='gather-sum forward under set_sync_debug_mode(error)',
        shape='B={} k={} C=65536 D=64 f32, int64 and int32 rows'.format(
            batch, hashes), raised=False, int32_equals_int64=same, card=card)
    if not all(same):
        raise AssertionError('the gather-sum forward differs between int32 '
                             'and int64 rows')

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


def scatter_rows_device_work(rows, num_rows, dim):
    """Run in a fresh process (a long run's profiler record can drop
    events): the device activities of one stable sort of the flat ``rows``
    ((B, k) int64 numpy; the cast to int32 keys included) and of one
    backward of ``multihot_gather_sum(mask_row_zero=True)`` on them (K7b,
    a float32 table of ``num_rows`` x ``dim``).  Returns the two name
    lists."""
    import torch

    sys.path.insert(0, ROOT)
    from spotlight_tpu_torch.ops.kernels import gather_sum, multihot

    rows = torch.from_numpy(rows).to(DEVICE)
    table = torch.randn(num_rows, dim, device=DEVICE, requires_grad=True)
    cotangent = torch.randn(rows.shape[0], dim, device=DEVICE)
    out = multihot.multihot_gather_sum(table, rows, True)

    def backward():
        return torch.autograd.grad(out, table, cotangent, retain_graph=True)

    backward()
    with no_host_sync(torch, DEVICE):
        backward()
    sort = device_kernels(torch, lambda: gather_sum.sort_rows(rows))
    return sort, device_kernels(torch, backward)


def check_scatter_rows_launches(torch, card, rows, num_rows, dim):
    """What one gather-sum backward puts on the card at the lookup
    benchmark's batch (in a fresh process): the stable sort's device work
    and one scatter launch, nothing else, with no host synchronisation."""
    import multiprocessing

    with multiprocessing.get_context('spawn').Pool(1) as pool:
        sort, launched = pool.apply(scatter_rows_device_work, (
            rows.cpu().numpy(), num_rows, dim))
    scatter = sum('scatter_rows_kernel' in name for name in launched)
    log(scatter_rows_device_work={
        'rows': list(rows.shape), 'rows_dtype': str(rows.dtype),
        'table': [num_rows, dim], 'sort_kernels': len(sort),
        'call_kernels': len(launched), 'scatter_launches': scatter,
        'call': launched}, host_syncs=0, card=card)
    if len(launched) != len(sort) + 1 or scatter != 1:
        raise AssertionError('the gather-sum backward launched {} device '
                             'kernels ({} scatter), not the sort\'s {} and '
                             'one'.format(len(launched), scatter, len(sort)))


# -- phase 9: training -------------------------------------------------------

def row_update_bytes(distinct, n, width, param_size, id_size=4,
                     fused=False):
    """Bytes P1 must move: each distinct row's parameters, ``mu`` and ``nu``
    read and written once, each occurrence's float32 gradient row read
    once, and its ids: with ``fused`` the occurrence ids (the call's
    input), else the sorted ids and the int64 order the kernel reads."""
    index = n * id_size if fused else n * (id_size + 8)
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
    steps are one function.  An id outside ``[0, R)`` (a padded batch
    row's, in the sequence engine) updates nothing in P1, so it is left
    out of SparseAdam's gradient.  Returns (median ms of the function P1
    computes: the sparse gradient built and coalesced from the occurrence
    ids, then the step; median ms of the step alone on a coalesced
    gradient; largest gap)."""
    from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows
    from spotlight_tpu_torch.utils.training import B2, EPS

    ours = param.clone()
    sparse_adam_rows(ids, ours, mu.clone(), nu.clone(), grads, t, lr)
    kept = (ids >= 0) & (ids < param.shape[0])
    ids, grads = ids[kept], grads[kept]

    weight = torch.nn.Parameter(param.clone())
    optimizer = torch.optim.SparseAdam([weight], lr=lr,
                                       eps=EPS * (1 - B2 ** t) ** 0.5)
    optimizer.state[weight] = {'step': t - 1, 'exp_avg': mu.clone(),
                               'exp_avg_sq': nu.clone()}

    def step():
        weight.grad = torch.sparse_coo_tensor(
            ids.reshape(1, -1).long(), grads, param.shape,
            check_invariants=False).coalesce()
        optimizer.step()

    step()
    torch.testing.assert_close(weight.detach(), ours, rtol=1e-5, atol=1e-6)
    gap = float((weight.detach() - ours).abs().max())
    ms = median_ms(torch, step, KERNEL_REPS)
    step_only_ms = median_ms(torch, optimizer.step, KERNEL_REPS)
    del weight, optimizer, ours
    return ms, step_only_ms, gap


def check_row_update(torch, card, shape, param, mu, nu, ids, grads, t, lr,
                     l2, library=False, timed=True, name='row_adam (P1)'):
    """P1 against its plain version on one operand set: ``param``, ``mu``
    and ``nu`` bit for bit, in two launches, for the occurrence form (one
    stable sort's ``(sorted_ids, order)``) and for the probe's
    pre-deduplicated form (unique sorted rows, ``order = arange``,
    pre-summed gradients); then, with ``timed``: the kernel alone on the
    deduplicated rows (the probe's ``pallas_kernel_only``), the sort and
    the kernel (``pallas_fused``: ``sparse_adam_rows``' device work), the
    plain version and, with ``library`` (l2=0, a float32 table),
    ``torch.optim.SparseAdam`` from the same moments, sparse gradient
    included.  Returns the kernel-table entry (None unless ``timed``)."""
    from spotlight_tpu_torch.ops.kernels import row_update

    sorted_ids, order = row_update.sort_occurrences(ids)
    segments = row_update.prepare_segments(sorted_ids, order)
    scalars = row_update.adam_scalars(t, lr, l2)
    distinct = int(segments.count)
    lengths = segments.offsets[1:distinct + 1] - segments.offsets[:distinct]
    # The longest run of a row of the table (a mesh rank's foreign ids and
    # the sequence engine's padding ids form a run past it, which P1
    # skips).
    longest = int(lengths[segments.rows[:distinct] < param.shape[0]].max())
    summed = row_update.segment_sums_plain(grads, segments, distinct,
                                           param.shape[0])
    unique_ids = segments.rows[:distinct].contiguous()
    unique_order = torch.arange(distinct, device=ids.device)

    def run(fn, rows, pair):
        tables = (param.clone(), mu.clone(), nu.clone())
        fn(*tables, rows, *pair, scalars)
        return tables

    want = run(row_update.row_adam_plain, grads, (sorted_ids, order))
    for form, rows, pair in (('occurrences', grads, (sorted_ids, order)),
                             ('deduplicated', summed,
                              (unique_ids, unique_order))):
        for launch in range(2):
            got = run(row_update.row_adam, rows, pair)
            torch.cuda.synchronize()
            for part, a, b in zip(('param', 'mu', 'nu'), got, want):
                if not torch.equal(bits(torch, a), bits(torch, b)):
                    raise AssertionError(
                        'row_adam ({}, launch {}) differs from its plain '
                        'version in {} at {}: {} elements'.format(
                            form, launch, part, shape,
                            int((bits(torch, a) != bits(torch, b)).sum())))
            del got
    moved = float((want[0].float() - param.float()).abs().max())
    del want
    if not timed:
        log(check='row_adam bit-equal to its plain version, twice',
            shape=shape, longest_segment=longest, card=card)
        return None

    p, m, v = param.clone(), mu.clone(), nu.clone()
    kernel_ms = median_ms(
        torch, lambda: row_update.row_adam(p, m, v, summed, unique_ids,
                                           unique_order, scalars),
        KERNEL_REPS)
    fused_ms = median_ms(
        torch, lambda: row_update.row_adam(
            p, m, v, grads, *row_update.sort_occurrences(ids), scalars),
        KERNEL_REPS)
    sort_ms = median_ms(torch, lambda: row_update.sort_occurrences(ids),
                        KERNEL_REPS)
    plain_ms = median_ms(
        torch, lambda: row_update.row_adam_plain(
            p, m, v, grads, *row_update.sort_occurrences(ids), scalars),
        PLAIN_REPS)
    del p, m, v
    library_ms = step_only_ms = library_gap = None
    if library:
        library_ms, step_only_ms, library_gap = sparse_adam_yardstick(
            torch, param, mu, nu, ids, grads, t, lr)
    width = param.shape[1]
    size = param.element_size()
    id_size = ids.element_size()
    entry = kernel_entry(
        name, 'row_update.cu', 'scripts/fused_rowupdate_probe.py:78',
        shape, fused_ms, plain_ms,
        row_update_ops(distinct, ids.numel(), width),
        row_update_bytes(distinct, ids.numel(), width, size, id_size,
                         fused=True),
        0.0, library_ms=library_ms, library_step_only_ms=step_only_ms,
        kernel_only_ms=kernel_ms, sort_ms=sort_ms,
        kernel_only_bound_ms=bound(
            row_update_ops(distinct, distinct, width),
            row_update_bytes(distinct, distinct, width, size, id_size))[0],
        distinct_rows=distinct, occurrences=ids.numel(),
        longest_segment=longest, library_max_abs_gap=library_gap,
        largest_step=moved)
    torch.cuda.empty_cache()
    log(kernel_case=entry, card=card)
    return entry


def device_kernels(torch, call):
    """Names of the device activities (kernels, copies, fills) of one call
    of ``call``, from ``torch.profiler``."""
    return [event.name for event in device_events(torch, call)]


def sparse_adam_device_work(ids, num_rows, width):
    """Run in a fresh process (a long run's profiler record can drop
    events): the device activities of one stable sort of ``ids`` (int64
    numpy) and of one ``sparse_adam_rows`` call on them, into float32
    tables of ``num_rows`` x ``width``.  Returns the two name lists."""
    import torch

    sys.path.insert(0, ROOT)
    from spotlight_tpu_torch.ops.kernels import row_update
    from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows

    ids = torch.from_numpy(ids).to(DEVICE)
    tables = [torch.zeros(num_rows, width, device=DEVICE) for _ in range(3)]
    grads = torch.randn(ids.numel(), width, device=DEVICE)
    sparse_adam_rows(ids, *tables, grads, 1, 1e-2)
    sort = device_kernels(torch, lambda: row_update.sort_occurrences(ids))
    call = device_kernels(
        torch, lambda: sparse_adam_rows(ids, *tables, grads, 2, 1e-2))
    return sort, call


def check_sparse_adam_launches(torch, card, operands):
    """What one ``sparse_adam_rows`` call puts on the card, on the lazy
    engine's captured item-table operands: no host synchronisation (here),
    and (in a fresh process, on the same ids) the stable sort's device
    work and one P1 launch, nothing else."""
    import multiprocessing

    from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows

    ids = operands['ids']
    tables = (operands['param'].clone(), operands['mu'].clone(),
              operands['nu'].clone())
    with no_host_sync(torch, DEVICE):
        sparse_adam_rows(ids, *tables, operands['grads'], operands['t'],
                         operands['lr'], operands['l2'])
    del tables
    with multiprocessing.get_context('spawn').Pool(1) as pool:
        sort, launched = pool.apply(sparse_adam_device_work, (
            ids.cpu().numpy(), operands['param'].shape[0],
            operands['param'].shape[1]))
    p1 = sum('row_adam_kernel' in name for name in launched)
    log(sparse_adam_rows_device_work={
        'ids': ids.numel(), 'ids_dtype': str(ids.dtype),
        'sort_kernels': len(sort), 'call_kernels': len(launched),
        'row_adam_launches': p1, 'call': sorted(set(launched))},
        host_syncs=0, card=card)
    if len(launched) != len(sort) + 1 or p1 != 1:
        raise AssertionError('sparse_adam_rows launched {} device kernels '
                             '({} row_adam), not the sort\'s {} and one'
                             .format(len(launched), p1, len(sort)))


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


def capture_row_updates(*steps, engine=None, calls_per_step=2):
    """Wrap a lazy engine's ``sparse_adam_rows`` (``engine``, the module;
    the factorization engine's by default) so that the operands of its
    ``calls_per_step`` calls at each of ``steps`` (1-based; the
    factorization engine's user table, then its item table; the sequence
    engine's item table alone) are cloned before they update.  Returns
    (captured list, in call order, each with its ``step``; undo)."""
    from spotlight_tpu_torch.factorization import lazy

    lazy = engine or lazy
    original = lazy.sparse_adam_rows
    captured = []
    calls = [0]

    def wrapper(ids, param, mu, nu, grad_rows, t, lr, l2=0.0):
        calls[0] += 1
        step = (calls[0] - 1) // calls_per_step + 1
        if step in steps:
            captured.append(dict(ids=ids.clone(), param=param.clone(),
                                 mu=mu.clone(), nu=nu.clone(),
                                 grads=grad_rows.clone(), t=t, lr=lr, l2=l2,
                                 step=step))
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


def log_fit_rates(torch, card, name, config, rows, unit, model, data,
                  epochs, steps, warm_s, seconds, profile_data=None):
    """A training line: ``unit`` (rows a second) of each timed ``fit``,
    their median, least and largest, then one more epoch profiled, on
    ``profile_data`` where given (a few of the same batches: the
    profiler's record of a long epoch of small launches takes minutes to
    read).  Returns the profile's summary."""
    rates = [epochs * rows / s for s in seconds]
    loss = model._last_epoch_loss
    if not np.isfinite(loss):
        raise AssertionError('{}: epoch loss {}'.format(name, loss))
    log(training=name, config=config, warm_fit_s=warm_s, epochs=epochs,
        fits=len(seconds), seconds=seconds,
        **{unit: statistics.median(rates), unit + '_min': min(rates),
           unit + '_max': max(rates)},
        ms_per_step=statistics.median(seconds) * 1e3 / (epochs * steps),
        last_epoch_loss=loss, card=card)
    model._n_iter = 1
    profiled = data if profile_data is None else profile_data
    return profile_call(torch, card, name + ' epoch',
                        lambda: model.fit(profiled))


def run_lazy_training(torch, card):
    """The lazy engine at ``bench_lazy_knobs``' width: BPR, D=64, 2e6 users
    x 5e5 items, 1e6 pairs, batch 8,192, lr 1e-2.  One warm epoch (whose
    step ``CAPTURE_STEP`` and last step row updates are
    captured), then ``TIMED_FITS`` timed fits of ``LAZY_EPOCHS`` epochs
    with the P1 counter zeroed just before and read just after.  Returns
    (launches, captured operands)."""
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.ops.kernels import row_update

    interactions = fit_interactions(LAZY_USERS, LAZY_ITEMS)
    num_batches = -(-FIT_PAIRS // TRAIN_BATCH)
    model = ImplicitFactorizationModel(
        loss='bpr', embedding_dim=TRAIN_DIM, n_iter=1, batch_size=TRAIN_BATCH,
        learning_rate=1e-2, sparse=True,
        random_state=np.random.RandomState(42))
    captured, undo = capture_row_updates(CAPTURE_STEP, num_batches)
    try:
        warm_s = timed_fit(torch, model, interactions, 1)
    finally:
        undo()
    if not model._lazy or len(captured) != 4:
        raise AssertionError('the lazy engine did not run')

    # The main path, with the P1 counter zeroed just before it.
    row_update.ROW_ADAM_LAUNCHES = 0
    seconds = [timed_fit(torch, model, interactions, LAZY_EPOCHS)
               for _ in range(TIMED_FITS)]
    launches = row_update.ROW_ADAM_LAUNCHES
    expected = 2 * num_batches * LAZY_EPOCHS * TIMED_FITS
    log(main_path_launches={'row_adam (P1)': launches}, expected=expected)
    if launches != expected:
        raise AssertionError('row_adam launched {} times, not {}'.format(
            launches, expected))
    log_fit_rates(torch, card, 'lazy', 'bpr D={} {}x{} n={} B={}'.format(
        TRAIN_DIM, LAZY_USERS, LAZY_ITEMS, FIT_PAIRS, TRAIN_BATCH), FIT_PAIRS,
        'examples_per_s', model, interactions, LAZY_EPOCHS, num_batches,
        warm_s, seconds)
    del model
    torch.cuda.empty_cache()
    return launches, captured


def check_engine_operands(torch, card, captured):
    """P1 on the lazy engine's own operands at full width (W=65), captured
    from one warm epoch: the user table's call (8,192 ids) and the item
    table's (16,384 ids, the positives and their negatives) at step
    ``CAPTURE_STEP``, float32 and bfloat16 tables, and at the epoch's last
    step (float32); each step's ~60 padded examples name user 0 and item
    0, the longest segments.  At the call's own l2 (the engine's default, 0) each is
    timed, the float32 tables beside ``SparseAdam`` from the captured
    moments; at l2=1e-6 each is held bit for bit once more.  Then what one
    call puts on the card.  Returns the item call's float32 entry at step
    ``CAPTURE_STEP``."""
    main = None
    for operands in captured:
        table = 'user' if operands['ids'].numel() == TRAIN_BATCH else 'item'
        last = operands['step'] != CAPTURE_STEP
        grads = operands['grads'].reshape(operands['ids'].numel(),
                                          -1).float()
        for dtype in (torch.float32,) if last else (torch.float32,
                                                      torch.bfloat16):
            param = operands['param'].to(dtype)
            for l2 in dict.fromkeys((operands['l2'], 1e-6)):
                shape = ('{} table R={} W={} n={} {} step={} t={} l2={} '
                         '(engine{})').format(
                    table, param.shape[0], param.shape[1],
                    operands['ids'].numel(), str(dtype).split('.')[-1],
                    operands['step'], operands['t'], l2,
                    ', last step' if last else '')
                main_l2 = l2 == operands['l2']
                entry = check_row_update(
                    torch, card, shape, param, operands['mu'], operands['nu'],
                    operands['ids'], grads, operands['t'], operands['lr'], l2,
                    library=main_l2 and l2 == 0 and dtype == torch.float32,
                    timed=main_l2)
                if (main_l2 and table == 'item' and not last
                        and dtype == torch.float32):
                    main = entry
            del param
    check_sparse_adam_launches(torch, card, captured[1])
    torch.cuda.empty_cache()
    return main


def run_dense_training(torch, card):
    """The dense engine at ``bench.py``'s width: BPR, D=64, 1e5 users x 2e4
    items, 1e6 pairs, batch 8,192, lr 1e-2: one warm epoch, then
    ``TIMED_FITS`` timed fits of ``DENSE_EPOCHS`` epochs, and one epoch
    profiled."""
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel

    interactions = fit_interactions(DENSE_USERS, DENSE_ITEMS)
    model = ImplicitFactorizationModel(
        loss='bpr', embedding_dim=TRAIN_DIM, n_iter=1, batch_size=TRAIN_BATCH,
        learning_rate=1e-2, random_state=np.random.RandomState(42))
    warm_s = timed_fit(torch, model, interactions, 1)
    if model._lazy:
        raise AssertionError('the dense engine did not run')
    seconds = [timed_fit(torch, model, interactions, DENSE_EPOCHS)
               for _ in range(TIMED_FITS)]
    log_fit_rates(torch, card, 'dense', 'bpr D={} {}x{} n={} B={}'.format(
        TRAIN_DIM, DENSE_USERS, DENSE_ITEMS, FIT_PAIRS, TRAIN_BATCH),
        FIT_PAIRS, 'examples_per_s', model, interactions, DENSE_EPOCHS,
        -(-FIT_PAIRS // TRAIN_BATCH), warm_s, seconds)
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


def check_captured_row_adam(torch, operands, what):
    """A captured ``sparse_adam_rows`` call's P1 launch on the card, bit
    for bit against the plain version on the same operands."""
    from spotlight_tpu_torch.ops.kernels import row_update

    pair = row_update.sort_occurrences(operands['ids'])
    scalars = row_update.adam_scalars(operands['t'], operands['lr'],
                                      operands['l2'])
    grads = operands['grads'].reshape(operands['ids'].numel(), -1)
    tables = []
    for fn in (row_update.row_adam, row_update.row_adam_plain):
        out = (operands['param'].clone(), operands['mu'].clone(),
               operands['nu'].clone())
        fn(*out, grads, *pair, scalars)
        tables.append(out)
    torch.cuda.synchronize()
    for a, b in zip(*tables):
        if not torch.equal(bits(torch, a), bits(torch, b)):
            raise AssertionError('the {}\'s row_adam differs from its plain '
                                 'version'.format(what))


def check_step_against_cpu(torch, card):
    """One lazy step on the card against the same step on the CPU, from the
    same parameters (the estimator's generator is on the CPU), batch and
    negatives, at ``bench.py``'s table sizes: the occurrence gradients
    within rtol 1e-5 (torch's CUDA reductions sum in another order), and
    the step's P1 calls on the card bit-equal to the plain version on the
    card's own gradients.  The card's step runs with CUDA's
    synchronisation check set to raise."""
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
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
        check_captured_row_adam(torch, gpu, 'step\'s {} table'.format(
            table))
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    log(check='lazy step: card against CPU', loss_card=card_loss,
        loss_cpu=cpu_loss, grad_max_rel_gap=gaps, card=card)


# -- phase 11: explicit matrix factorization ----------------------------------

def explicit_interactions():
    """``bench_explicit_mf``'s data: ``FIT_PAIRS`` ratings uniform in
    [1, 5] over ``DENSE_USERS`` x ``DENSE_ITEMS``, from ``RandomState(42)``
    as it draws them."""
    from spotlight_tpu_torch.data import Interactions

    rs = np.random.RandomState(42)
    return Interactions(
        rs.randint(0, DENSE_USERS, FIT_PAIRS).astype(np.int64),
        rs.randint(0, DENSE_ITEMS, FIT_PAIRS).astype(np.int64),
        ratings=rs.uniform(1.0, 5.0, FIT_PAIRS).astype(np.float32),
        num_users=DENSE_USERS, num_items=DENSE_ITEMS)


def run_explicit_training(torch, card):
    """Phase 11: ``bench_explicit_mf`` not cut (regression, D=64, 1e5 users
    x 2e4 items, 1e6 ratings, batch 8,192) on the dense and the lazy
    engine: one warm fit (the lazy one's row updates at step
    ``CAPTURE_STEP`` captured), then ``TIMED_FITS`` timed fits of
    ``EXPLICIT_EPOCHS`` epochs, the P1 counter zeroed just before the lazy
    fits and read just after (2 launches a step); ``rmse_score`` warm over
    the 1e6 pairs.  Returns (P1 launches, the captured operands)."""
    from spotlight_tpu_torch.evaluation import rmse_score
    from spotlight_tpu_torch.factorization import ExplicitFactorizationModel
    from spotlight_tpu_torch.ops.kernels import row_update

    data = explicit_interactions()
    steps = -(-FIT_PAIRS // TRAIN_BATCH)
    config = 'regression D={} {}x{} n={} B={}'.format(
        TRAIN_DIM, DENSE_USERS, DENSE_ITEMS, FIT_PAIRS, TRAIN_BATCH)
    models = {}
    for engine in ('dense', 'lazy'):
        model = ExplicitFactorizationModel(
            loss='regression', embedding_dim=TRAIN_DIM, n_iter=1,
            batch_size=TRAIN_BATCH, sparse=engine == 'lazy',
            random_state=np.random.RandomState(42))
        if engine == 'lazy':
            captured, undo = capture_row_updates(CAPTURE_STEP)
            try:
                warm_s = timed_fit(torch, model, data, 1)
            finally:
                undo()
            if not model._lazy or len(captured) != 2:
                raise AssertionError('the explicit lazy engine did not run')
            # The main path, with the P1 counter zeroed just before it.
            row_update.ROW_ADAM_LAUNCHES = 0
            seconds = [timed_fit(torch, model, data, EXPLICIT_EPOCHS)
                       for _ in range(TIMED_FITS)]
            launches = row_update.ROW_ADAM_LAUNCHES
            expected = 2 * steps * EXPLICIT_EPOCHS * TIMED_FITS
            log(main_path_launches={'row_adam (P1, explicit)': launches},
                expected=expected)
            if launches != expected:
                raise AssertionError('row_adam launched {} times, not {}'
                                     .format(launches, expected))
        else:
            warm_s = timed_fit(torch, model, data, 1)
            if model._lazy:
                raise AssertionError('the explicit dense engine did not run')
            seconds = [timed_fit(torch, model, data, EXPLICIT_EPOCHS)
                       for _ in range(TIMED_FITS)]
        log_fit_rates(torch, card, 'explicit ' + engine, config, FIT_PAIRS,
                      'examples_per_s', model, data, EXPLICIT_EPOCHS, steps,
                      warm_s, seconds)
        models[engine] = model

    model = models['dense']
    first = float(rmse_score(model, data))
    torch.cuda.synchronize()
    start = time.perf_counter()
    value = float(rmse_score(model, data))
    elapsed = time.perf_counter() - start
    log(explicit='rmse_score', pairs=FIT_PAIRS, warm_s=elapsed,
        m_predictions_per_s=FIT_PAIRS / elapsed / 1e6, rmse=value,
        card=card)
    if not (np.isfinite(value) and value == first):
        raise AssertionError('rmse_score: {} then {}'.format(first, value))
    del models, model
    torch.cuda.empty_cache()
    return launches, captured


def check_explicit_operands(torch, card, captured):
    """P1 on the explicit lazy engine's own operands at step
    ``CAPTURE_STEP`` (W=65, 8,192 ids each, the positives alone: the user
    table's call, then the item table's), bit for bit against its plain
    version and timed at the engine's l2 (0) beside its sort and
    ``SparseAdam`` from the captured moments.  Returns the item call's
    entry."""
    entry = None
    for table, operands in zip(('user', 'item'), captured):
        ids = operands['ids']
        if ids.numel() != TRAIN_BATCH:
            raise AssertionError('the explicit step updated {} {} rows, not '
                                 'the positives'.format(ids.numel(), table))
        shape = ('{} table R={} W={} n={} float32 step={} t={} l2={} '
                 '(explicit engine)').format(
            table, operands['param'].shape[0], operands['param'].shape[1],
            ids.numel(), operands['step'], operands['t'], operands['l2'])
        entry = check_row_update(
            torch, card, shape, operands['param'], operands['mu'],
            operands['nu'], ids, operands['grads'].reshape(ids.numel(), -1),
            operands['t'], operands['lr'], operands['l2'],
            library=operands['l2'] == 0)
    torch.cuda.empty_cache()
    return entry


def run_explicit_gates(torch, card):
    """A poisson fit (dense) and a logistic fit (lazy) of one epoch at
    ``bench_explicit_mf``'s width, with finite losses; then the JAX
    package's gates of ``tests/factorization/test_explicit.py`` through
    ``fit`` and ``rmse_score`` on the card: regression RMSE < 0.85 and
    below 0.65 x the mean baseline's; poisson below the mean baseline,
    with positive predictions; logistic accuracy above the base rate +
    0.03, with probabilities."""
    from spotlight_tpu_torch.data import Interactions, random_train_test_split
    from spotlight_tpu_torch.data.synthetic import generate_factorization
    from spotlight_tpu_torch.evaluation import rmse_score
    from spotlight_tpu_torch.factorization import ExplicitFactorizationModel

    data = explicit_interactions()
    signed = Interactions(data.user_ids, data.item_ids,
                          ratings=np.where(data.ratings >= 3, 1.0, -1.0)
                          .astype(np.float32),
                          num_users=DENSE_USERS, num_items=DENSE_ITEMS)
    losses = {}
    for loss, sparse, interactions in (('poisson', False, data),
                                       ('logistic', True, signed)):
        model = ExplicitFactorizationModel(
            loss=loss, embedding_dim=TRAIN_DIM, n_iter=1,
            batch_size=TRAIN_BATCH, sparse=sparse, learning_rate=1e-3,
            random_state=np.random.RandomState(42)).fit(interactions)
        losses[loss] = model._last_epoch_loss
        if not np.isfinite(model._last_epoch_loss) or model._lazy != sparse:
            raise AssertionError('explicit {}: loss {}'.format(
                loss, model._last_epoch_loss))
    del model
    torch.cuda.empty_cache()

    train, test = random_train_test_split(
        generate_factorization(600, 400, 30000, rank=8, noise=0.15,
                               explicit=True,
                               random_state=np.random.RandomState(42)),
        random_state=np.random.RandomState(0))
    baseline = float(np.sqrt(((test.ratings - train.ratings.mean()) ** 2)
                             .mean()))

    def fitted(loss, learning_rate, interactions):
        return ExplicitFactorizationModel(
            loss=loss, embedding_dim=32, n_iter=10, batch_size=1024,
            learning_rate=learning_rate, l2=1e-6,
            random_state=np.random.RandomState(42)).fit(interactions)

    def signs(part):
        return Interactions(part.user_ids, part.item_ids,
                            ratings=np.where(part.ratings >= 3, 1.0, -1.0)
                            .astype(np.float32),
                            num_users=part.num_users,
                            num_items=part.num_items)

    regression = float(rmse_score(fitted('regression', 1e-2, train), test))
    poisson_model = fitted('poisson', 1e-3, train)
    poisson = float(rmse_score(poisson_model, test))
    positive = bool((poisson_model.predict(0) > 0).all())
    signed_train, signed_test = signs(train), signs(test)
    predictions = fitted('logistic', 1e-2, signed_train).predict(
        signed_test.user_ids, signed_test.item_ids)
    accuracy = float(((predictions > 0.5) == (signed_test.ratings > 0))
                     .mean())
    share = float((signed_train.ratings > 0).mean())
    base_rate = max(share, 1 - share)
    log(explicit_gates={'regression_rmse': regression,
                        'poisson_rmse': poisson, 'mean_baseline': baseline,
                        'logistic_accuracy': accuracy,
                        'base_rate': base_rate},
        full_width_losses=losses, card=card)
    failed = [name for name, passed in (
        ('regression', regression < 0.85 and regression < 0.65 * baseline),
        ('poisson', poisson < baseline and positive),
        ('logistic', accuracy > base_rate + 0.03
         and bool(((predictions >= 0) & (predictions <= 1)).all())))
        if not passed]
    if failed:
        raise AssertionError('explicit learning gates failed: {}'.format(
            failed))


# -- phase 12: sequence training --------------------------------------------

def run_sequence_training(torch, card, representations):
    """``bench_sequence``'s training at full width: 20,000 random sequences
    of 50 over 20,000 items, bpr, D=64, batch 256 (79 steps an epoch), for
    each of ``representations`` (the suite's ``reps``: ``lstm`` and
    ``mixture`` (M=4) in phase 12, ``pooling`` and ``cnn``, JAX's default
    ``CNNNet``, in phase 13): one warm fit, then ``TIMED_FITS`` timed
    fits of ``SEQUENCE_EPOCHS`` epochs (the suite times 10; cut to 1 for
    the run's time limit), and an epoch of ``PROFILED_STEPS`` of those
    batches profiled (its device calls a step too)."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    sequences = np.random.RandomState(42).randint(
        1, SEQ_TRAIN_ITEMS, (SEQ_TRAIN_ROWS, SEQ_LENGTH)).astype(np.int32)
    data = SequenceInteractions(sequences, num_items=SEQ_TRAIN_ITEMS)
    profiled = SequenceInteractions(
        sequences[:PROFILED_STEPS * SEQ_TRAIN_BATCH],
        num_items=SEQ_TRAIN_ITEMS)
    steps = -(-SEQ_TRAIN_ROWS // SEQ_TRAIN_BATCH)
    for representation in representations:
        model = ImplicitSequenceModel(
            loss='bpr', representation=representation, embedding_dim=D,
            batch_size=SEQ_TRAIN_BATCH, n_iter=1,
            random_state=np.random.RandomState(0))
        warm_s = timed_fit(torch, model, data, 1)
        seconds = [timed_fit(torch, model, data, SEQUENCE_EPOCHS)
                   for _ in range(TIMED_FITS)]
        summary = log_fit_rates(
            torch, card, 'sequence ' + representation,
            'bpr D={} {} sequences x {} over {} items B={}'.format(
                D, SEQ_TRAIN_ROWS, SEQ_LENGTH, SEQ_TRAIN_ITEMS,
                SEQ_TRAIN_BATCH), SEQ_TRAIN_ROWS, 'sequences_per_s', model,
            data, SEQUENCE_EPOCHS, steps, warm_s, seconds, profiled)
        log(sequence_step=representation, steps=PROFILED_STEPS,
            device_calls_per_step=summary['device_calls'] / PROFILED_STEPS,
            device_busy_ms_per_step=(summary['device_busy_ms']
                                     / PROFILED_STEPS),
            wall_ms_per_step=summary['wall_ms'] / PROFILED_STEPS,
            device_idle_share=summary['device_idle_share'], card=card)
        del model
        torch.cuda.empty_cache()


def reset_sequence_counters():
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    reset_counters()
    ranking.MIXTURE_RANK_WEIGHTS_LAUNCHES = 0
    ranking.CANDIDATE_SCORES_LAUNCHES = 0
    topk.MIXTURE_STREAMING_TOPK_LAUNCHES = 0


def run_trained_serving(torch, card, representations):
    """``bench_sequence_large_catalog``: a model of each of
    ``representations`` trained one epoch (16 steps) on phase 6's 4,096
    sequences of 50 over 200,000 items, then served:
    ``sequence_mrr_score`` and ``sequence_precision_recall_score(k=10)``
    over the first 2,048 sequences with the launch counters zeroed just
    before and read just after (K1, K1c, K2 for dot scoring: ``pooling``,
    ``lstm``, ``cnn``; K1m, K2m, K4 for the mixture; no materialize route),
    and streaming against materialize on the first 256.  Returns the
    launch counts."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.evaluation import (
        sequence_mrr_score, sequence_precision_recall_score)
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    sequences = sequence_rows()
    data = SequenceInteractions(sequences, num_items=NUM_ITEMS)
    test = SequenceInteractions(sequences[:SEQ_EVAL], num_items=NUM_ITEMS)
    launches = {}
    for representation in representations:
        model = ImplicitSequenceModel(
            loss='bpr', representation=representation, embedding_dim=D,
            batch_size=SEQ_TRAIN_BATCH, n_iter=1,
            random_state=np.random.RandomState(0))
        fit_s = timed_fit(torch, model, data, 1)
        if not np.isfinite(model._last_epoch_loss):
            raise AssertionError('{}: epoch loss {}'.format(
                representation, model._last_epoch_loss))

        # The main path, with the launch counters zeroed just before it.
        torch.cuda.synchronize()
        reset_sequence_counters()
        start = time.perf_counter()
        mrr = sequence_mrr_score(model, test)
        mrr_s = time.perf_counter() - start
        start = time.perf_counter()
        precision, recall = sequence_precision_recall_score(model, test,
                                                            k=SEQ_K)
        pr_s = time.perf_counter() - start
        counts = (sequence_counters() if representation == 'mixture'
                  else counters())
        log(trained_path_launches=counts, representation=representation)
        for name, count in counts.items():
            if count <= 0:
                raise AssertionError('{} never launched on the trained {} '
                                     'path'.format(name, representation))
            launches[name] = launches.get(name, 0) + count
        if representation == 'mixture':
            launches['mixture_score'] = sum(counts.values())
        check_streamed('trained {} path'.format(representation))
        if mrr.shape != (SEQ_EVAL,) or not (np.all(mrr > 0)
                                            and np.all(mrr <= 1)):
            raise AssertionError('trained {}: bad sequence_mrr_score'
                                 .format(representation))
        for name, values in (('precision', precision), ('recall', recall)):
            if values.shape != (SEQ_EVAL,) or not (
                    np.all(values >= 0) and np.all(values <= 1)):
                raise AssertionError('trained {}: bad {}'.format(
                    representation, name))
        torch.cuda.synchronize()
        start = time.perf_counter()
        sequence_mrr_score(model, test)
        mrr_warm_s = time.perf_counter() - start
        start = time.perf_counter()
        sequence_precision_recall_score(model, test, k=SEQ_K)
        pr_warm_s = time.perf_counter() - start
        log(trained_serving=representation, fit_s=fit_s,
            last_epoch_loss=model._last_epoch_loss, sequences=SEQ_EVAL,
            items=NUM_ITEMS, mrr_first_s=mrr_s, mrr_warm_s=mrr_warm_s,
            precision_recall_first_s=pr_s,
            precision_recall_warm_s=pr_warm_s,
            mean_mrr=float(mrr.mean()),
            mean_precision=float(precision.mean()), card=card)
        check_streaming_against_materialize(torch, model,
                                            sequences[:SEQ_CHECK],
                                            NUM_ITEMS)
        del model
        torch.cuda.empty_cache()
    return launches


def run_inbatch_epoch(torch, card):
    """One epoch of ``bench_sequence_large_catalog``'s mixture model with
    in-batch negatives."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    data = SequenceInteractions(sequence_rows(), num_items=NUM_ITEMS)
    model = ImplicitSequenceModel(
        loss='bpr', representation='mixture', embedding_dim=D,
        batch_size=SEQ_TRAIN_BATCH, n_iter=1, negative_sampling='in_batch',
        random_state=np.random.RandomState(0))
    seconds = timed_fit(torch, model, data, 1)
    log(training='sequence mixture in-batch', epochs=1, seconds=seconds,
        sequences_per_s=SEQ_ROWS / seconds,
        last_epoch_loss=model._last_epoch_loss, card=card)
    if not np.isfinite(model._last_epoch_loss):
        raise AssertionError('in-batch mixture: epoch loss {}'.format(
            model._last_epoch_loss))
    del model
    torch.cuda.empty_cache()


def run_bloom_training(torch, card):
    """``BLOOM_STEPS`` steps of phase 7's bloom LSTM (1e6 items, 200,000
    compressed rows of 64, 4 hashes) on its first sequences: finite
    losses, the compressed table and the item biases move, and the
    compressed padding row stays zero."""
    from spotlight_tpu_torch.data import SequenceInteractions

    model, sequences = bloom_model()
    rows = BLOOM_STEPS * model._batch_size
    data = SequenceInteractions(sequences[:rows], num_items=BLOOM_ITEMS)
    before = {name: value.clone()
              for name, value in model._net.state_dict().items()}
    seconds = timed_fit(torch, model, data, 1)
    table = model._net.item_embeddings.weight
    moved = [name for name, value in model._net.state_dict().items()
             if not torch.equal(value, before[name])]
    log(training='bloom lstm', steps=model._opt_state['count'],
        seconds=seconds, ms_per_step=seconds * 1e3 / BLOOM_STEPS,
        last_epoch_loss=model._last_epoch_loss, moved=moved, card=card)
    if (model._opt_state['count'] != BLOOM_STEPS
            or not np.isfinite(model._last_epoch_loss)
            or len(moved) != len(before) or bool(table[0].any())):
        raise AssertionError('the bloom LSTM did not train as it should')
    del model, before
    torch.cuda.empty_cache()


def sequence_gate_data(randomness):
    """``tests/sequence/test_sequence_implicit.py``'s gate data through the
    port: ``generate_sequential`` (100 users, 100 items, 1e4 interactions,
    order 2), split by user, sequences of 10."""
    from spotlight_tpu_torch.data import user_based_train_test_split
    from spotlight_tpu_torch.data.synthetic import generate_sequential

    train, test = user_based_train_test_split(
        generate_sequential(
            num_users=100, num_items=100, num_interactions=10000,
            concentration_parameter=randomness, order=2,
            random_state=np.random.RandomState(42)),
        random_state=np.random.RandomState(42))
    return (train.to_sequence(max_sequence_length=10),
            test.to_sequence(max_sequence_length=10))


def run_sequence_gates(torch, card):
    """The JAX package's gates of
    ``tests/sequence/test_sequence_implicit.py`` (LSTM ``:64``, mixture
    ``:115``) through ``fit`` and ``sequence_mrr_score`` on the card, on
    the port's ``generate_sequential`` data (100 users, 100 items, 1e4
    interactions, order 2; concentration 1e-3 and 1e2)."""
    from spotlight_tpu_torch.evaluation import sequence_mrr_score
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    results = {}
    for randomness in (1e-3, 1e2):
        train, test = sequence_gate_data(randomness)
        for representation, epochs, gate in (
                ('lstm', 25, 0.61 if randomness < 1 else 0.03),
                ('mixture', 50, 0.3 if randomness < 1 else 0.03)):
            model = ImplicitSequenceModel(
                loss='bpr', representation=representation, batch_size=128,
                embedding_dim=32, learning_rate=1e-2, l2=1e-7,
                n_iter=epochs, random_state=np.random.RandomState(42))
            model.fit(train)
            results['{} {:g}'.format(representation, randomness)] = (
                float(sequence_mrr_score(model, test).mean()), gate)
    log(sequence_gates={name: value for name, (value, _) in
                        results.items()}, card=card)
    for name, (value, gate) in results.items():
        if not value > gate:
            raise AssertionError('sequence gate {}: MRR {} is not > {}'
                                 .format(name, value, gate))


# -- phase 13: pooling and CNN sequences, the sequence lazy engine -----------

def lazy_sequence_data(num_items):
    """The bloom scalability study's data at ``num_items``
    (``examples/bloom_embeddings/performance.py``): ``SEQ_TRAIN_ROWS``
    random sequences of ``SEQ_LENGTH``, from ``RandomState(42)``."""
    from spotlight_tpu_torch.data import SequenceInteractions

    sequences = np.random.RandomState(42).randint(
        1, num_items, (SEQ_TRAIN_ROWS, SEQ_LENGTH)).astype(np.int32)
    return SequenceInteractions(sequences, num_items=num_items)


def lazy_sequence_model(representation, sparse, l2=0.0, device=DEVICE):
    """A phase 13 training model: bpr, D=64, batch 256, model seed 42."""
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    return ImplicitSequenceModel(
        loss='bpr', representation=representation, embedding_dim=D,
        batch_size=SEQ_TRAIN_BATCH, n_iter=1, sparse=sparse, l2=l2,
        random_state=np.random.RandomState(42), device=device)


def check_padding_row(model, where):
    """The lazy engine's padding row and its moments are exactly zero."""
    rows = [model._net.item_embeddings.weight[0],
            model._opt_state['table']['mu'][0],
            model._opt_state['table']['nu'][0]]
    if any(bool(row.any()) for row in rows):
        raise AssertionError('{}: the padding row or its moments moved'
                             .format(where))


def run_sequence_lazy_engine(torch, card):
    """The sequence lazy engine at the bloom study's exact-table width:
    ``LSTMNet``, D=64, 20,000 sequences of 50, batch 256 (79 steps an
    epoch, the last padded), bpr, ``sparse=True``, at each of
    ``LAZY_SEQ_ITEMS``; the dense engine beside it at the same N, in
    turns: one warm epoch of each, then one timed epoch of each.  The
    first warm lazy epoch captures P1's operands at step ``CAPTURE_STEP``.
    Then one ``pooling`` lazy epoch at the first N.  The P1 counter is
    zeroed just before the timed epochs and read just after (one launch a
    step); after each lazy fit the padding row and its moments are zero.
    Returns (launches, captured operands)."""
    from spotlight_tpu_torch.ops.kernels import row_update
    from spotlight_tpu_torch.sequence import lazy

    steps = -(-SEQ_TRAIN_ROWS // SEQ_TRAIN_BATCH)
    launches = 0
    captured = []
    for num_items in LAZY_SEQ_ITEMS:
        data = lazy_sequence_data(num_items)
        models = {engine: lazy_sequence_model('lstm', engine == 'lazy')
                  for engine in ('lazy', 'dense')}
        warm = {}
        for engine, model in models.items():
            undo = None
            if engine == 'lazy' and not captured:
                captured, undo = capture_row_updates(
                    CAPTURE_STEP, engine=lazy, calls_per_step=1)
            try:
                warm[engine] = timed_fit(torch, model, data, 1)
            finally:
                if undo is not None:
                    undo()
            if model._lazy != (engine == 'lazy'):
                raise AssertionError('the {} engine did not run'.format(
                    engine))
        # The main path of P1, with its counter zeroed just before it.
        row_update.ROW_ADAM_LAUNCHES = 0
        seconds = {engine: timed_fit(torch, model, data, 1)
                   for engine, model in models.items()}
        counted = row_update.ROW_ADAM_LAUNCHES
        launches += counted
        check_padding_row(models['lazy'], 'lazy lstm N={}'.format(num_items))
        log(training='sequence lazy against dense', num_items=num_items,
            config='lstm bpr D={} {} sequences x {} B={}'.format(
                D, SEQ_TRAIN_ROWS, SEQ_LENGTH, SEQ_TRAIN_BATCH),
            lazy_s_per_epoch=seconds['lazy'],
            dense_s_per_epoch=seconds['dense'],
            dense_over_lazy=seconds['dense'] / seconds['lazy'],
            warm_s=warm, row_adam_launches=counted,
            losses={engine: model._last_epoch_loss
                    for engine, model in models.items()}, card=card)
        if counted != steps or not all(
                np.isfinite(model._last_epoch_loss)
                for model in models.values()):
            raise AssertionError('lazy N={}: {} P1 launches, not {}'.format(
                num_items, counted, steps))
        del models, data
        torch.cuda.empty_cache()

    data = lazy_sequence_data(LAZY_SEQ_ITEMS[0])
    model = lazy_sequence_model('pooling', True)
    row_update.ROW_ADAM_LAUNCHES = 0
    seconds = timed_fit(torch, model, data, 1)
    counted = row_update.ROW_ADAM_LAUNCHES
    launches += counted
    check_padding_row(model, 'lazy pooling')
    log(training='sequence lazy pooling', num_items=LAZY_SEQ_ITEMS[0],
        s_per_epoch=seconds, row_adam_launches=counted,
        last_epoch_loss=model._last_epoch_loss, card=card)
    if counted != steps or not model._lazy:
        raise AssertionError('lazy pooling: {} P1 launches'.format(counted))
    del model, data
    torch.cuda.empty_cache()
    if len(captured) != 1:
        raise AssertionError('no P1 operands were captured')
    return launches, captured


def check_sequence_engine_operands(torch, card, captured):
    """P1 on the sequence lazy engine's own item call at step
    ``CAPTURE_STEP`` of the first warm epoch (25,600 ids: 12,800 positives
    and as many negatives, a padded row's ids routed past the table; W=65,
    float32, l2=0): bit for bit against its
    plain version in two launches, timed with and without its sort beside
    its bound, its plain version and ``SparseAdam`` from the captured
    moments.  Returns the kernel-table entry."""
    operands = captured[0]
    ids = operands['ids']
    param = operands['param']
    expected = 2 * SEQ_TRAIN_BATCH * SEQ_LENGTH
    if ids.numel() != expected:
        raise AssertionError('the captured item call has {} ids, not {}'
                             .format(ids.numel(), expected))
    shape = ('item table R={} W={} n={} float32 step={} t={} l2={} '
             '(sequence lazy engine, lstm)').format(
        param.shape[0], param.shape[1], ids.numel(), operands['step'],
        operands['t'], operands['l2'])
    entry = check_row_update(
        torch, card, shape, param, operands['mu'], operands['nu'], ids,
        operands['grads'].reshape(ids.numel(), -1), operands['t'],
        operands['lr'], operands['l2'], library=operands['l2'] == 0)
    torch.cuda.empty_cache()
    return dict(entry, name='row_adam (P1, sequence)')


def check_sequence_step_against_cpu(torch, card):
    """One sequence lazy step (``lstm``, bpr, D=64, batch 256 of 50 over
    ``SEQ_TRAIN_ITEMS`` items, l2=1e-6) on the card against the same step
    on the CPU, from the same parameters (drawn on the CPU) and draws: the
    loss, the item rows' gradients and the tower's first moments (a tenth
    of its gradients) within rtol 1e-5 of each one's largest element; the
    card's P1 call bit-equal to the plain version on its own gradients.
    The card's step runs with CUDA's synchronisation check set to raise."""
    from spotlight_tpu_torch.sequence import lazy
    from spotlight_tpu_torch.utils import training

    data = lazy_sequence_data(SEQ_TRAIN_ITEMS)
    results = {}
    for device in ('cpu', DEVICE):
        model = lazy_sequence_model('lstm', True, l2=1e-6, device=device)
        model._initialize(data)
        placed, n_valid, num_batches = model._epoch_data(data)
        perm, negatives = training.epoch_draws(
            model._generator, num_batches * SEQ_TRAIN_BATCH,
            (1, SEQ_TRAIN_BATCH, SEQ_LENGTH), SEQ_TRAIN_ITEMS, device)
        captured, undo = capture_row_updates(1, engine=lazy,
                                             calls_per_step=1)
        try:
            with no_host_sync(torch, device):
                loss = training.run_epoch(
                    model._step_fn(), placed, n_valid, 1, SEQ_TRAIN_BATCH,
                    perm[:SEQ_TRAIN_BATCH], negatives)
        finally:
            undo()
        results[device] = (float(loss), captured[0], {
            name: value.cpu()
            for name, value in model._opt_state['tower']['mu'].items()})
        check_padding_row(model, 'lazy step on ' + device)
    cpu_loss, cpu, cpu_tower = results['cpu']
    card_loss, gpu, card_tower = results[DEVICE]
    if not torch.equal(cpu['ids'], gpu['ids'].cpu()):
        raise AssertionError('the draws differ between the devices')
    gaps = {}
    for name, got, want in [('item rows', gpu['grads'].cpu(), cpu['grads'])] + [
            (name, card_tower[name], want)
            for name, want in cpu_tower.items()]:
        scale = float(want.abs().max())
        gaps[name] = float((got - want).abs().max()) / scale
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale,
                                   msg=name)
    check_captured_row_adam(torch, gpu, 'sequence step')
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    log(check='sequence lazy step: card against CPU', loss_card=card_loss,
        loss_cpu=cpu_loss, max_gap_of_scale=gaps, card=card)


def run_pool_cnn_gates(torch, card):
    """The JAX package's pooling and CNN gates through ``fit`` and
    ``sequence_mrr_score`` on the card: pooling at concentration 1e-3
    (> 0.18, the mean over the model seeds 0-3 and 42, as
    ``tests/test_torch_sequence_gates_pool_cnn.py`` holds it: the gate lies
    inside both packages' seed spread) and 1e2 (> 0.03), the CNN (kernel
    width 5, 40 epochs, > 0.65), and the lazy engine's pooling (> 0.18)
    and CNN (> 0.5) gates of ``tests/test_lazy_adam.py``.  Returns the
    lazy pooling and the dense CNN models with the gate test set."""
    from spotlight_tpu_torch.evaluation import sequence_mrr_score
    from spotlight_tpu_torch.sequence import CNNNet, ImplicitSequenceModel

    def fitted(representation, n_iter, learning_rate, l2, train, seed=42,
               sparse=False):
        model = ImplicitSequenceModel(
            loss='bpr', representation=representation, batch_size=128,
            embedding_dim=32, learning_rate=learning_rate, l2=l2,
            n_iter=n_iter, sparse=sparse,
            random_state=np.random.RandomState(seed)).fit(train)
        if model._lazy != sparse:
            raise AssertionError('the {} engine did not run'.format(
                'lazy' if sparse else 'dense'))
        return model

    def mrr(model, test):
        return float(sequence_mrr_score(model, test).mean())

    results = {}
    train, test = sequence_gate_data(1e-3)
    results['pooling 1e-3 (mean of seeds 0-3, 42)'] = (float(np.mean([
        mrr(fitted('pooling', 8, 1e-1, 1e-9, train, seed), test)
        for seed in (0, 1, 2, 3, 42)])), 0.18)
    cnn_model = fitted(CNNNet(train.num_items, embedding_dim=32,
                              kernel_width=5, num_layers=1,
                              generator=torch.Generator().manual_seed(42)),
                      40, 1e-2, 0.0, train)
    results['cnn 1e-3'] = (mrr(cnn_model, test), 0.65)
    lazy_models = {}
    for representation, gate, learning_rate in (('pooling', 0.18, 1e-1),
                                                ('cnn', 0.5, 1e-2)):
        lazy_models[representation] = fitted(
            representation, 40, learning_rate, 1e-7, train, sparse=True)
        results['lazy ' + representation] = (
            mrr(lazy_models[representation], test), gate)
    near_random, near_test = sequence_gate_data(1e2)
    results['pooling 1e2'] = (mrr(fitted('pooling', 8, 1e-1, 1e-9,
                                         near_random), near_test), 0.03)
    log(pool_cnn_gates={name: value for name, (value, _) in
                        results.items()}, card=card)
    for name, (value, gate) in results.items():
        if not value > gate:
            raise AssertionError('gate {}: MRR {} is not > {}'.format(
                name, value, gate))
    return lazy_models['pooling'], cnn_model, train, test


def check_serialization(torch, card, models, train, test):
    """``serialization.save`` and ``load`` of each of ``models`` (fitted on
    the card): the loaded tensors on the card, ``sequence_mrr_score``
    bit-equal, and a further epoch of each continues the step count and
    ends in the same parameters."""
    import io

    from spotlight_tpu_torch.evaluation import sequence_mrr_score
    from spotlight_tpu_torch.utils import serialization

    for model in models:
        buffer = io.BytesIO()
        serialization.save(model, buffer)
        buffer.seek(0)
        loaded = serialization.load(buffer)
        name = '{} {}'.format('lazy' if model._lazy else 'dense',
                              type(model._net).__name__)
        on_card = all(value.device.type == torch.device(DEVICE).type
                      for value in loaded._net.state_dict().values())
        equal = np.array_equal(sequence_mrr_score(loaded, test),
                               sequence_mrr_score(model, test))
        key = 't' if model._lazy else 'count'
        steps = model._opt_state[key]
        model._n_iter = loaded._n_iter = 1
        model.fit(train)
        loaded.fit(train)
        resumed = loaded._opt_state[key] == model._opt_state[key] > steps
        same = all(torch.equal(value, loaded._net.state_dict()[part])
                   for part, value in model._net.state_dict().items())
        log(check='serialization round trip', model=name, bytes=len(
            buffer.getvalue()), on_card=on_card, metric_bit_equal=equal,
            steps_before=steps, steps_after=loaded._opt_state[key],
            resumed_equal=same, card=card)
        if not (on_card and equal and resumed and same):
            raise AssertionError('{}: the serialization round trip failed'
                                 .format(name))


# -- phase 14: the ML-1M sequence sweep ---------------------------------------

def ml1m_interactions_from_columns(columns):
    """``Interactions`` from the ML-1M stand-in's columns, as
    ``get_movielens_dataset`` builds them from the file."""
    from spotlight_tpu_torch.data import Interactions

    return Interactions(columns['user_id'], columns['item_id'],
                        ratings=columns['rating'],
                        timestamps=columns['timestamp'])


def ml1m_interactions(columns, data_dir):
    """``(Interactions, route)``: where ``h5py`` imports, the columns are
    installed as the '1M' cache file under ``data_dir`` (as the
    ``SPOTLIGHT_DATA_DIR`` the loader reads) and loaded by
    ``get_movielens_dataset('1M')``, which must give the columns back;
    else they are built into ``Interactions`` as the loader builds them."""
    import importlib.util

    from spotlight_tpu_torch.data import fixtures
    from spotlight_tpu_torch.data.movielens import get_movielens_dataset

    if importlib.util.find_spec('h5py') is None:
        return ml1m_interactions_from_columns(columns), 'columns'
    fixtures.install_movielens_1m_fixture(data_directory=data_dir,
                                          columns=columns)
    saved = os.environ.get('SPOTLIGHT_DATA_DIR')
    os.environ['SPOTLIGHT_DATA_DIR'] = data_dir
    try:
        data = get_movielens_dataset('1M')
    finally:
        if saved is None:
            del os.environ['SPOTLIGHT_DATA_DIR']
        else:
            os.environ['SPOTLIGHT_DATA_DIR'] = saved
    for field, column in (('user_ids', 'user_id'), ('item_ids', 'item_id'),
                          ('ratings', 'rating'),
                          ('timestamps', 'timestamp')):
        if not np.array_equal(getattr(data, field), columns[column]):
            raise AssertionError('get_movielens_dataset: {} differ from '
                                 'the installed columns'.format(field))
    return data, 'get_movielens_dataset'


def ml1m_sequences(data):
    """``load_data`` of ``movielens_sequence.py``: two user-based splits of
    0.2 from ``RandomState(42)``, then ``to_sequence(200, 20, step
    200)``.  Returns the (train, validation, test) sequences."""
    from spotlight_tpu_torch.data import user_based_train_test_split

    random_state = np.random.RandomState(42)
    rest, test = user_based_train_test_split(
        data, test_percentage=0.2, random_state=random_state)
    train, validation = user_based_train_test_split(
        rest, test_percentage=0.2, random_state=random_state)
    return tuple(part.to_sequence(max_sequence_length=200,
                                  min_sequence_length=20, step_size=200)
                 for part in (train, validation, test))


def sweep_configurations():
    """``{representation: (hyperparameters, committed row)}``: the best
    configuration by validation MRR of each committed ML-1M log, read by
    the port's ``Results``; the port's hash of the hyperparameters must be
    the one the JAX package wrote."""
    from spotlight_tpu_torch.utils.results import Results

    configurations = {}
    for representation in ('cnn', 'pooling', 'lstm'):
        best = Results(SWEEP_LOG.format(representation)).best(
            'validation_mrr')
        hyperparameters = {
            key: value for key, value in best.items()
            if key not in ('hash', 'validation_mrr', 'test_mrr', 'elapsed')}
        if Results._hash(hyperparameters) != best['hash']:
            raise AssertionError('{}: the port\'s hash of the configuration '
                                 'differs from the log\'s'.format(
                                     representation))
        configurations[representation] = (hyperparameters, best)
    return configurations


def sweep_model(torch, representation, h, num_items, seed):
    """``build_model`` of ``movielens_sequence.py``, its network and stream
    seeded with ``seed``."""
    from spotlight_tpu_torch.sequence import CNNNet, ImplicitSequenceModel

    if representation == 'cnn':
        representation = CNNNet(
            num_items, embedding_dim=h['embedding_dim'],
            kernel_width=h['kernel_width'], dilation=tuple(h['dilation']),
            num_layers=h['num_layers'], nonlinearity=h['nonlinearity'],
            residual_connections=h['residual'],
            generator=torch.Generator().manual_seed(seed), device=DEVICE)
    return ImplicitSequenceModel(
        loss=h['loss'], representation=representation,
        embedding_dim=h['embedding_dim'], batch_size=h['batch_size'],
        learning_rate=h['learning_rate'], l2=h['l2'], n_iter=h['n_iter'],
        random_state=np.random.RandomState(seed), device=DEVICE)


def traced_fit(torch, card, name, model, train, log_dir):
    """One epoch of ``model`` over the first ``SWEEP_PROFILED_STEPS[name]``
    of its batches of ``train`` under ``profiling.trace``: its device calls
    and busy ms a step, the idle share, and the seconds of the whole trace
    (the epoch, the trace's export and its summary)."""
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.utils import profiling

    steps = SWEEP_PROFILED_STEPS[name]
    data = SequenceInteractions(
        train.sequences[:steps * model._batch_size],
        num_items=train.num_items)
    model._n_iter = 1
    began = time.perf_counter()
    with profiling.trace(log_dir, device=DEVICE) as traced:
        start = time.perf_counter()
        model.fit(data)
        wall_ms = (time.perf_counter() - start) * 1e3
    summary = profile_summary(card, name, traced.profiler, wall_ms)
    summary.update(steps=steps, traced_s=time.perf_counter() - began,
                   device_calls_per_step=summary['device_calls'] / steps,
                   device_busy_ms_per_step=(summary['device_busy_ms']
                                            / steps),
                   trace_bytes=os.path.getsize(os.path.join(traced,
                                                            'trace.json')))
    log(sweep_epoch=name, card=card, **{key: summary[key] for key in (
        'steps', 'wall_ms', 'device_calls_per_step',
        'device_busy_ms_per_step', 'device_idle_share', 'trace_bytes',
        'traced_s')})
    return summary


def run_ml1m_sweep(torch, card):
    """Phase 14: the ML-1M sequence sweep at its best configurations, end
    to end; the launch counters zeroed just before and read just after.
    Then K1, K1c and K2 on the last CNN's operands against their plain
    versions, and the gates.  Returns the launch counts."""
    import tempfile

    from spotlight_tpu_torch import native
    from spotlight_tpu_torch.data import fixtures
    from spotlight_tpu_torch.evaluation import (
        sequence_mrr_score, sequence_precision_recall_score)
    from spotlight_tpu_torch.utils.profiling import ThroughputMeter
    from spotlight_tpu_torch.utils.results import Results

    torch.cuda.synchronize()
    reset_counters()
    work = tempfile.TemporaryDirectory(prefix='ml1m_sweep_')
    start = time.perf_counter()
    columns = fixtures.generate_movielens_1m_like()
    generate_s = time.perf_counter() - start
    library = native.load()
    log(sweep_walk='native' if library is not None else 'python loop',
        library=None if library is None else str(native.library_path()),
        generate_s=generate_s)
    if library is None:
        raise AssertionError('the native Markov walk did not build')
    data, route = ml1m_interactions(columns, work.name)
    train, validation, test = ml1m_sequences(data)
    log(sweep_data=route, interactions=len(data), users=data.num_users,
        items=data.num_items, train=train.sequences.shape,
        validation=validation.sequences.shape, test=test.sequences.shape)
    configurations = sweep_configurations()
    for representation, (h, best) in configurations.items():
        log(sweep_configuration=representation, hyperparameters=h,
            committed_validation_mrr=best['validation_mrr'],
            committed_test_mrr=best['test_mrr'])

    results = Results(os.path.join(work.name, 'sweep.jsonl'))
    means, last_cnn = {}, None
    for representation in ('cnn', 'pooling'):
        h, best = configurations[representation]
        meter = ThroughputMeter(warmup_steps=1, device=DEVICE)
        rows = len(train.sequences)
        steps = -(-rows // h['batch_size'])
        test_mrrs = []
        for seed in SWEEP_SEEDS:
            model = sweep_model(torch, representation, h, train.num_items,
                                seed)
            torch.cuda.synchronize()
            began = time.perf_counter()
            with meter.step(rows * h['n_iter']):
                model.fit(train)
            fit_s = time.perf_counter() - began
            validation_mrr = float(sequence_mrr_score(model,
                                                      validation).mean())
            mrr = sequence_mrr_score(model, test)
            precision, recall = sequence_precision_recall_score(model, test,
                                                                k=SEQ_K)
            torch.cuda.synchronize()
            began = time.perf_counter()
            sequence_mrr_score(model, test)
            mrr_ms = (time.perf_counter() - began) * 1e3
            began = time.perf_counter()
            sequence_precision_recall_score(model, test, k=SEQ_K)
            pr_ms = (time.perf_counter() - began) * 1e3
            config = dict(h, representation=representation, seed=seed)
            row = results.save(
                config, validation_mrr=validation_mrr,
                test_mrr=float(mrr.mean()),
                test_precision_at_10=float(precision.mean()),
                test_recall_at_10=float(recall.mean()), fit_s=fit_s,
                mrr_warm_ms=mrr_ms, precision_recall_warm_ms=pr_ms)
            if config not in results:
                raise AssertionError('the sweep log lost a row')
            log(sweep_fit=representation, seed=seed, fit_s=fit_s,
                epochs=h['n_iter'], steps_per_epoch=steps,
                ms_per_step=fit_s * 1e3 / (steps * h['n_iter']),
                last_epoch_loss=model._last_epoch_loss,
                validation_mrr=validation_mrr, test_mrr=row['test_mrr'],
                test_precision_at_10=row['test_precision_at_10'],
                mrr_warm_ms=mrr_ms, precision_recall_warm_ms=pr_ms,
                card=card)
            test_mrrs.append(row['test_mrr'])
            if seed == SWEEP_SEEDS[0]:
                traced_fit(torch, card, representation, model, train,
                           os.path.join(work.name, representation))
            if representation == 'cnn':
                last_cnn = model
            else:
                del model
        means[representation] = (float(np.mean(test_mrrs)),
                                 SWEEP_GATES[representation]
                                 * best['test_mrr'])
        log(sweep=representation, seeds=list(SWEEP_SEEDS),
            test_mrr=test_mrrs, mean_test_mrr=means[representation][0],
            gate=means[representation][1],
            sequences_per_s=meter.examples_per_second(),
            measured_fits=meter.measured_steps, card=card)

    # The LSTM at the sweep's best configuration: SWEEP_LSTM_STEPS timed
    # steps, and one of its steps traced.
    from spotlight_tpu_torch.data import SequenceInteractions

    h, _ = configurations['lstm']
    model = sweep_model(torch, 'lstm', h, train.num_items, SWEEP_SEEDS[0])
    steps = SWEEP_LSTM_STEPS
    rows = train.sequences[:steps * h['batch_size']]
    fit_s = timed_fit(torch, model, SequenceInteractions(
        rows, num_items=train.num_items), 1)
    summary = traced_fit(torch, card, 'lstm', model, train,
                         os.path.join(work.name, 'lstm'))
    log(sweep_lstm_fit_s=fit_s, steps=steps,
        epoch_steps=-(-len(train.sequences) // h['batch_size']),
        ms_per_step=fit_s * 1e3 / steps,
        sequences_per_s=len(rows) / fit_s,
        device_calls_per_step=summary['device_calls_per_step'],
        device_idle_share=summary['device_idle_share'],
        last_epoch_loss=model._last_epoch_loss, card=card)
    if not np.isfinite(model._last_epoch_loss):
        raise AssertionError('lstm: epoch loss {}'.format(
            model._last_epoch_loss))
    del model

    launches = counters()
    log(sweep_launches=launches, results_rows=len(results))
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError('{} never launched on the ML-1M sweep'
                                 .format(name))
    check_streamed('ML-1M sweep')
    work.cleanup()
    check_sweep_kernels(torch, card, last_cnn, test)
    for representation, (mean, gate) in means.items():
        if not mean >= gate:
            raise AssertionError(
                'ML-1M gate {}: mean test MRR {} of seeds {} is under {}'
                .format(representation, mean, SWEEP_SEEDS, gate))
    return launches


def check_sweep_kernels(torch, card, model, test):
    """K1, K1c and K2 with dot scoring on the trained CNN's own operands:
    the test prefixes of ``sequence_mrr_score`` (T=1) and of
    ``sequence_precision_recall_score`` at k=10, bit for bit against their
    plain versions."""
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    reprs, items, bias, mixtures = model._rank_factors_sequences(
        test.sequences[:, :-1])
    if mixtures is not None:
        raise AssertionError('the CNN scores by dots')
    targets = torch.as_tensor(test.sequences[:, -1:].astype(np.int64),
                              device=DEVICE)
    ts = ranking.matched_target_scores(reprs, items, bias, targets)
    ts_plain = ranking.matched_target_scores_plain(reprs, items, bias,
                                                   targets)
    weights = ranking.rank_weights(reprs, items, bias, ts)
    plain = ranking.rank_weights_plain(reprs, items, bias, ts_plain)
    reprs_k = model._rank_factors_sequences(test.sequences[:, :-SEQ_K])[0]
    scores, top = topk.streaming_topk(reprs_k, items, bias, SEQ_K)
    p_scores, p_top = topk.streaming_topk_plain(reprs_k, items, bias, SEQ_K)
    shape = 'B={} N={} D={}'.format(reprs.shape[0], items.shape[0],
                                    reprs.shape[1])
    log(check='ML-1M sweep kernels on the trained CNN', shape=shape,
        matched_target_scores_ulp=ulp_gap(torch, ts, ts_plain),
        rank_weights_apart=int((weights != plain).sum()),
        topk_ids_apart=int((top != p_top).sum()),
        topk_scores_ulp=ulp_gap(torch, scores, p_scores), card=card)
    if not (same_bits(torch, ts, ts_plain) and torch.equal(weights, plain)
            and torch.equal(top, p_top)
            and same_bits(torch, scores, p_scores)):
        raise AssertionError('a kernel differs from its plain version on '
                             'the trained CNN at ' + shape)
    if not bool((weights >= 0.5).all()):
        raise AssertionError('a target lost its self-tie')


# -- phase 5: where the time goes --------------------------------------------

def profile_metrics(torch, card, model, test, train, heavy):
    """Per metric: one warm call timed on the host clock (the item factors
    are cached by now), then one call under the profiler for the device
    time by kernel.  Also the host's share: the CSR conversion and the
    compact rows that precede the first batch."""
    from spotlight_tpu_torch import evaluation

    start = time.perf_counter()
    evaluation._eval_rows(test, heavy)
    log(host='_eval_rows (test + train CSR, compact rows)',
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
    """Device time by kernel, the idle share and the number of device
    kernel calls of one call of ``call`` under ``torch.profiler``.  Returns
    the logged summary."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        call()
        wall_ms = (time.perf_counter() - start) * 1e3
    return profile_summary(card, name, prof, wall_ms)


def profile_summary(card, name, prof, wall_ms):
    """The logged summary of a profile: device ms by kernel, busy ms, the
    idle share of ``wall_ms`` and the device kernel calls.  Only the
    device's own activities count: a host row of ``key_averages()`` (an
    operator, or a ``profiling.span`` open across a launch) repeats the
    device time of what it launched."""
    import torch

    by_kernel = collections.Counter()
    device_calls = 0
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[event.name[:80]] += (event.time_range.end
                                           - event.time_range.start) / 1e3
            device_calls += 1
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    summary = dict(profile=name, wall_ms=wall_ms, device_busy_ms=busy_ms,
                   device_idle_share=(1 - busy_ms / wall_ms) if busy_ms
                   else None, device_calls=device_calls,
                   top_kernels_ms=dict(top))
    log(card=card, **summary)
    return summary


# -- phase 10: the routes past the kernels -----------------------------------

def routed(metric, *args, **kwargs):
    """(metric result, materialize routes it counted, streaming=False's
    result)."""
    from spotlight_tpu_torch import evaluation

    before = evaluation.MATERIALIZE_ROUTES
    got = metric(*args, **kwargs)
    routes = evaluation.MATERIALIZE_ROUTES - before
    return got, routes, metric(*args, streaming=False, **kwargs)


def check_routes(torch, card, test, train):
    """A BilinearNet of D=ROUTE_DIM over phase 4's catalogue and its first
    CHECK_USERS test users, and phase 6's mixture model with ROUTE_MIXTURES
    tastes over SEQ_CHECK sequences, through their metrics with the
    default ``streaming=True``: a call the kernels take streams (its
    kernels launch), a call they do not take runs on the materialize path
    and counts once in MATERIALIZE_ROUTES (its kernels do not launch).
    Each metric equals streaming=False's: the BilinearNet's dyadic
    factors (parameter_tree) score exactly in any order, and the mixture
    model's calls all take the materialize path."""
    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.data import SequenceInteractions
    from spotlight_tpu_torch.evaluation import (
        mrr_score, precision_recall_score, sequence_mrr_score,
        sequence_precision_recall_score)
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.ops.kernels import ranking, topk
    from spotlight_tpu_torch.sequence import (ImplicitSequenceModel,
                                              MixtureLSTMNet)
    from spotlight_tpu_torch.utils.convert import params_from_jax

    def check(name, want_routes, launch_count, metric, *args, **kwargs):
        before = launch_count()
        got, routes, materialized = routed(metric, *args, **kwargs)
        launched = launch_count() - before
        if routes != want_routes or (launched > 0) != (want_routes == 0):
            raise AssertionError(
                '{}: {} materialize routes and {} kernel launches, want {} '
                'routes'.format(name, routes, launched, want_routes))
        if isinstance(got, tuple):
            for got_part, want_part in zip(got, materialized):
                np.testing.assert_array_equal(got_part, want_part)
        else:
            np.testing.assert_allclose(got, materialized, rtol=1e-6, atol=0)
        log(route=name, materialize_routes=routes, kernel_launches=launched,
            equals_streaming_false=True, card=card)

    model = ImplicitFactorizationModel(
        loss='bpr', embedding_dim=ROUTE_DIM,
        random_state=np.random.RandomState(42))
    model._initialize(train)
    model._load_params(params_from_jax(
        model._net, parameter_tree(np.random.RandomState(1), ROUTE_DIM)))
    sub = restrict(test, CHECK_USERS)
    # The call's widest top-10 fetch holds lists of at most 64 keys, where
    # stage 1 takes D <= 261.
    fetch = 10 + evaluation._eval_rows(sub, train)[2].width
    if fetch > 64:
        raise AssertionError('the route check\'s fetch is {}'.format(fetch))
    check('mrr_score D={}'.format(ROUTE_DIM), 0,
          lambda: ranking.RANK_WEIGHTS_LAUNCHES, mrr_score, model, sub,
          train=train)
    check('precision_recall_score D={} k=10'.format(ROUTE_DIM), 1,
          lambda: topk.STREAMING_TOPK_LAUNCHES, precision_recall_score,
          model, sub, train=train, k=10)
    del model
    torch.cuda.empty_cache()

    sequences = sequence_rows()[:SEQ_CHECK]
    net = MixtureLSTMNet(NUM_ITEMS, D, num_mixtures=ROUTE_MIXTURES,
                         generator=torch.Generator().manual_seed(0),
                         device=DEVICE)
    model = ImplicitSequenceModel(loss='bpr', representation=net,
                                  embedding_dim=D)
    seq_test = SequenceInteractions(sequences, num_items=NUM_ITEMS)
    model._initialize(seq_test)

    def mixture_launches():
        return (ranking.MIXTURE_RANK_WEIGHTS_LAUNCHES
                + topk.MIXTURE_STREAMING_TOPK_LAUNCHES)

    name = ' M={}'.format(ROUTE_MIXTURES)
    check('sequence_mrr_score' + name, 1, mixture_launches,
          sequence_mrr_score, model, seq_test)
    check('sequence_mrr_score exclude_preceding' + name, 1,
          mixture_launches, sequence_mrr_score, model, seq_test,
          exclude_preceding=True)
    check('sequence_precision_recall_score k={}'.format(SEQ_K) + name, 1,
          mixture_launches, sequence_precision_recall_score, model,
          seq_test, k=SEQ_K)
    del model, net
    torch.cuda.empty_cache()


# -- phase 15: sharded evaluation on a mesh of ranks --------------------------

#: Ranks of the gloo mesh, every one on the one card, and its two layouts.
MESH_RANKS = 4
MESH_LAYOUTS = ((1, 4), (2, 2))
#: Seconds a collective or the group's start may wait before it raises.
MESH_TIMEOUT_S = 120
#: The catalogue that does not divide by 4 (padded to 1,004 rows).
EDGE_USERS = 500
EDGE_ITEMS = 1_001
EDGE_EVAL_USERS = 300
EDGE_TRAIN_PAIRS = 5_000


def mesh_counters():
    """The launch counters of the kernels of the mesh path."""
    from spotlight_tpu_torch.ops.kernels import ranking

    return {**counters(), **sequence_counters(),
            'rank_counts': ranking.RANK_COUNTS_LAUNCHES}


def reset_mesh_counters():
    from spotlight_tpu_torch.ops.kernels import ranking

    reset_counters()
    reset_sequence_counters()
    ranking.RANK_COUNTS_LAUNCHES = 0


def mesh_inputs():
    """The phase's data, made from seeds alike on every rank: phase 4's MF
    interactions, phase 6's sequences and the N=1,001 catalogue's."""
    from spotlight_tpu_torch.data import SequenceInteractions

    _, train, test, heavy = slice_data()
    _, edge_train, edge_test, _ = slice_data(
        EDGE_USERS, EDGE_ITEMS, EDGE_EVAL_USERS, EDGE_TRAIN_PAIRS, seed=8)
    sequences = SequenceInteractions(sequence_rows()[:SEQ_EVAL],
                                     num_items=NUM_ITEMS)
    return dict(train=train, test=test, heavy=heavy, sequences=sequences,
                edge_train=edge_train, edge_test=edge_test)


def mesh_models(inputs, mesh=None):
    """(MF model, mixture model, N=1,001 MF model), from their seeds, on
    ``mesh`` if one is given (else on the card)."""
    mf, _ = slice_model(inputs['train'], mesh)
    mixture, _ = sequence_model(mesh)
    edge, _ = slice_model(inputs['edge_train'], mesh, seed=1)
    return mf, mixture, edge


def mesh_calls(torch, models, inputs):
    """Every metric call of the phase, each once to warm up and once timed:
    ({name: numpy result}, {name: wall ms of the timed call})."""
    from spotlight_tpu_torch.evaluation import (
        mrr_score, precision_recall_score, sequence_mrr_score,
        sequence_precision_recall_score)

    mf, mixture, edge = models
    test, train, heavy = inputs['test'], inputs['train'], inputs['heavy']
    sequences = inputs['sequences']
    calls = {
        'mrr_score (MF, train)': lambda: mrr_score(mf, test, train=train),
        'mrr_score (MF)': lambda: mrr_score(mf, test),
        'precision_recall_score (MF, heavy train)':
            lambda: precision_recall_score(mf, test, train=heavy, k=10),
        'precision_recall_score (MF)':
            lambda: precision_recall_score(mf, test, k=10),
        'sequence_mrr_score (mixture)':
            lambda: sequence_mrr_score(mixture, sequences),
        'sequence_precision_recall_score (mixture)':
            lambda: sequence_precision_recall_score(mixture, sequences,
                                                    k=SEQ_K),
        'mrr_score (N=1,001, train)': lambda: mrr_score(
            edge, inputs['edge_test'], train=inputs['edge_train']),
        'precision_recall_score (N=1,001, train)':
            lambda: precision_recall_score(edge, inputs['edge_test'],
                                           train=inputs['edge_train'], k=10),
    }
    results, ms = {}, {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        start = time.perf_counter()
        results[name] = call()
        ms[name] = (time.perf_counter() - start) * 1e3
    return results, ms


def check_shard_kernels(torch, mesh, models, inputs):
    """K1, K2 and K5 on two blocks of a 1 x 4 mesh against their plain
    versions on the same operands: the first block of the MF catalogue at
    CHECK_USERS users, and the last block of the N=1,001 catalogue, which
    holds the three pad rows (zero vectors, bias -FLOAT_MAX), each on the
    rank that holds it (the models hold their ranks' blocks).  Every rank
    calls alike: the user rows come through the exchange.  Targets are
    global ids shifted into the block, most outside it; their scores are
    the matched scores of the block's rows they clamp to.  Returns the
    shapes this rank checked."""
    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.ops.kernels import ranking, topk

    checked = []
    for name, model, test, block in (
            ('MF, first block', models[0], inputs['test'], 0),
            ('N=1,001, last block', models[2], inputs['edge_test'],
             mesh.shape['model'] - 1)):
        users, catalogue, catalogue_bias, _ = model._rank_factors_users(
            np.arange(min(CHECK_USERS, test.num_users)))
        rows, items, bias, first = evaluation._shard_catalog(
            model, mesh, catalogue, catalogue_bias)
        if mesh.model_index != block:
            continue
        targets = torch.as_tensor(np.random.RandomState(block).randint(
            0, model._num_items, (users.shape[0], 4)), device=users.device)
        local = targets - first
        scores = ranking.matched_target_scores(users, items, bias,
                                               local.clamp(0, rows - 1))
        got = ranking.rank_weights(users, items, bias, scores)
        want = ranking.rank_weights_plain(users, items, bias, scores)
        if not torch.equal(got, want):
            raise AssertionError('rank_weights on {}'.format(name))
        got = ranking.rank_counts(users, items, bias, scores, local)
        want = ranking.rank_counts_plain(users, items, bias, scores, local)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError('rank_counts on {}'.format(name))
        k = min(MAIN_TOPK_K, rows)
        got = topk.streaming_topk(users, items, bias, k)
        want = topk.streaming_topk_plain(users, items, bias, k)
        if not (torch.equal(got[1], want[1])
                and same_bits(torch, got[0], want[0])):
            raise AssertionError('streaming_topk on {}'.format(name))
        checked.append(dict(block=name, rank=mesh.rank, users=users.shape[0],
                            rows=rows, first_row=first, targets=4, k=k))
    return checked


def mesh_rank(rank, world, store, out_dir):
    """One rank of the gloo mesh on the card (started by
    ``torch.multiprocessing.spawn``; an exception here fails the phase):
    the metric calls on each layout, with the launch counters zeroed just
    before and read just after, then the block checks at 1 x 4."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    # The ranks share the host's cores.
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        'gloo', init_method='file://' + store, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    inputs = mesh_inputs()
    out = {}
    for layout in MESH_LAYOUTS:
        mesh = make_mesh(*layout, devices=['cuda:0'] * world)
        models = mesh_models(inputs, mesh)
        torch.cuda.synchronize()
        reset_mesh_counters()
        results, ms = mesh_calls(torch, models, inputs)
        out[layout] = dict(results=results, ms=ms,
                           launches=mesh_counters(),
                           routes=evaluation.MATERIALIZE_ROUTES,
                           device=str(models[0]._device))
        if layout == (1, 4):
            out['shard_checks'] = check_shard_kernels(torch, mesh, models,
                                                      inputs)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, 'rank{}.pkl'.format(rank)), 'wb') as fh:
        pickle.dump(out, fh)


def same_arrays(got, want):
    """Equal numpy results (a tuple of arrays or one), float32 bit for
    bit."""
    if isinstance(got, tuple):
        return len(got) == len(want) and all(
            same_arrays(a, b) for a, b in zip(got, want))
    return (got.shape == want.shape and got.dtype == want.dtype
            and np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                               np.ascontiguousarray(want).view(np.uint8)))


def run_mesh_ranks(torch, card, inputs):
    """(a) MESH_RANKS gloo ranks on the one card over both layouts: every
    rank's every metric bit-equal to the single-device call, no call on the
    materialize route, the path's kernels launched.  Returns the ranks'
    summed launch counts."""
    import pickle
    import shutil

    out_dir = os.path.join(ROOT, 'build', 'mesh_smoke')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    models = mesh_models(inputs)
    want, want_ms = mesh_calls(torch, models, inputs)
    del models
    torch.cuda.empty_cache()
    start = time.perf_counter()
    torch.multiprocessing.spawn(
        mesh_rank, args=(MESH_RANKS, os.path.join(out_dir, 'store'),
                         out_dir), nprocs=MESH_RANKS, join=True)
    spawn_s = time.perf_counter() - start
    ranks = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(out_dir, 'rank{}.pkl'.format(rank)),
                  'rb') as fh:
            ranks.append(pickle.load(fh))
    launches = {}
    for layout in MESH_LAYOUTS:
        for rank, out in enumerate(ranks):
            got = out[layout]
            if got['routes']:
                raise AssertionError('{} mesh calls took the materialize '
                                     'route'.format(got['routes']))
            if got['device'] != 'cuda:0':
                raise AssertionError('rank {} ran on {}'.format(
                    rank, got['device']))
            for name, result in want.items():
                if not same_arrays(got['results'][name], result):
                    raise AssertionError('{} on rank {} of {} x {} differs '
                                         'from one device'.format(
                                             name, rank, *layout))
            for name, count in got['launches'].items():
                launches[name] = launches.get(name, 0) + count
        for name in want:
            log(mesh_call=name, layout='{} x {}'.format(*layout),
                rank_ms=[out[layout]['ms'][name] for out in ranks],
                one_device_ms=want_ms[name], bit_equal=True,
                note='four ranks share one card: not a scaling figure',
                card=card)
    log(mesh_path_launches=launches, ranks=MESH_RANKS,
        layouts=[list(layout) for layout in MESH_LAYOUTS],
        spawn_s=spawn_s)
    for name in ('rank_weights', 'matched_target_scores', 'streaming_topk',
                 'rank_weights (mixture)', 'streaming_topk (mixture)',
                 'matched_candidate_scores'):
        if launches.get(name, 0) <= 0:
            raise AssertionError('{} never launched on the mesh path'
                                 .format(name))
    checks = [check for out in ranks for check in out['shard_checks']]
    if len(checks) != 2:
        raise AssertionError('{} block checks ran'.format(len(checks)))
    log(mesh_shard_checks=checks, bit_equal=True)
    return launches


def run_nccl_mesh(torch, card, inputs):
    """(b) A one-rank NCCL group: the four sharded functions at the MF
    width (model axis 1), with the launch counters zeroed just before and
    read just after, each exactly equal to the single-device kernel.
    Returns the launch counts."""
    import datetime

    import torch.distributed as dist

    from spotlight_tpu_torch.ops.kernels import ranking, topk
    from spotlight_tpu_torch.parallel import evaluation as pe
    from spotlight_tpu_torch.parallel import make_mesh

    model, _ = slice_model(inputs['train'])
    users, items, bias, _ = model._rank_factors_users(
        np.arange(CHECK_USERS))
    targets = torch.as_tensor(np.random.RandomState(9).randint(
        0, NUM_ITEMS, (CHECK_USERS, TEST_PER_USER)), device=users.device)
    store = os.path.join(ROOT, 'build', 'mesh_smoke', 'nccl_store')
    dist.init_process_group(
        'nccl', init_method='file://' + store, world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_mesh(data=1, model=1, devices=['cuda:0'])
        torch.cuda.synchronize()
        reset_mesh_counters()
        start = time.perf_counter()
        scores = pe.sharded_candidate_scores(mesh, users, items, bias,
                                             targets)
        weights = pe.sharded_rank_weights(mesh, users, items, bias, scores)
        greater, equal = pe.sharded_rank_counts(mesh, users, items, bias,
                                                scores, targets)
        top = pe.sharded_topk(mesh, users, items, bias, MAIN_TOPK_K)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
        launches = mesh_counters()
    finally:
        dist.destroy_process_group()
    checks = {
        'sharded_candidate_scores': same_bits(
            torch, scores, ranking.matched_target_scores(users, items, bias,
                                                         targets)),
        'sharded_rank_weights': torch.equal(
            weights, ranking.rank_weights(users, items, bias, scores)),
        'sharded_rank_counts': all(torch.equal(a, b) for a, b in zip(
            (greater, equal),
            ranking.rank_counts(users, items, bias, scores, targets))),
        'sharded_topk': same_arrays(
            tuple(t.cpu().numpy() for t in top),
            tuple(t.cpu().numpy() for t in topk.streaming_topk(
                users, items, bias, MAIN_TOPK_K)))}
    log(nccl_one_rank=checks, users=CHECK_USERS, items=NUM_ITEMS, dim=D,
        k=MAIN_TOPK_K, wall_ms=wall_ms, launches=launches, card=card)
    if not all(checks.values()):
        raise AssertionError('sharded functions under NCCL: {}'.format(
            checks))
    for name in ('rank_weights', 'matched_target_scores', 'streaming_topk',
                 'rank_counts'):
        if launches[name] <= 0:
            raise AssertionError('{} never launched under NCCL'.format(name))
    return launches


def run_mesh_phase(torch, card):
    """Phase 15: returns the launch counts of the mesh path, (a) and (b)
    together, by kernel entry."""
    inputs = mesh_inputs()
    launches = run_mesh_ranks(torch, card, inputs)
    for name, count in run_nccl_mesh(torch, card, inputs).items():
        launches[name] = launches.get(name, 0) + count
    launches['mixture_score'] = sum(
        launches[name] for name in sequence_counters())
    return launches


# -- phase 16: mesh training ---------------------------------------------------

MESH_EXCHANGES = ('psum', 'alltoall', 'alltoall_cf')
#: Phase 4's implicit MF trained on the mesh: batch and steps (one epoch
#: over the first steps x batch of phase 4's train pairs).
MESH_TRAIN_BATCH = 8_192
MESH_TRAIN_STEPS = 8
NCCL_TRAIN_STEPS = 4
#: Phase 6's mixture LSTM (at 2 x 2) and phase 7's bloom LSTM (at 1 x 4),
#: trained by steps of 256 sequences.
MESH_SEQ_BATCH = 256
MESH_MIXTURE_STEPS = 4
MESH_BLOOM_STEPS = 2
#: Where a rank's block of a table or moment differs in its bits from one
#: device's run, its largest gap over the largest |value| of that table or
#: moment of the one-device run.
MESH_TRAIN_RTOL = 1e-4


def mesh_train_runs(layout):
    """The runs of phase 16 on a layout (None: one device), each ``(name,
    reference name, build(mesh) -> (model, data), metrics(model) ->
    {name: numpy})``: phase 4's MF under each exchange, then phase 6's
    mixture LSTM (psum) at 2 x 2 and phase 7's bloom LSTM (psum) at
    1 x 4."""
    from spotlight_tpu_torch.data import Interactions, SequenceInteractions
    from spotlight_tpu_torch.evaluation import (
        mrr_score, precision_recall_score, sequence_mrr_score)
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    _, train, test, _ = slice_data()
    pairs = MESH_TRAIN_STEPS * MESH_TRAIN_BATCH
    mf_data = Interactions(train.user_ids[:pairs], train.item_ids[:pairs],
                           num_users=NUM_USERS, num_items=NUM_ITEMS)

    def mf(exchange):
        def build(mesh):
            return ImplicitFactorizationModel(
                loss='bpr', embedding_dim=D, n_iter=1,
                batch_size=MESH_TRAIN_BATCH, mesh=mesh, exchange=exchange,
                random_state=np.random.RandomState(42)), mf_data
        return build

    def mf_metrics(model):
        return {'mrr_score (train)': mrr_score(model, test, train=mf_data),
                'precision_recall_score k=10': precision_recall_score(
                    model, test, k=10)}

    def mixture(mesh):
        data = SequenceInteractions(
            sequence_rows()[:MESH_MIXTURE_STEPS * MESH_SEQ_BATCH],
            num_items=NUM_ITEMS)
        return ImplicitSequenceModel(
            loss='bpr', representation='mixture', embedding_dim=D, n_iter=1,
            batch_size=MESH_SEQ_BATCH, mesh=mesh,
            random_state=np.random.RandomState(0)), data

    def bloom(mesh):
        import torch

        from spotlight_tpu_torch.ops.embeddings import BloomEmbedding
        from spotlight_tpu_torch.sequence import LSTMNet

        generator = torch.Generator().manual_seed(0)
        net = LSTMNet(BLOOM_ITEMS, embedding_dim=D,
                      item_embedding_layer=BloomEmbedding(
                          BLOOM_ITEMS, D, compression_ratio=BLOOM_RATIO,
                          num_hash_functions=BLOOM_HASHES,
                          generator=generator),
                      generator=generator)
        data = SequenceInteractions(
            bloom_sequences()[:MESH_BLOOM_STEPS * MESH_SEQ_BATCH],
            num_items=BLOOM_ITEMS)
        return ImplicitSequenceModel(
            loss='bpr', representation=net, n_iter=1,
            batch_size=MESH_SEQ_BATCH, mesh=mesh,
            random_state=np.random.RandomState(0)), data

    def sequence_metrics(rows, num_items):
        def metrics(model):
            test = SequenceInteractions(rows[:SEQ_EVAL], num_items=num_items)
            return {'sequence_mrr_score': sequence_mrr_score(model, test)}
        return metrics

    # One device: the exchange plays no part, one run of each model.
    exchanges = MESH_EXCHANGES if layout is not None else ('psum',)
    runs = [('MF ' + exchange, 'MF', mf(exchange), mf_metrics)
            for exchange in exchanges]
    if layout in (None, (2, 2)):
        runs.append(('mixture LSTM psum', 'mixture LSTM', mixture,
                     sequence_metrics(sequence_rows(), NUM_ITEMS)))
    if layout in (None, (1, 4)):
        runs.append(('bloom LSTM psum', 'bloom LSTM', bloom,
                     sequence_metrics(bloom_sequences(), BLOOM_ITEMS)))
    return runs


def train_steps(model, data):
    """The steps of one epoch of ``model`` over ``data``."""
    rows = len(getattr(data, 'sequences', data))
    return -(-rows // model._batch_size)


def bloom_sequences():
    """Phase 7's sequences, seeded."""
    return np.random.RandomState(42).randint(
        1, BLOOM_ITEMS, (SEQ_ROWS, SEQ_LENGTH)).astype(np.int32)


def training_state(model):
    """A copy of a model's parameters and Adam moments, on the CPU: the
    sequence lazy engine's hybrid state gives its table's moments under
    the item table's name beside the tower's."""
    def copied(tensors):
        return {name: t.detach().to('cpu', copy=True)
                for name, t in tensors}
    state = model._opt_state
    if 'table' in state:
        state = {key: dict(state['tower'][key], **{
            'item_embeddings.weight': state['table'][key]})
            for key in ('mu', 'nu')}
    return {'params': copied(model._net.named_parameters()),
            'mu': copied(state['mu'].items()),
            'nu': copied(state['nu'].items())}


def block_gaps(torch, model, reference):
    """A rank's blocks of tables and moments against one device's: the
    share of its values equal bit for bit, and the largest gap over the
    largest |value| of that table or moment of the one-device run, by
    (kind, parameter)."""
    from spotlight_tpu_torch.parallel.sharding import held_part

    state = training_state(model)
    gaps = {}
    for kind in ('params', 'mu', 'nu'):
        for name, got in state[kind].items():
            whole = reference[kind][name]
            want = held_part(model._net, name, whole).contiguous()
            same = bits(torch, got) == bits(torch, want)
            scale = float(whole.abs().max()) or 1.0
            gaps[kind, name] = (float(same.float().mean()),
                                float((got.float() - want.float()).abs()
                                      .max()) / scale)
    return gaps


def sequence_factors_ms(torch, model, whole, rows):
    """Median ms of 3 warm ``_rank_factors_sequences`` calls on ``rows``
    (one metric batch): on the mesh, where the sequences' item rows come
    through the exchange, and on ``whole``, the tables gathered from the
    ranks, where they are a plain gather.  Every rank calls alike."""
    prefix = rows.astype(np.int64)
    times = {}
    for label, estimator in (('mesh', model), ('gathered', whole)):
        estimator._rank_factors_sequences(prefix)
        laps = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            estimator._rank_factors_sequences(prefix)
            torch.cuda.synchronize()
            laps.append((time.perf_counter() - start) * 1e3)
        times[label] = statistics.median(laps)
    return times


def mesh_train_rank(rank, world, store, out_dir):
    """One rank of phase 16's gloo mesh on the card (started by
    ``torch.multiprocessing.spawn``; an exception here fails the phase):
    each run of ``mesh_train_runs`` on each layout, trained and scored on
    the mesh with the launch counters, ``MATERIALIZE_ROUTES`` and the
    collective byte counter zeroed just before and read just after; then
    its blocks against the one-device run and its metrics against one
    device's on the tables gathered from the ranks."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.parallel import make_mesh
    from spotlight_tpu_torch.parallel import mesh as pmesh
    from spotlight_tpu_torch.utils import serialization

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        'gloo', init_method='file://' + store, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    reference = torch.load(os.path.join(out_dir, 'one_device.pt'))
    out = {}
    for layout in MESH_LAYOUTS:
        mesh = make_mesh(*layout, devices=['cuda:0'] * world)
        for name, ref_name, build, metrics in mesh_train_runs(layout):
            model, data = build(mesh)
            torch.cuda.synchronize()
            reset_mesh_counters()
            pmesh.COLLECTIVE_BYTES = {}
            start = time.perf_counter()
            model.fit(data)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - start
            train_bytes = dict(pmesh.COLLECTIVE_BYTES)
            results = metrics(model)
            torch.cuda.synchronize()
            launches = mesh_counters()
            routes = evaluation.MATERIALIZE_ROUTES
            gaps = block_gaps(torch, model, reference[ref_name])
            whole = serialization._gathered(model)
            one = metrics(whole)
            rows = {'mixture LSTM psum': sequence_rows,
                    'bloom LSTM psum': bloom_sequences}.get(name)
            factors_ms = (None if rows is None else sequence_factors_ms(
                torch, model, whole, rows()[:SEQ_EVAL]))
            # The same steps once more, warm (the state is not checked
            # after them).
            torch.cuda.synchronize()
            start = time.perf_counter()
            model.fit(data)
            torch.cuda.synchronize()
            out[layout, name] = dict(
                reference=ref_name, steps=train_steps(model, data),
                train_s=train_s, warm_s=time.perf_counter() - start,
                factors_ms=factors_ms,
                train_bytes=train_bytes, launches=launches, routes=routes,
                gaps=gaps, device=str(model._device),
                loss=model._last_epoch_loss,
                equal={key: same_arrays(results[key], one[key])
                       for key in results})
            del model, whole
            torch.cuda.empty_cache()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, 'rank{}.pkl'.format(rank)), 'wb') as fh:
        pickle.dump(out, fh)


def run_mesh_training_ranks(torch, card):
    """(a) MESH_RANKS gloo ranks on the one card: every run of
    ``mesh_train_runs`` on both layouts from the one-device run's initial
    tables and draws; blocks bit-equal to one device's run where their bits
    agree and within MESH_TRAIN_RTOL of each table's scale elsewhere,
    metrics bit-equal to one device's on the gathered tables, no call on
    the materialize route, the path's kernels launched.  Returns the
    ranks' summed launch counts."""
    import pickle
    import shutil

    out_dir = os.path.join(ROOT, 'build', 'mesh_train_smoke')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    reference, one_ms, one_warm_ms = {}, {}, {}
    for name, ref_name, build, _ in mesh_train_runs(None):
        model, data = build(None)
        model._initialize(data)
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.fit(data)
        torch.cuda.synchronize()
        one_ms[ref_name] = ((time.perf_counter() - start) * 1e3
                            / train_steps(model, data))
        reference[ref_name] = training_state(model)
        start = time.perf_counter()
        model.fit(data)
        torch.cuda.synchronize()
        one_warm_ms[ref_name] = ((time.perf_counter() - start) * 1e3
                                 / train_steps(model, data))
        del model
    torch.save(reference, os.path.join(out_dir, 'one_device.pt'))
    del reference
    torch.cuda.empty_cache()
    start = time.perf_counter()
    torch.multiprocessing.spawn(
        mesh_train_rank, args=(MESH_RANKS, os.path.join(out_dir, 'store'),
                               out_dir), nprocs=MESH_RANKS, join=True)
    spawn_s = time.perf_counter() - start
    ranks = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(out_dir, 'rank{}.pkl'.format(rank)),
                  'rb') as fh:
            ranks.append(pickle.load(fh))
    launches, worst = {}, 0.0
    for key in ranks[0]:
        layout, name = key
        runs = [out[key] for out in ranks]
        for rank, got in enumerate(runs):
            if got['routes']:
                raise AssertionError('{} on rank {}: {} metric calls took '
                                     'the materialize route'.format(
                                         name, rank, got['routes']))
            if got['device'] != 'cuda:0':
                raise AssertionError('rank {} ran on {}'.format(
                    rank, got['device']))
            if not all(got['equal'].values()):
                raise AssertionError('{} on rank {} of {} x {}: metrics '
                                     'differ from one device\'s on the '
                                     'gathered tables: {}'.format(
                                         name, rank, *layout, got['equal']))
            for count_name, count in got['launches'].items():
                launches[count_name] = launches.get(count_name, 0) + count
        gap = max(g[1] for got in runs for g in got['gaps'].values())
        share = min(g[0] for got in runs for g in got['gaps'].values())
        worst = max(worst, gap)
        steps = runs[0]['steps']
        by_axis = {'{} {}'.format(*op_axis): count / steps
                   for op_axis, count in runs[0]['train_bytes'].items()}
        log(mesh_training=name, layout='{} x {}'.format(*layout),
            steps=steps, last_epoch_loss=runs[0]['loss'],
            metrics_bit_equal_to_one_device=True,
            largest_gap_over_table_scale=gap,
            least_bit_equal_share=share, bound=MESH_TRAIN_RTOL,
            ms_per_step_by_rank=[got['train_s'] * 1e3 / steps
                                 for got in runs],
            one_device_ms_per_step=one_ms[runs[0]['reference']],
            warm_ms_per_step_by_rank=[got['warm_s'] * 1e3 / steps
                                      for got in runs],
            one_device_warm_ms_per_step=one_warm_ms[runs[0]['reference']],
            sequence_factors_ms_by_rank=[got['factors_ms'] for got in runs],
            collective_bytes_per_step_rank0=by_axis,
            note='four ranks share one card: not a scaling figure; the '
                 'first times are one fit of a fresh model, its first '
                 'step included, the warm ones a second fit of the same '
                 'steps', card=card)
        if gap > MESH_TRAIN_RTOL:
            raise AssertionError('{} at {} x {}: a block is {} of its '
                                 'table\'s scale from one device\'s'
                                 .format(name, *layout, gap))
    log(mesh_training_launches=launches, spawn_s=spawn_s,
        largest_gap_over_table_scale=worst)
    for name in ('rank_weights', 'matched_target_scores', 'streaming_topk',
                 'rank_weights (mixture)', 'matched_candidate_scores'):
        if launches.get(name, 0) <= 0:
            raise AssertionError('{} never launched on the mesh training '
                                 'path'.format(name))
    return launches


def check_nccl_collectives(torch, card, group):
    """The three collectives the mesh makes, called on the one-rank NCCL
    ``group`` with the card's tensors at the MF step's shapes (a step's
    flattened table gradients, its looked-up rows, their int32 ids): each
    returns its input's bits.  ``Mesh`` itself sends nothing along an axis
    of one rank, so the mesh path alone never reaches NCCL here."""
    import torch.distributed as dist

    generator = torch.Generator(device=DEVICE).manual_seed(3)
    rows = 3 * MESH_TRAIN_BATCH
    tensors = {
        'all_reduce': torch.randn((NUM_USERS + NUM_ITEMS) * (D + 1),
                                  device=DEVICE, generator=generator),
        'all_gather': torch.randn(rows, D + 1, device=DEVICE,
                                  generator=generator),
        'all_to_all_single': torch.randint(
            0, NUM_ITEMS, (rows,), dtype=torch.int32, device=DEVICE,
            generator=generator)}
    got = {}
    total = tensors['all_reduce'].clone()
    dist.all_reduce(total, group=group)
    got['all_reduce'] = total
    parts = [torch.empty_like(tensors['all_gather'])]
    dist.all_gather(parts, tensors['all_gather'], group=group)
    got['all_gather'] = parts[0]
    out = torch.empty_like(tensors['all_to_all_single'])
    dist.all_to_all_single(out, tensors['all_to_all_single'], group=group)
    got['all_to_all_single'] = out
    torch.cuda.synchronize()
    checks = {name: same_bits(torch, got[name], tensor)
              for name, tensor in tensors.items()}
    log(nccl_one_rank_collectives=checks,
        bytes={name: t.numel() * t.element_size()
               for name, t in tensors.items()}, card=card)
    if not all(checks.values()):
        raise AssertionError('NCCL collectives on one rank: {}'.format(
            checks))


def run_nccl_training(torch, card):
    """(b) A one-rank NCCL group: NCCL_TRAIN_STEPS steps of phase 4's MF
    under each exchange, its tables and moments bit-equal to one device's
    steps (every axis has one rank, so the mesh sends nothing), then the
    three collectives on the group itself (``check_nccl_collectives``)."""
    import datetime

    import torch.distributed as dist

    from spotlight_tpu_torch.data import Interactions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.parallel import make_mesh

    _, train, _, _ = slice_data()
    pairs = NCCL_TRAIN_STEPS * MESH_TRAIN_BATCH
    data = Interactions(train.user_ids[:pairs], train.item_ids[:pairs],
                        num_users=NUM_USERS, num_items=NUM_ITEMS)

    def fit(mesh, exchange='psum'):
        model = ImplicitFactorizationModel(
            loss='bpr', embedding_dim=D, n_iter=1,
            batch_size=MESH_TRAIN_BATCH, mesh=mesh, exchange=exchange,
            random_state=np.random.RandomState(42))
        model._initialize(data)
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.fit(data)
        torch.cuda.synchronize()
        return model, (time.perf_counter() - start) * 1e3 / NCCL_TRAIN_STEPS

    want, one_ms = fit(None)
    want = training_state(want)
    store = os.path.join(ROOT, 'build', 'mesh_train_smoke', 'nccl_store')
    dist.init_process_group(
        'nccl', init_method='file://' + store, world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_mesh(data=1, model=1, devices=['cuda:0'])
        for exchange in MESH_EXCHANGES:
            model, ms = fit(mesh, exchange)
            got = training_state(model)
            equal = all(same_bits(torch, got[kind][name], value)
                        for kind in got for name, value in want[kind].items())
            log(nccl_one_rank_training=exchange, steps=NCCL_TRAIN_STEPS,
                tables_and_moments_bit_equal=equal, ms_per_step=ms,
                one_device_ms_per_step=one_ms, card=card)
            if not equal:
                raise AssertionError('NCCL {} steps differ from one '
                                     'device\'s'.format(exchange))
            del model
        check_nccl_collectives(torch, card, mesh.groups[('data', 'model')])
    finally:
        dist.destroy_process_group()


def run_mesh_training_phase(torch, card):
    """Phase 16: returns the launch counts of the mesh training path."""
    launches = run_mesh_training_ranks(torch, card)
    run_nccl_training(torch, card)
    launches['mixture_score'] = sum(
        launches.get(name, 0) for name in sequence_counters())
    return launches


# -- phase 17: the lazy engines on a mesh ------------------------------------

#: Phase 17: phase 9's lazy MF at ``bench_lazy_knobs``' width (2e6 x 5e5,
#: D=64, batch 8,192), MESH_LAZY_STEPS steps under each exchange and
#: layout, bfloat16 tables with in-batch negatives at 1 x 4; phase 11's
#: explicit width at 2 x 2; phase 13's lazy LSTM at LAZY_SEQ_ITEMS[0]
#: (batch 256, T=50) for MESH_LAZY_SEQ_STEPS steps.  The MF metrics score
#: MESH_LAZY_EVAL users, the LSTM's MESH_LAZY_SEQ_EVAL sequences.
MESH_LAZY_STEPS = 4
MESH_LAZY_SEQ_STEPS = 2
MESH_LAZY_EVAL = 2_048
MESH_LAZY_SEQ_EVAL = 512
#: The step of rank 0's 'MF psum' run at 2 x 2 whose item-table P1
#: operands are captured.
MESH_CAPTURE_STEP = 4


def mesh_lazy_runs(layout):
    """The runs of phase 17 on a layout (None: one device), each ``(name,
    reference name, build(mesh) -> (model, data), metrics(model) ->
    {name: numpy})``: the lazy MF under each exchange, its bfloat16
    in-batch form under 'psum' at 1 x 4, the lazy explicit MF under 'psum'
    and 'alltoall_cf' at 2 x 2, the lazy LSTM under 'psum' (and
    'alltoall' at 2 x 2)."""
    import torch

    from spotlight_tpu_torch.data import Interactions, SequenceInteractions
    from spotlight_tpu_torch.evaluation import (
        mrr_score, precision_recall_score, sequence_mrr_score)
    from spotlight_tpu_torch.factorization import (
        BilinearNet, ExplicitFactorizationModel, ImplicitFactorizationModel)
    from spotlight_tpu_torch.sequence import ImplicitSequenceModel

    pairs = MESH_LAZY_STEPS * TRAIN_BATCH
    full = fit_interactions(LAZY_USERS, LAZY_ITEMS)
    mf_data = Interactions(full.user_ids[:pairs], full.item_ids[:pairs],
                           num_users=LAZY_USERS, num_items=LAZY_ITEMS)
    rs = np.random.RandomState(9)
    test = Interactions(
        np.repeat(rs.randint(0, LAZY_USERS, MESH_LAZY_EVAL), TEST_PER_USER),
        rs.randint(0, LAZY_ITEMS, MESH_LAZY_EVAL * TEST_PER_USER),
        num_users=LAZY_USERS, num_items=LAZY_ITEMS)
    ratings = explicit_interactions()
    explicit_data = Interactions(
        ratings.user_ids[:pairs], ratings.item_ids[:pairs],
        ratings=ratings.ratings[:pairs], num_users=DENSE_USERS,
        num_items=DENSE_ITEMS)
    sequences = lazy_sequence_data(LAZY_SEQ_ITEMS[0]).sequences
    seq_data = SequenceInteractions(
        sequences[:MESH_LAZY_SEQ_STEPS * SEQ_TRAIN_BATCH],
        num_items=LAZY_SEQ_ITEMS[0])
    seq_test = SequenceInteractions(sequences[-MESH_LAZY_SEQ_EVAL:],
                                    num_items=LAZY_SEQ_ITEMS[0])

    def mf(exchange, bf16_inbatch=False):
        def build(mesh):
            kwargs = {}
            if bf16_inbatch:
                kwargs = dict(negative_sampling='in_batch',
                              representation=BilinearNet(
                                  LAZY_USERS, LAZY_ITEMS, TRAIN_DIM,
                                  table_dtype=torch.bfloat16,
                                  generator=torch.Generator().manual_seed(
                                      42)))
            return ImplicitFactorizationModel(
                loss='bpr', embedding_dim=TRAIN_DIM, n_iter=1,
                batch_size=TRAIN_BATCH, learning_rate=1e-2, sparse=True,
                mesh=mesh, exchange=exchange,
                random_state=np.random.RandomState(42), **kwargs), mf_data
        return build

    def explicit(exchange):
        def build(mesh):
            return ExplicitFactorizationModel(
                loss='regression', embedding_dim=TRAIN_DIM, n_iter=1,
                batch_size=TRAIN_BATCH, sparse=True, mesh=mesh,
                exchange=exchange,
                random_state=np.random.RandomState(42)), explicit_data
        return build

    def lstm(exchange):
        def build(mesh):
            return ImplicitSequenceModel(
                loss='bpr', representation='lstm', embedding_dim=D,
                batch_size=SEQ_TRAIN_BATCH, n_iter=1, sparse=True, mesh=mesh,
                exchange=exchange,
                random_state=np.random.RandomState(42)), seq_data
        return build

    def mf_metrics(model):
        return {'mrr_score (train)': mrr_score(model, test, train=mf_data),
                'precision_recall_score k=10': precision_recall_score(
                    model, test, k=10)}

    def no_metrics(model):
        return {}

    def lstm_metrics(model):
        return {'sequence_mrr_score': sequence_mrr_score(model, seq_test)}

    if layout is None:
        return [('MF', 'MF', mf('psum'), mf_metrics),
                ('MF bf16 in-batch', 'MF bf16 in-batch', mf('psum', True),
                 mf_metrics),
                ('explicit', 'explicit', explicit('psum'), no_metrics),
                ('LSTM', 'LSTM', lstm('psum'), lstm_metrics)]
    runs = [('MF ' + exchange, 'MF', mf(exchange), mf_metrics)
            for exchange in MESH_EXCHANGES]
    if layout == (1, 4):
        runs.append(('MF bf16 in-batch psum', 'MF bf16 in-batch',
                     mf('psum', True), mf_metrics))
        runs.append(('LSTM psum', 'LSTM', lstm('psum'), lstm_metrics))
    else:
        runs += [('explicit ' + exchange, 'explicit', explicit(exchange),
                  no_metrics) for exchange in ('psum', 'alltoall_cf')]
        runs += [('LSTM ' + exchange, 'LSTM', lstm(exchange), lstm_metrics)
                 for exchange in ('psum', 'alltoall')]
    return runs


def gathered_tables(model):
    """A one-device copy of a mesh-trained model that holds the whole padded
    tables, gathered over the model axis (every rank calls alike), and no
    optimizer state: what its metrics are held against."""
    import copy

    import torch

    from spotlight_tpu_torch.parallel.sharding import gather_params

    net = copy.deepcopy(model._net)
    whole = gather_params({name: p.detach() for name, p in
                           model._net.named_parameters()},
                          model._param_specs, model._mesh)
    with torch.no_grad():
        for name, param in net.named_parameters():
            param.data = whole[name]
    gathered = object.__new__(type(model))
    gathered.__dict__.update(model.__dict__)
    gathered._net = net
    gathered._opt_state = None
    gathered._mesh = gathered._param_specs = gathered._opt_specs = None
    gathered._item_factor_cache = gathered._shard_catalog_cache = None
    gathered._epoch_fn_cache = {}
    return gathered


def mesh_lazy_rank(rank, world, store, out_dir):
    """One rank of phase 17's gloo mesh on the card (started by
    ``torch.multiprocessing.spawn``; an exception here fails the phase):
    each run of ``mesh_lazy_runs`` on each layout, trained and scored on
    the mesh with the launch counters (P1's too), ``MATERIALIZE_ROUTES``
    and the collective byte counter zeroed just before and read just
    after; then its blocks against the one-device run, its metrics against
    one device's on the tables gathered from the ranks, and a second (warm)
    fit of the same steps.  Rank 0 saves P1's operands of the item table at
    step MESH_CAPTURE_STEP of 'MF psum' at 2 x 2.  Phase 18 runs here on the
    2 x 2 models of CHECKPOINT_RUNS (``checkpoint_run``) and on the N=1,001
    model (``checkpoint_edge``), its results in ``checkpoint<rank>.pkl``."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.ops.kernels import row_update
    from spotlight_tpu_torch.parallel import make_mesh
    from spotlight_tpu_torch.parallel import mesh as pmesh
    from spotlight_tpu_torch.parallel import training as ptraining

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        'gloo', init_method='file://' + store, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    reference = torch.load(os.path.join(out_dir, 'one_device.pt'),
                           mmap=True)
    out, checkpoints = {}, {}
    meshes = {layout: make_mesh(*layout, devices=['cuda:0'] * world)
              for layout in MESH_LAYOUTS}
    for layout in MESH_LAYOUTS:
        mesh = meshes[layout]
        for name, ref_name, build, metrics in mesh_lazy_runs(layout):
            model, data = build(mesh)
            # The tables drawn whole on the CPU and cut into blocks, before
            # the clock starts (as for the one-device run).
            model._initialize(data)
            undo = None
            if rank == 0 and layout == (2, 2) and name == 'MF psum':
                captured, undo = capture_row_updates(MESH_CAPTURE_STEP,
                                                     engine=ptraining)
            torch.cuda.synchronize()
            reset_mesh_counters()
            row_update.ROW_ADAM_LAUNCHES = 0
            pmesh.COLLECTIVE_BYTES = {}
            start = time.perf_counter()
            try:
                model.fit(data)
                torch.cuda.synchronize()
            finally:
                if undo is not None:
                    undo()
            train_s = time.perf_counter() - start
            train_bytes = dict(pmesh.COLLECTIVE_BYTES)
            results = metrics(model)
            torch.cuda.synchronize()
            launches = dict(mesh_counters(), **{
                'row_adam (P1, mesh)': row_update.ROW_ADAM_LAUNCHES})
            routes = evaluation.MATERIALIZE_ROUTES
            if undo is not None:
                torch.save({key: value.cpu() if torch.is_tensor(value)
                            else value for key, value in captured[1].items()},
                           os.path.join(out_dir, 'mesh_p1.pt'))
            gaps = block_gaps(torch, model, reference[ref_name])
            one = {}
            if results:
                whole = gathered_tables(model)
                one = metrics(whole)
                del whole
            torch.cuda.synchronize()
            start = time.perf_counter()
            model.fit(data)
            torch.cuda.synchronize()
            out[layout, name] = dict(
                reference=ref_name, steps=train_steps(model, data),
                lazy=model._lazy, train_s=train_s,
                warm_s=time.perf_counter() - start, train_bytes=train_bytes,
                launches=launches, routes=routes, gaps=gaps,
                device=str(model._device), loss=model._last_epoch_loss,
                equal={key: same_arrays(results[key], one[key])
                       for key in results})
            if layout == (2, 2) and name in CHECKPOINT_RUNS:
                # Phase 18 on this trained model.
                checkpoints[name] = checkpoint_run(
                    torch, name, model, data, metrics, build, meshes,
                    out_dir)
            del model
            torch.cuda.empty_cache()
    checkpoints['edge'] = checkpoint_edge(torch, meshes, out_dir)
    dist.destroy_process_group()
    with open(os.path.join(out_dir, 'rank{}.pkl'.format(rank)), 'wb') as fh:
        pickle.dump(out, fh)
    with open(os.path.join(out_dir, 'checkpoint{}.pkl'.format(rank)),
              'wb') as fh:
        pickle.dump(checkpoints, fh)


def run_mesh_lazy_ranks(torch, card):
    """(a) MESH_RANKS gloo ranks on the one card: every run of
    ``mesh_lazy_runs`` on both layouts from the one-device run's initial
    tables and draws.  Every rank took the lazy engine; its blocks bit-equal
    to one device's run where their bits agree and within MESH_TRAIN_RTOL
    of each table's scale elsewhere; metrics bit-equal to one device's on
    the gathered tables; no materialize route; the path's kernels
    launched, P1 on every step.  Returns the ranks' summed launch counts
    and the directory of the captured P1 operands."""
    import pickle
    import shutil

    out_dir = os.path.join(ROOT, 'build', 'mesh_lazy_smoke')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    reference, one_ms, one_warm_ms = {}, {}, {}
    for name, ref_name, build, _ in mesh_lazy_runs(None):
        model, data = build(None)
        model._initialize(data)
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.fit(data)
        torch.cuda.synchronize()
        steps = train_steps(model, data)
        one_ms[ref_name] = (time.perf_counter() - start) * 1e3 / steps
        if not model._lazy:
            raise AssertionError('one device\'s {} did not take the lazy '
                                 'engine'.format(name))
        reference[ref_name] = training_state(model)
        start = time.perf_counter()
        model.fit(data)
        torch.cuda.synchronize()
        one_warm_ms[ref_name] = (time.perf_counter() - start) * 1e3 / steps
        del model
        torch.cuda.empty_cache()
    torch.save(reference, os.path.join(out_dir, 'one_device.pt'))
    del reference
    start = time.perf_counter()
    torch.multiprocessing.spawn(
        mesh_lazy_rank, args=(MESH_RANKS, os.path.join(out_dir, 'store'),
                              out_dir), nprocs=MESH_RANKS, join=True)
    spawn_s = time.perf_counter() - start
    ranks = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(out_dir, 'rank{}.pkl'.format(rank)),
                  'rb') as fh:
            ranks.append(pickle.load(fh))
    launches, worst = {}, 0.0
    for key in ranks[0]:
        layout, name = key
        runs = [out[key] for out in ranks]
        for rank, got in enumerate(runs):
            if not got['lazy'] or got['device'] != 'cuda:0':
                raise AssertionError('{} on rank {}: lazy {}, on {}'.format(
                    name, rank, got['lazy'], got['device']))
            if got['routes']:
                raise AssertionError('{} on rank {}: {} metric calls took '
                                     'the materialize route'.format(
                                         name, rank, got['routes']))
            if not all(got['equal'].values()):
                raise AssertionError('{} on rank {} of {} x {}: metrics '
                                     'differ from one device\'s on the '
                                     'gathered tables: {}'.format(
                                         name, rank, *layout, got['equal']))
            steps = got['steps']
            calls = (1 if name.startswith('LSTM') else 2) * steps
            if got['launches']['row_adam (P1, mesh)'] != calls:
                raise AssertionError('{} on rank {}: P1 launched {} times, '
                                     'not {}'.format(
                                         name, rank, got['launches'][
                                             'row_adam (P1, mesh)'], calls))
            for count_name, count in got['launches'].items():
                launches[count_name] = launches.get(count_name, 0) + count
        gap = max(g[1] for got in runs for g in got['gaps'].values())
        share = min(g[0] for got in runs for g in got['gaps'].values())
        worst = max(worst, gap)
        steps = runs[0]['steps']
        by_axis = {'{} {}'.format(*op_axis): count / steps
                   for op_axis, count in runs[0]['train_bytes'].items()}
        log(mesh_lazy_training=name, layout='{} x {}'.format(*layout),
            steps=steps, last_epoch_loss=runs[0]['loss'],
            metrics_bit_equal_to_one_device=True,
            largest_gap_over_table_scale=gap,
            least_bit_equal_share=share, bound=MESH_TRAIN_RTOL,
            ms_per_step_by_rank=[got['train_s'] * 1e3 / steps
                                 for got in runs],
            one_device_ms_per_step=one_ms[runs[0]['reference']],
            warm_ms_per_step_by_rank=[got['warm_s'] * 1e3 / steps
                                      for got in runs],
            one_device_warm_ms_per_step=one_warm_ms[runs[0]['reference']],
            collective_bytes_per_step_rank0=by_axis,
            note='four ranks share one card: not a scaling figure; the '
                 'first times are one fit of a fresh model, its first '
                 'step included, the warm ones a second fit of the same '
                 'steps', card=card)
        if gap > MESH_TRAIN_RTOL:
            raise AssertionError('{} at {} x {}: a block is {} of its '
                                 'table\'s scale from one device\'s'
                                 .format(name, *layout, gap))
    log(mesh_lazy_launches=launches, spawn_s=spawn_s,
        largest_gap_over_table_scale=worst)
    for name in ('rank_weights', 'matched_target_scores', 'streaming_topk'):
        if launches.get(name, 0) <= 0:
            raise AssertionError('{} never launched on the lazy mesh path'
                                 .format(name))
    return launches, out_dir


def mesh_p1_device_work(path, kernel_only):
    """Run in a fresh process, one profiler session a process (a session
    after another in one process can drop events): the device ms and
    activities of one ``sparse_adam_rows`` call on the captured mesh
    operands at ``path`` (its sort and P1), or with ``kernel_only`` of P1
    alone on their sort, over DEVICE_REPS calls."""
    import torch

    sys.path.insert(0, ROOT)
    from spotlight_tpu_torch.ops.kernels import row_update
    from spotlight_tpu_torch.ops.lazy_adam import sparse_adam_rows

    operands = torch.load(path)
    ids = operands['ids'].to(DEVICE)
    grads = operands['grads'].to(DEVICE).reshape(ids.numel(), -1)
    tables = [operands[name].to(DEVICE) for name in ('param', 'mu', 'nu')]
    t, lr, l2 = operands['t'], operands['lr'], operands['l2']
    if not kernel_only:
        return device_work(torch, lambda: sparse_adam_rows(
            ids, *tables, grads, t, lr, l2))
    pair = row_update.sort_occurrences(ids)
    scalars = row_update.adam_scalars(t, lr, l2)
    return device_work(torch, lambda: row_update.row_adam(
        *tables, grads, *pair, scalars))


def check_mesh_p1(torch, card, out_dir):
    """P1 on rank 0's captured item-table operands of 'MF psum' at 2 x 2:
    the global stream of the step's item occurrences (positives, then
    negatives; the ids rank 0 does not own at the sentinel, its block's
    row count), their gradient rows, its block of the table and moments.
    Bit for bit against its plain version, timed as phase 9's rows (with
    its sort, alone, the sort, the plain version, ``SparseAdam`` on the
    owned rows), and its device ms by ``torch.profiler`` in a fresh
    process.  The bound counts what this call needs: every id read, the
    owned occurrences' gradient rows, the owned distinct rows.  Returns the
    kernel-table entry."""
    import multiprocessing

    from spotlight_tpu_torch.ops.kernels import row_update

    path = os.path.join(out_dir, 'mesh_p1.pt')
    operands = torch.load(path)
    ids = operands['ids'].to(DEVICE)
    grads = operands['grads'].to(DEVICE).reshape(ids.numel(), -1).float()
    param, mu, nu = (operands[name].to(DEVICE)
                     for name in ('param', 'mu', 'nu'))
    rows = param.shape[0]
    owned = ids < rows
    n_owned = int(owned.sum())
    distinct = int(torch.unique(ids[owned]).numel())
    shape = ('mesh item block R={} W={} n={} ({} owned, {} rows), rank 0 of '
             '2 x 2 psum, f32, step={} t={} l2={}').format(
        rows, param.shape[1], ids.numel(), n_owned, distinct,
        MESH_CAPTURE_STEP, operands['t'], operands['l2'])
    entry = check_row_update(
        torch, card, shape, param, mu, nu, ids, grads, operands['t'],
        operands['lr'], operands['l2'], library=operands['l2'] == 0,
        name='row_adam (P1, mesh)')
    width = param.shape[1]
    bound_ms, bound_by = bound(
        row_update_ops(distinct, n_owned, width),
        distinct * width * 2 * (param.element_size() + 8)
        + 4 * n_owned * width + ids.numel() * ids.element_size())
    with multiprocessing.get_context('spawn').Pool(
            1, maxtasksperchild=1) as pool:
        call, alone = (pool.apply(mesh_p1_device_work, (path, kernel_only))
                       for kernel_only in (False, True))
    entry = dict(entry, bound_ms=bound_ms, bound_by=bound_by,
                 owned_occurrences=n_owned, distinct_rows=distinct,
                 device_ms=call[0], device_activities=call[1],
                 kernel_only_device_ms=alone[0])
    log(mesh_p1=entry, note='the bound counts the owned rows and '
        'occurrences; device ms by torch.profiler', card=card)
    if abs(alone[1] - 1) > 1e-9:
        raise AssertionError('row_adam alone made {} device activities a '
                             'call, not 1'.format(alone[1]))
    return entry


def run_nccl_lazy_training(torch, card):
    """(b) A one-rank NCCL group: NCCL_TRAIN_STEPS steps of the lazy MF at
    phase 9's width under 'psum', its tables and moments bit-equal to one
    device's steps (every axis has one rank: the mesh sends nothing).
    Returns its P1 launches."""
    import datetime

    import torch.distributed as dist

    from spotlight_tpu_torch.data import Interactions
    from spotlight_tpu_torch.factorization import ImplicitFactorizationModel
    from spotlight_tpu_torch.ops.kernels import row_update
    from spotlight_tpu_torch.parallel import make_mesh

    pairs = NCCL_TRAIN_STEPS * TRAIN_BATCH
    full = fit_interactions(LAZY_USERS, LAZY_ITEMS)
    data = Interactions(full.user_ids[:pairs], full.item_ids[:pairs],
                        num_users=LAZY_USERS, num_items=LAZY_ITEMS)

    def fit(mesh):
        model = ImplicitFactorizationModel(
            loss='bpr', embedding_dim=TRAIN_DIM, n_iter=1,
            batch_size=TRAIN_BATCH, learning_rate=1e-2, sparse=True,
            mesh=mesh, random_state=np.random.RandomState(42))
        model._initialize(data)
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.fit(data)
        torch.cuda.synchronize()
        return model, (time.perf_counter() - start) * 1e3 / NCCL_TRAIN_STEPS

    want, one_ms = fit(None)
    want = training_state(want)
    torch.cuda.empty_cache()
    store = os.path.join(ROOT, 'build', 'mesh_lazy_smoke', 'nccl_store')
    dist.init_process_group(
        'nccl', init_method='file://' + store, world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        mesh = make_mesh(data=1, model=1, devices=['cuda:0'])
        row_update.ROW_ADAM_LAUNCHES = 0
        model, ms = fit(mesh)
        launches = row_update.ROW_ADAM_LAUNCHES
        got = training_state(model)
        equal = model._lazy and all(
            torch.equal(bits(torch, got[kind][name]), bits(torch, value))
            for kind in got for name, value in want[kind].items())
        log(nccl_one_rank_lazy_training='psum', steps=NCCL_TRAIN_STEPS,
            lazy=model._lazy, tables_and_moments_bit_equal=equal,
            row_adam_launches=launches, ms_per_step=ms,
            one_device_ms_per_step=one_ms, card=card)
        if not equal or launches != 2 * NCCL_TRAIN_STEPS:
            raise AssertionError('NCCL lazy steps differ from one device\'s '
                                 '({} P1 launches)'.format(launches))
        del model
    finally:
        dist.destroy_process_group()
    del want, got
    torch.cuda.empty_cache()
    return launches


def run_mesh_lazy_phase(torch, card):
    """Phase 17: returns (the launch counts of the lazy mesh path, P1's
    kernel-table entry on the mesh operands)."""
    launches, out_dir = run_mesh_lazy_ranks(torch, card)
    launches['row_adam (P1, mesh)'] += run_nccl_lazy_training(torch, card)
    entry = check_mesh_p1(torch, card, out_dir)
    torch.cuda.empty_cache()
    return launches, entry


# -- phase 18: sharded checkpoints across layouts ------------------------------

#: The runs of phase 17 at 2 x 2 whose trained models phase 18 saves.
CHECKPOINT_RUNS = ('MF psum', 'LSTM psum')


def checkpoint_dir():
    return os.path.join(ROOT, 'build', 'mesh_lazy_smoke', 'checkpoint')


def reset_checkpoint_counters():
    from spotlight_tpu_torch.ops.kernels import row_update

    reset_mesh_counters()
    row_update.ROW_ADAM_LAUNCHES = 0


def checkpoint_counters():
    """Phase 18's launches: the metric kernels and P1 (on a mesh, and on
    one device in this process)."""
    from spotlight_tpu_torch.ops.kernels import row_update

    return dict(mesh_counters(),
                **{'row_adam (P1, mesh)': row_update.ROW_ADAM_LAUNCHES})


def same_state(torch, a, b):
    """Whether two models' parameters and moments (blocks) are equal bit
    for bit, and their step counts equal."""
    got, want = training_state(a), training_state(b)
    return a._opt_state['t'] == b._opt_state['t'] and all(
        torch.equal(bits(torch, got[kind][name]), bits(torch, value))
        for kind in want for name, value in want[kind].items())


def quarter_digests(model):
    """md5 of each quarter of the rows of every row-sharded table and
    moment that this rank holds (the quarters of the whole padded table:
    a rank's block at 1 x 4, two of them at 2 x 2), by (kind, name,
    quarter)."""
    import hashlib

    mesh = model._mesh
    per_block = 4 // mesh.shape['model']
    digests = {}
    for kind, tensors in training_state(model).items():
        for name, block in tensors.items():
            if 'model' not in model._param_specs[name]:
                continue
            rows = block.shape[0] // per_block
            for j in range(per_block):
                part = block[j * rows:(j + 1) * rows].contiguous()
                digests[kind, name, mesh.model_index * per_block + j] = (
                    hashlib.md5(part.numpy().tobytes()).hexdigest())
    return digests


def whole_state(model):
    """The model's parameters and moments, each table gathered whole over
    the model axis (every rank calls alike), on the CPU."""
    from spotlight_tpu_torch.parallel.sharding import gather_params

    return {kind: gather_params(tensors, model._param_specs, model._mesh)
            for kind, tensors in training_state(model).items()}


def state_gaps(torch, got, want):
    """(the least share of values equal bit for bit, the largest gap over
    each leaf's largest magnitude) of two whole states."""
    share, gap = 1.0, 0.0
    for kind in want:
        for name, value in want[kind].items():
            other = got[kind][name]
            share = min(share, float((bits(torch, other) == bits(
                torch, value)).float().mean()))
            scale = float(value.abs().max()) or 1.0
            gap = max(gap, float((other.float() - value.float()).abs()
                                 .max()) / scale)
    return share, gap


def timed_restore(torch, path, model):
    from spotlight_tpu_torch.parallel import checkpoint

    torch.cuda.synchronize()
    start = time.perf_counter()
    checkpoint.restore_state(path, model)
    torch.cuda.synchronize()
    return time.perf_counter() - start


def checkpoint_run(torch, name, model, data, metrics, build, meshes,
                   out_dir):
    """Phase 18 in a rank of phase 17, on a model trained at 2 x 2 (the
    lazy MF, or the lazy LSTM's hybrid state): its metrics at the save (MF),
    ``save_state`` (seconds, the mesh's collective bytes before and after),
    one more fit (the continuation), then fresh models restored and fitted
    as far: at 2 x 2 (MF: tables, moments and ``t`` bit for bit the
    continuation's) and at 1 x 4 (MF: the md5 of every quarter of every
    table and moment, against the continuation's; the LSTM: the whole
    tables' gap over their scale).  The launch counters are zeroed at the
    start and read at the end."""
    from spotlight_tpu_torch.parallel import checkpoint
    from spotlight_tpu_torch.parallel import mesh as pmesh

    began = time.perf_counter()
    path = os.path.join(checkpoint_dir(), name.replace(' ', '_'))
    lstm = name.startswith('LSTM')
    torch.cuda.synchronize()
    reset_checkpoint_counters()
    out = {'t': model._opt_state['t'], 'steps': train_steps(model, data)}
    if not lstm:
        out['metrics'] = metrics(model)
    torch.cuda.synchronize()
    before = dict(pmesh.COLLECTIVE_BYTES)
    start = time.perf_counter()
    checkpoint.save_state(path, model)
    out['save_s'] = time.perf_counter() - start
    out['collective_bytes'] = (before, dict(pmesh.COLLECTIVE_BYTES))
    model.fit(data)
    layouts = ((1, 4),) if lstm else ((2, 2), (1, 4))
    for layout in layouts:
        fresh, _ = build(meshes[layout])
        fresh._initialize(data)
        restore_s = timed_restore(torch, path, fresh)
        fresh.fit(data)
        torch.cuda.synchronize()
        result = {'restore_s': restore_s, 't': fresh._opt_state['t'],
                  'lazy': fresh._lazy}
        if layout == (2, 2):
            result['equal'] = same_state(torch, fresh, model)
        elif lstm:
            result['gaps'] = state_gaps(torch, whole_state(fresh),
                                        whole_state(model))
        else:
            result['digests'] = quarter_digests(fresh)
            out['digests'] = quarter_digests(model)
        out[layout] = result
        del fresh
        torch.cuda.empty_cache()
    out['launches'] = checkpoint_counters()
    out['seconds'] = time.perf_counter() - began
    return out


def edge_inputs():
    """Phase 15's N=1,001 catalogue: (train, test, metrics(model))."""
    from spotlight_tpu_torch.evaluation import (mrr_score,
                                                precision_recall_score)

    _, train, test, _ = slice_data(EDGE_USERS, EDGE_ITEMS, EDGE_EVAL_USERS,
                                   EDGE_TRAIN_PAIRS, seed=8)

    def metrics(model):
        return {'mrr_score (train)': mrr_score(model, test, train=train),
                'precision_recall_score k=10': precision_recall_score(
                    model, test, k=10)}

    return train, test, metrics


def checkpoint_edge(torch, meshes, out_dir):
    """Phase 18's cross-layout padding in a rank: phase 15's N=1,001 dense
    MF fitted one epoch at 2 x 2 (1,002 item rows) and saved, restored at
    1 x 4 (1,004 rows: the restored padding rows must be zero, tables and
    moments) and saved there; the metrics of both."""
    from spotlight_tpu_torch.parallel import checkpoint

    began = time.perf_counter()
    train, _, metrics = edge_inputs()
    reset_checkpoint_counters()
    model, _ = slice_model(train, meshes[(2, 2)], seed=1)
    model._n_iter = 1
    model.fit(train)
    out = {'2x2': metrics(model)}
    checkpoint.save_state(os.path.join(checkpoint_dir(), 'edge_2x2'), model)
    wide, _ = slice_model(train, meshes[(1, 4)], seed=2)
    checkpoint.restore_state(os.path.join(checkpoint_dir(), 'edge_2x2'),
                             wide)
    out['1x4'] = metrics(wide)
    state = training_state(wide)
    rows = wide._net.item_embeddings.weight.shape[0]
    pad = max(0, (wide._mesh.model_index + 1) * rows - EDGE_ITEMS)
    out['padding_rows'] = pad
    out['padding_zero'] = all(
        not state[kind]['item_embeddings.weight'][rows - pad:].any()
        for kind in state)
    checkpoint.save_state(os.path.join(checkpoint_dir(), 'edge_1x4'), wide)
    out['launches'] = checkpoint_counters()
    out['seconds'] = time.perf_counter() - began
    return out


def directory_bytes(path):
    return sum(os.path.getsize(os.path.join(path, name))
               for name in os.listdir(path))


def run_checkpoint_phase(torch, card):
    """Phase 18, after phase 17's ranks: each rank's saves and restores
    held, then in this process, on the card with no mesh, the 2 x 2 lazy
    MF state and the 1 x 4 N=1,001 state restored and scored: metrics bit
    for bit the mesh models', no materialize route, K1, K1c and K2
    launched.  Deletes the checkpoints.  Returns the phase's launch
    counts."""
    import pickle
    import shutil

    from spotlight_tpu_torch import evaluation

    out_dir = os.path.join(ROOT, 'build', 'mesh_lazy_smoke')
    ranks = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(out_dir, 'checkpoint{}.pkl'.format(rank)),
                  'rb') as fh:
            ranks.append(pickle.load(fh))
    launches = {}
    for out in ranks:
        for part in out.values():
            for name, count in part['launches'].items():
                launches[name] = launches.get(name, 0) + count

    # The lazy MF: saved at 2 x 2, restored at 2 x 2 and 1 x 4 and fitted.
    mf = [out['MF psum'] for out in ranks]
    steps = mf[0]['steps']
    for rank, got in enumerate(mf):
        before, after = got['collective_bytes']
        if before != after:
            raise AssertionError('save_state on rank {} sent {} through the '
                                 'mesh\'s collectives'.format(
                                     rank, (before, after)))
        if not got[2, 2]['equal'] or got[2, 2]['t'] != got['t'] + steps:
            raise AssertionError('the 2 x 2 restore of rank {} did not '
                                 'resume to the continuation\'s bits'
                                 .format(rank))
        if got['launches']['row_adam (P1, mesh)'] != 2 * steps * 3:
            raise AssertionError('rank {}: P1 launched {} times in the '
                                 'three fits'.format(
                                     rank, got['launches']))
    continued = {}
    for got in mf:
        for key, digest in got['digests'].items():
            if continued.setdefault(key, digest) != digest:
                raise AssertionError('data replicas differ at {}'.format(
                    key))
    resumed = {key: digest for got in mf
               for key, digest in got[1, 4]['digests'].items()}
    if resumed != continued or len(resumed) != 3 * 2 * 4:
        raise AssertionError('the 1 x 4 restore did not resume to the '
                             '2 x 2 continuation\'s bits: {} of {} quarters '
                             'equal'.format(
                                 sum(resumed.get(k) == v
                                     for k, v in continued.items()),
                                 len(continued)))
    saved_bytes = directory_bytes(os.path.join(checkpoint_dir(), 'MF_psum'))

    # On one device, in this process.
    _, _, build, metrics = mesh_lazy_runs(None)[0]
    one, data = build(None)
    one._initialize(data)
    restore_s = timed_restore(torch, os.path.join(checkpoint_dir(),
                                                  'MF_psum'), one)
    torch.cuda.synchronize()
    reset_checkpoint_counters()
    start = time.perf_counter()
    results = metrics(one)
    torch.cuda.synchronize()
    metrics_s = time.perf_counter() - start
    one_launches = checkpoint_counters()
    routes = evaluation.MATERIALIZE_ROUTES
    for name, count in one_launches.items():
        launches[name] = launches.get(name, 0) + count
    equal = {key: all(same_arrays(got['metrics'][key], value)
                      for got in mf)
             for key, value in results.items()}
    log(checkpoint='lazy MF (2e6 x 5e5, D=64) saved at 2 x 2',
        save_s_by_rank=[got['save_s'] for got in mf],
        bytes_on_disk=saved_bytes,
        state_bytes=(LAZY_USERS + LAZY_ITEMS) * (TRAIN_DIM + 1) * 4 * 3,
        collective_bytes_during_save=0,
        restore_2x2_s_by_rank=[got[2, 2]['restore_s'] for got in mf],
        resumed_2x2_bit_equal=True,
        restore_1x4_s_by_rank=[got[1, 4]['restore_s'] for got in mf],
        resumed_1x4_quarters_md5_equal=len(resumed),
        one_device_restore_s=restore_s, one_device_t=one._opt_state['t'],
        saved_t=mf[0]['t'], one_device_metrics_s=metrics_s,
        one_device_metrics_bit_equal=equal, routes=routes,
        one_device_launches=one_launches, card=card)
    if one._opt_state['t'] != mf[0]['t'] or not all(equal.values()):
        raise AssertionError('the one-device restore differs from the mesh '
                             'model: t {} against {}, metrics {}'.format(
                                 one._opt_state['t'], mf[0]['t'], equal))
    if routes:
        raise AssertionError('{} metric calls of the restored model took '
                             'the materialize route'.format(routes))
    for name in ('rank_weights', 'matched_target_scores', 'streaming_topk'):
        if one_launches[name] <= 0:
            raise AssertionError('{} never launched on the restored model'
                                 .format(name))
    del one
    torch.cuda.empty_cache()

    # The lazy LSTM's hybrid state, 2 x 2 -> 1 x 4.
    lstm = [out['LSTM psum'] for out in ranks]
    share, gap = lstm[0][1, 4]['gaps']
    log(checkpoint='lazy LSTM (1e6 items) hybrid state, 2 x 2 -> 1 x 4',
        save_s_by_rank=[got['save_s'] for got in lstm],
        bytes_on_disk=directory_bytes(os.path.join(checkpoint_dir(),
                                                   'LSTM_psum')),
        restore_1x4_s_by_rank=[got[1, 4]['restore_s'] for got in lstm],
        largest_gap_over_table_scale=gap, least_bit_equal_share=share,
        bound=MESH_TRAIN_RTOL, card=card)
    if gap > MESH_TRAIN_RTOL or any(
            got[1, 4]['t'] != got['t'] + got['steps'] for got in lstm):
        raise AssertionError('the LSTM resumed at 1 x 4 is {} of its '
                             'scale from the 2 x 2 continuation'.format(gap))

    # Cross-layout padding: N=1,001 at 2 x 2 (1,002 rows) -> 1 x 4 (1,004)
    # -> one device (1,001).
    edge = [out['edge'] for out in ranks]
    train, _, edge_metrics = edge_inputs()
    one, _ = slice_model(train, seed=3)
    restore_s = timed_restore(torch, os.path.join(checkpoint_dir(),
                                                  'edge_1x4'), one)
    reset_checkpoint_counters()
    results = edge_metrics(one)
    edge_launches = checkpoint_counters()
    for name, count in edge_launches.items():
        launches[name] = launches.get(name, 0) + count
    equal = all(same_arrays(got[layout][key], value)
                for got in edge for layout in ('2x2', '1x4')
                for key, value in results.items())
    padding = [got['padding_rows'] for got in edge]
    log(checkpoint='N=1,001 dense MF, 2 x 2 -> 1 x 4 -> one device',
        padding_rows_by_rank_at_1x4=padding,
        padding_rows_zero=all(got['padding_zero'] for got in edge),
        one_device_rows=one._net.item_embeddings.weight.shape[0],
        one_device_restore_s=restore_s, metrics_bit_equal=equal,
        routes=evaluation.MATERIALIZE_ROUTES, card=card)
    if (not equal or padding != [0, 0, 0, 3]
            or not all(got['padding_zero'] for got in edge)
            or evaluation.MATERIALIZE_ROUTES):
        raise AssertionError('the N=1,001 state across layouts: metrics '
                             'equal {}, padding rows {}'.format(
                                 equal, padding))
    del one
    shutil.rmtree(checkpoint_dir())
    log(checkpoint_launches=launches,
        rank_seconds=[sum(part['seconds'] for part in out.values())
                      for out in ranks])
    return launches


# -- phase 19: the multi-host helpers and the multi-device dry run -------------

#: The batch whose data slices phase 19's ranks assemble.
MULTIHOST_BATCH = np.arange(32, dtype=np.float32).reshape(16, 2)


def free_address():
    import socket

    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return 'tcp://localhost:{}'.format(sock.getsockname()[1])


def multihost_rank(rank, world, address, out_dir):
    """One rank of phase 19 (started by ``torch.multiprocessing.spawn``):
    joins through ``multihost.initialize`` (TCP, gloo, on the one card),
    ``is_primary``, ``global_batch_array`` of its data slice at 2 x 2, then
    ``dryrun_multichip`` with the launch counters zeroed just before and
    read just after."""
    import pickle

    import torch
    import torch.distributed as dist

    from spotlight_tpu_torch import evaluation
    from spotlight_tpu_torch.entry import dryrun_multichip
    from spotlight_tpu_torch.parallel import make_mesh, multihost

    torch.cuda.set_device(0)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    out = {'primary before': multihost.is_primary()}
    multihost.initialize(address, world, rank, backend='gloo')
    out['primary'] = multihost.is_primary()
    mesh = make_mesh(2, 2, devices=['cuda:0'] * world)
    rows = len(MULTIHOST_BATCH) // mesh.shape['data']
    local = MULTIHOST_BATCH[mesh.data_index * rows:
                            (mesh.data_index + 1) * rows]
    out['global batch'] = multihost.global_batch_array(
        mesh, local).cpu().numpy()
    torch.cuda.synchronize()
    reset_checkpoint_counters()
    start = time.perf_counter()
    dryrun_multichip(world, 'cuda:0')
    torch.cuda.synchronize()
    out['seconds'] = time.perf_counter() - start
    out['launches'] = checkpoint_counters()
    out['routes'] = evaluation.MATERIALIZE_ROUTES
    dist.destroy_process_group()
    with open(os.path.join(out_dir, 'rank{}.pkl'.format(rank)), 'wb') as fh:
        pickle.dump(out, fh)


def run_multihost_phase(torch, card):
    """Phase 19: (a) MULTIHOST ranks through ``multihost.initialize`` run
    ``dryrun_multichip(4)``; ``is_primary`` true on rank 0 alone;
    ``global_batch_array`` the concatenation of the ranks' slices.  (b) A
    one-rank NCCL group, joined through ``multihost.initialize`` in this
    process, runs ``dryrun_multichip(1)``.  Returns the launch counts."""
    import pickle
    import shutil

    import torch.distributed as dist

    from spotlight_tpu_torch.entry import dryrun_multichip
    from spotlight_tpu_torch.parallel import multihost

    out_dir = os.path.join(ROOT, 'build', 'multihost_smoke')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    start = time.perf_counter()
    torch.multiprocessing.spawn(
        multihost_rank, args=(MESH_RANKS, free_address(), out_dir),
        nprocs=MESH_RANKS, join=True)
    spawn_s = time.perf_counter() - start
    ranks = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(out_dir, 'rank{}.pkl'.format(rank)),
                  'rb') as fh:
            ranks.append(pickle.load(fh))
    launches = {}
    for out in ranks:
        for name, count in out['launches'].items():
            launches[name] = launches.get(name, 0) + count
    primary = [out['primary'] for out in ranks]
    batch_equal = all(np.array_equal(out['global batch'], MULTIHOST_BATCH)
                      for out in ranks)
    log(multihost='four gloo ranks on the card, tcp', is_primary=primary,
        is_primary_without_group=[out['primary before'] for out in ranks],
        global_batch_equal=batch_equal,
        dryrun_s_by_rank=[out['seconds'] for out in ranks], spawn_s=spawn_s,
        routes=[out['routes'] for out in ranks], launches=launches,
        card=card)
    if (primary != [True, False, False, False] or not batch_equal
            or any(out['routes'] for out in ranks)
            or not all(out['primary before'] for out in ranks)):
        raise AssertionError('multihost ranks: primary {}, global batch '
                             'equal {}'.format(primary, batch_equal))

    multihost.initialize(free_address(), 1, 0, backend='nccl')
    try:
        primary = multihost.is_primary()
        torch.cuda.synchronize()
        reset_checkpoint_counters()
        start = time.perf_counter()
        dryrun_multichip(1)
        torch.cuda.synchronize()
        nccl_s = time.perf_counter() - start
        nccl_launches = checkpoint_counters()
    finally:
        dist.destroy_process_group()
    for name, count in nccl_launches.items():
        launches[name] = launches.get(name, 0) + count
    log(multihost='one NCCL rank', is_primary=primary, dryrun_s=nccl_s,
        launches=nccl_launches, card=card)
    if not primary:
        raise AssertionError('the one NCCL rank is not primary')
    for name in ('rank_weights', 'matched_target_scores', 'streaming_topk',
                 'row_adam (P1, mesh)'):
        if launches.get(name, 0) <= 0:
            raise AssertionError('{} never launched in the dry runs'.format(
                name))
    shutil.rmtree(out_dir)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device is available')
    sys.path.insert(0, ROOT)
    from spotlight_tpu_torch.evaluation import sequence_mrr_score
    from spotlight_tpu_torch.ops.kernels import _build

    card = card_line()
    print(card, flush=True)

    began = start = time.perf_counter()
    built = _build.build()
    log(phase='build', seconds=time.perf_counter() - start, built=built)
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix('.log')
        if report.exists():
            lines = report.read_text().splitlines()
            log(ptxas=name, report=[
                line.strip() for line in lines
                if 'Used' in line or 'spill' in line
                or 'Compiling entry' in line],
                kernels=sum('Compiling entry' in line for line in lines),
                spilling=sum('spill' in line and ' 0 bytes spill stores'
                             not in line for line in lines))

    generator = torch.Generator(device='cuda')
    generator.manual_seed(0)
    entries = check_rank_kernels(torch, card, generator)
    check_ragged_rank_pass(torch, card, generator)
    entries['streaming_topk'] = check_topk_kernel(torch, card, generator)
    check_mixture_kernels(torch, card, generator)
    entries['layer_norm'] = check_layer_norm(torch, card, generator)

    captured = {}
    launches, model, test, train, heavy = run_slice(torch, card, captured)
    profile_metrics(torch, card, model, test, train, heavy)
    del model, heavy
    torch.cuda.empty_cache()
    check_routes(torch, card, test, train)
    del test, train

    seq_launches, seq_model, seq_test = run_sequence_slice(torch, card,
                                                           captured)
    launches.update(seq_launches)
    entries.update(check_sequence_kernels(torch, card, seq_model, seq_test))
    # K3 runs inside K1, K2 and K4 with mixture scoring.
    launches['mixture_score'] = sum(seq_launches.values())
    check_duplicated_row_tie(torch, card, seq_model, seq_test)
    profile_call(torch, card, 'sequence_mrr_score',
                 lambda: sequence_mrr_score(seq_model, seq_test))
    torch.cuda.empty_cache()
    for name, count in run_sasrec_slice(torch, card).items():
        launches[name] = launches.get(name, 0) + count

    bloom_launches, bloom_model_, bloom_test, bloom_mrr = run_bloom_slice(
        torch, card, captured)
    for name, count in bloom_launches.items():
        launches[name] += count
    entries.update(check_matched_kernels(torch, card, captured))
    del captured
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

    start = time.perf_counter()
    explicit_launches, captured = run_explicit_training(torch, card)
    launches['row_adam (P1, explicit)'] = explicit_launches
    entries['row_adam (P1, explicit)'] = dict(
        check_explicit_operands(torch, card, captured),
        name='row_adam (P1, explicit)')
    del captured
    run_explicit_gates(torch, card)
    log(phase='explicit', seconds=time.perf_counter() - start)

    start = time.perf_counter()
    run_sequence_training(torch, card, ('lstm', 'mixture'))
    log(phase='sequence training', seconds=time.perf_counter() - start)
    start = time.perf_counter()
    for name, count in run_trained_serving(torch, card,
                                           ('lstm', 'mixture')).items():
        launches[name] += count
    run_inbatch_epoch(torch, card)
    log(phase='trained serving', seconds=time.perf_counter() - start)
    start = time.perf_counter()
    run_bloom_training(torch, card)
    run_sequence_gates(torch, card)
    log(phase='bloom steps and sequence gates',
        seconds=time.perf_counter() - start)

    start = time.perf_counter()
    run_sequence_training(torch, card, ('pooling', 'cnn'))
    for name, count in run_trained_serving(torch, card,
                                           ('pooling', 'cnn')).items():
        launches[name] += count
    p1_launches, captured = run_sequence_lazy_engine(torch, card)
    launches['row_adam (P1, sequence)'] = p1_launches
    entries['row_adam (P1, sequence)'] = check_sequence_engine_operands(
        torch, card, captured)
    del captured
    check_sequence_step_against_cpu(torch, card)
    lazy_pooling, dense_cnn, gate_train, gate_test = run_pool_cnn_gates(
        torch, card)
    check_serialization(torch, card, (lazy_pooling, dense_cnn), gate_train,
                        gate_test)
    log(phase='pooling, cnn, sequence lazy engine, serialization',
        seconds=time.perf_counter() - start)

    start = time.perf_counter()
    for name, count in run_ml1m_sweep(torch, card).items():
        launches[name] += count
    log(phase='ML-1M sweep', seconds=time.perf_counter() - start)

    start = time.perf_counter()
    for name, count in run_mesh_phase(torch, card).items():
        launches[name] += count
    log(phase='sharded evaluation', seconds=time.perf_counter() - start)

    start = time.perf_counter()
    for name, count in run_mesh_training_phase(torch, card).items():
        launches[name] += count
    log(phase='mesh training', seconds=time.perf_counter() - start)

    start = time.perf_counter()
    mesh_launches, entries['row_adam (P1, mesh)'] = run_mesh_lazy_phase(
        torch, card)
    for name, count in mesh_launches.items():
        launches[name] = launches.get(name, 0) + count
    log(phase='lazy mesh training', seconds=time.perf_counter() - start)

    start = time.perf_counter()
    for name, count in run_checkpoint_phase(torch, card).items():
        launches[name] = launches.get(name, 0) + count
    log(phase='checkpoints', seconds=time.perf_counter() - start,
        note='after the ranks of phase 17, which ran its saves and '
             'restores (checkpoint_launches line: rank_seconds)')

    start = time.perf_counter()
    for name, count in run_multihost_phase(torch, card).items():
        launches[name] = launches.get(name, 0) + count
    log(phase='multihost and dry run', seconds=time.perf_counter() - start)

    kernels = []
    for name in ('rank_weights', 'matched_target_scores', 'streaming_topk',
                 'rank_weights (mixture)', 'streaming_topk (mixture)',
                 'mixture_score', 'matched_candidate_scores', 'rank_counts',
                 'rank_counts (mixture)', 'bloom_gather_sum',
                 'bloom_gather_sum backward', 'multihot_gather_sum',
                 'multihot_gather_sum backward', 'row_adam (P1)',
                 'row_adam (P1, explicit)', 'row_adam (P1, sequence)',
                 'row_adam (P1, mesh)', 'layer_norm'):
        entry = dict(entries[name])
        entry['launches'] = launches[name]
        kernels.append(entry)
    log(phase='all', seconds=time.perf_counter() - began)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
