// Streaming rank weights (K1, dot and mixture scoring), streaming rank
// counts (K5, dot and mixture scoring), matched target scores (K1c) and
// matched candidate scores (K4).
//
// Replaces: spotlight_tpu/ops/kernels/ranking.py, _rank_weight_kernel (the
// Pallas kernel behind rank_weights, with the default dot score_fn and with
// make_mixture_score_fn), _rank_count_kernel (the Pallas kernel behind
// rank_counts), the MXU arithmetic of matched_target_scores, and
// _tile_scores_kernel (the Pallas kernel behind matched_candidate_scores).
//
// What it computes: for every user b and target t,
//     half_units[b, t] = 2 * count(score > ts[b, t]) + count(score == ts[b, t])
// over the whole catalogue, the target itself included (its exact self-tie
// adds 1 half unit), where score is item . user + item_bias in the
// contract's order (dot_tile_accumulate, then the bias) or is a
// mixture of such dots (M tastes, M attentions) through mixture_combine
// (common.cuh).  The wrapper returns half_units * 0.5.
//
// K5 is the same kernel with COUNTS = true: two exact int32 counters per
// (user, target), greater[b, t] = count(score > ts) and equal[b, t] =
// count(score == ts), over the catalogue rows whose id differs from the
// target's id tids[b, t].  The target is excluded by id, not by score, so
// the target scores may come from any arithmetic; an id outside [0, N)
// matches no row (per-shard callers pass shifted ids on purpose).  Rows at
// or past N never count.
//
// What bounds it on an H100: arithmetic.  At B = 2048 users, N = 200K items,
// D = 64 the dot catalogue pass is 2 * B * N * D = 5.2e10 float32 operations
// against a 51 MB read of the item table, about 1,000 operations per byte;
// mixture scoring with M = 4 does 2M = 8 such dots per pair (4.2e11
// operations, a floor of 12.5 ms) plus M expf.  The exact-tie contract forbids the tensor cores
// (TF32 rounds the operands) and FMA contraction, so every multiply and
// every add is its own instruction on the float32 CUDA cores: the floor is
// 2 * B * N * D instructions at ~33.5e12 a second (132 SMs x 128 lanes x
// ~1.98 GHz), half the data sheet's FMA rate.
//
// One kernel, rank_kernel, serves both scorings: the register-tiled
// catalogue pass of common.cuh (RankShape, stage_users, SlabStage), which
// K2's stage 1 (topk.cu) runs with a filter and this kernel with counting.
// One block of 512 threads an SM keeps its users resident in shared memory
// (transposed, rows 16-byte aligned) and walks its contiguous split of the
// catalogue in 128-item tiles, 32 dimensions a slab.  The slabs are
// double-buffered through registers: the next slab's global loads are
// issued before this slab is scored and stored (transposed, bf16 upcast)
// after it, one barrier a slab, no index division.  The scoring policy
// (RankShape) is the only difference between the two:
// - dot scoring keeps 64 users a block; each thread scores 4 items x 4
//   users with dot_tile_accumulate (two float4 shared loads feed 16
//   products), then adds the bias: the contract's order, so the scores
//   tie K1c's bit for bit;
// - mixture scoring keeps 16 users a block, each as 2M adjacent columns
//   of the staged users (tastes, then attentions; M rounded up to 2, 4 or
//   8, so the columns come in float4s), so one dot_tile_accumulate call
//   gives a thread all 2M dots of its 4 items x 1 user (at M = 4, three
//   float4 shared loads feed 32 products), and mixture_combine turns each
//   pair's dots into its score in registers: K4's bits.  Where a wider D
//   does not fit, the launch takes fewer targets, never another kernel.
// Rows at or past N score NaN, which no comparison counts.  Counting:
// - narrow (T <= 4): the thread compares its own scores against the T
//   target scores of its users, held in registers; at the split's end
//   the 32 threads sharing a user add their counts (two warp shuffles,
//   then shared-memory integer atomics) and one atomicAdd a (user, target)
//   goes to global memory;
// - wide (T <= 128 a launch with dot scoring, 32 with mixtures; the
//   wrapper chunks wider T): comparing every score with every target costs
//   T integer-pipe instructions or more a score, so the block sorts each
//   user's targets once into shared memory, the tile's scores go to shared
//   memory, and each thread binary-searches some of them a tile for one
//   user: a score that beats p targets and
//   reaches q adds to the user's bins p and q (shared-memory integer
//   atomics), and target j's counts are, at the split's end, the sums of
//   the bins above its rank.
// Counts are greater (s > ts) and greater-or-equal (s >= ts): K1's half
// units are their sum, one int a pair; K5 keeps them in the two halves of
// one int (at most 65,535 rows a thread or a bin in a split, which the
// launcher's split size guarantees).  K5 excludes the target's row after
// the fact: the block whose split holds row tids[b, t] scores that row once
// more in the same order and takes its comparisons back out.
//
// Counts are int32 half units: exact and independent of order, so the
// splits add their counts with atomicAdd in any order.  The TPU kernel's
// grid ran in sequence and accumulated in VMEM; here the splits run in
// parallel.
//
// K1c and K4 are one kernel, matched_kernel<Item, Id, MP> (MP = 0: dots),
// which scores only the B * T given pairs (the JAX K4 scored every gathered
// row against every user of the batch and kept the diagonal).  What bounds
// it: bytes, each pair's item row (256 bytes at D = 64 in float32) and each
// user's row once, about 2 MB at B = 2048, T = 4 and 29 MB for K4 at
// B = 2048, M = 4, T = 49; the arithmetic is one dot a pair (2M with
// mixtures).  So the design is about the reads and about filling the card:
// - one launch a call: the kernel reads the ids in their own type (int32 or
//   int64) and clamps each into [0, N) itself, so the wrapper issues no
//   clamp and no cast;
// - user-major blocks: a block takes a group of users with their targets
//   (a user's targets in chunks where T is wide, its row staged again for
//   each chunk), stages each user's row once in shared memory, and gathers
//   its pairs' item rows with coalesced 16-byte loads (a row a half-warp at
//   D = 64) into rows of 65 floats, so the thread that owns a dot reads its
//   row in d order without bank conflicts; D is walked in slabs of 64, so
//   shared memory does not grow with D and every width the rank pass takes
//   is taken here;
// - the grid: the wrapper sizes a block's users from B, T and the SM count,
//   about one wave of blocks (the rank pass's rule), not a fixed block;
// - arithmetic: one dot a thread, in the contract's order from -0.0 (the
//   catalogue pass's bits), then the bias; with mixtures a pair's 2M dots
//   are 2M lanes of one warp (eight times the threads of one pair a thread
//   at M = 4, T = 1), brought to the pair's first lane by warp shuffles,
//   which are exact, and combined by mixture_combine, the function the
//   catalogue pass calls: K4's scores equal the tile's by construction.
#include "common.cuh"

using namespace spotlight;

namespace {

// ---- the rank pass (K1 and K5, dot and mixture scoring) -------------------

// Targets a narrow launch holds in registers; target slots of the widest
// wide launch, with dot and with mixture scoring.
constexpr int kNarrowTargets = 4;
constexpr int kWideTargets = 128;
constexpr int kWideMixtureTargets = 32;
// Targets a narrow launch of MP components a user holds: at MP = 8 a
// thread's 64 dot accumulators leave room for one (four spill).
template <int MP>
__host__ __device__ constexpr int narrow_targets() {
  return MP == kMaxMixtures ? 1 : kNarrowTargets;
}
// Shared memory one H100 block may use.
constexpr size_t kMaxSharedBytes = 232448;

// Shared memory of a rank launch: the resident users and two item slabs,
// then the narrow path's per-block counts or the wide path's score tile,
// sorted targets and count bins (TP target slots, TP = 0 for narrow).
// 232,448 bytes a block allow dot scoring D <= 768 narrow and D <= 383 at
// TP = 128; mixtures D <= 774, 387 and 193 at MP = 2, 4 and 8.
template <int MP>
size_t rank_smem_bytes(int D, int TP) {
  using S = RankShape<MP>;
  const size_t extra =
      TP == 0 ? 2 * S::kUsers * kNarrowTargets
              : S::kItems * S::kScoreStride + (2 * (size_t)TP + 1) * S::kUsers;
  return sizeof(float) * ((size_t)D * S::kUserStride + 2 * S::kSlab + extra);
}

// The score of one (user, row) pair in the catalogue pass's order: each of
// the user's columns dotted with the row from -0.0, one product added at a
// time (dot_tile_accumulate's order), then the bias or the mixture
// combine; the same bits as the catalogue pass's score of that pair.  user
// points at the user's first column among the staged users.
template <int MP, typename Item>
__device__ __forceinline__ float row_score(const float* user, const Item* row,
                                           float bias, int D, int mixtures) {
  using S = RankShape<MP>;
  float dots[S::kCols];
#pragma unroll
  for (int k = 0; k < S::kCols; ++k) dots[k] = -0.0f;
  for (int d = 0; d < D; ++d) {
    const float v = to_f32(row[d]);
#pragma unroll
    for (int k = 0; k < S::kCols; ++k)
      dots[k] = __fadd_rn(dots[k],
                          __fmul_rn(user[d * S::kUserStride + k], v));
  }
  if constexpr (MP == 0)
    return __fadd_rn(dots[0], bias);
  else
    return mixture_combine<MP>(dots, mixtures, bias);
}

// Counts score s against target score ts: greater (s > ts) plus
// greater-or-equal (s >= ts) times GE.  K1 takes GE = 1, their sum being
// its half units; K5 takes GE = 2^16, greater in the low half and
// greater-or-equal in the high half.  A NaN on either side counts nothing.
template <int GE>
__device__ __forceinline__ int compare(float s, float ts) {
  return (s > ts ? 1 : 0) + (s >= ts ? GE : 0);
}

// How many of the TP sorted target scores sorted[k * stride] (NaN last)
// lie below s: a branchless binary search.
template <int TP>
__device__ __forceinline__ int count_below(const float* sorted, int stride,
                                           float s) {
  int p = 0;
#pragma unroll
  for (int half = TP / 2; half >= 1; half /= 2)
    p += sorted[(p + half - 1) * stride] < s ? half : 0;
  return p + (sorted[p * stride] < s ? 1 : 0);
}

// Order of target scores for the sort: NaN last, -0.0 tied with +0.0.
__device__ __forceinline__ uint32_t sort_key(float v) {
  if (v != v) return 0xffffffffu;
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// K1 (COUNTS = false: half units to out_a; tids and out_b unused) or K5
// (COUNTS = true: greater counts to out_a, equal counts to out_b, the row
// whose id is tids[b, t] left out), with dot scoring (MP = 0) or mixtures
// of mixtures <= MP components.
// - Narrow (WIDE = false): T <= TP <= kNarrowTargets; each thread holds TP
//   target scores of each of its kUPT users in registers and compares its
//   own scores against them.
// - Wide: T <= TP, a power of two; the block sorts each user's targets
//   into shared memory once, then each thread takes one user and some items
//   of the tile's shared scores and finds, by binary search, how many
//   targets each score beats (p) or reaches (q); bins p and q of the user
//   count it, and at the end target j's count is the sum of the bins above
//   its rank j, so a score costs log2(TP) + 2 shared loads, not T compares.
template <typename Item, int MP, int TP, bool WIDE, bool COUNTS>
__global__ void __launch_bounds__(RankShape<MP>::kThreads, 1)
rank_kernel(const float* __restrict__ users, const Item* __restrict__ items,
            const float* __restrict__ bias, const float* __restrict__ tscores,
            const int* __restrict__ tids, int* __restrict__ out_a,
            int* __restrict__ out_b, int B, int N, int D, int T,
            int mixtures, int tiles_per_split) {
  using S = RankShape<MP>;
  constexpr int U = S::kUsers;
  constexpr int RI = S::kRI;
  constexpr int RU = S::kRU;
  constexpr int UPT = S::kUPT;
  constexpr int US = S::kUserStride;
  constexpr int TI = S::kItems;
  constexpr int kIS = S::kItemStride;
  constexpr int kSS = S::kScoreStride;
  constexpr int kT = S::kThreads;
  constexpr int kUserWarps = S::kUserWarps;
  constexpr int kSlab = S::kSlab;
  constexpr int kRows = kT / U;            // wide: threads a user
  constexpr int kHeld = WIDE ? 1 : UPT * TP;  // narrow: targets in registers
  constexpr int GE = COUNTS ? 1 << 16 : 1;
  static_assert((TI / RI) * (U / UPT) == kT, "one tile a block");
  static_assert(WIDE ? (TP & (TP - 1)) == 0 && TP <= kWideTargets
                     : TP <= narrow_targets<MP>(), "target slots");

  extern __shared__ __align__(16) float rank_smem[];
  float* su = rank_smem;                    // [D][US] resident users
  float* si = su + D * US;                  // [2][kSlabDepth][kIS]
  float* ss = si + 2 * kSlab;               // wide: [TI][kSS]
  float* st = ss + TI * kSS;                // wide: [TP][U] sorted targets
  int* bins = reinterpret_cast<int*>(st + TP * U);  // wide: [TP + 1][U]
  int* red = reinterpret_cast<int*>(ss);    // narrow: [2][U][TP] counts

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * U;
  // Column k of user u, dimension d, at su[d * US + u * kCols + k].
  stage_users<S>(su, users, b0, B, D, mixtures);

  // Scoring ownership: items 4 ig + r, user slot ug (users kUPT ug + c); a
  // warp covers 4 item groups x 8 user slots, so its float4 reads of a
  // dimension touch 64 contiguous bytes of items and 8 slots of users, and
  // the 4 lanes that differ in lane & 3 share users.
  const int ug = (warp % kUserWarps) * 8 + (lane >> 2);
  const int ig = (warp / kUserWarps) * 4 + (lane & 3);
  // Wide ownership: user cu, items trow + kRows k of a tile.
  const int cu = tid % U;
  const int trow = tid / U;

  const float nan = __int_as_float(0x7fffffff);
  float ts[kHeld];
  int count[kHeld];
  if constexpr (WIDE) {
    // Sort each user's targets (ranks by key, then index), NaN in the
    // empty slots; the bins' room holds the keys meanwhile.
    uint32_t* keys = reinterpret_cast<uint32_t*>(bins);  // [TP][U]
    for (int e = tid; e < TP * U; e += kT) {
      const int u = e % U, t = e / U;
      const int b = b0 + u;
      keys[e] = sort_key(b < B && t < T ? tscores[(long long)b * T + t]
                                        : nan);
    }
    __syncthreads();
    for (int e = tid; e < TP * U; e += kT) {
      const int u = e % U, t = e / U;
      const uint32_t key = keys[e];
      int rank = 0;
      for (int k = 0; k < TP; ++k) {
        const uint32_t other = keys[k * U + u];
        rank += other < key || (other == key && k < t) ? 1 : 0;
      }
      const int b = b0 + u;
      st[rank * U + u] = b < B && t < T ? tscores[(long long)b * T + t]
                                        : nan;
    }
    __syncthreads();
    for (int e = tid; e < (TP + 1) * U; e += kT) bins[e] = 0;
  } else {
    for (int e = tid; e < 2 * U * TP; e += kT) red[e] = 0;
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int b = b0 + UPT * ug + h / TP;
      const int t = h % TP;
      ts[h] = b < B && t < T ? tscores[(long long)b * T + t] : nan;
      count[h] = 0;
    }
  }

  const int num_tiles = (N + TI - 1) / TI;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(num_tiles, tile_begin + tiles_per_split);
  const int slabs = (D + kSlabDepth - 1) / kSlabDepth;

  SlabStage<Item, S> stage;
  stage.load(items, tile_begin, 0, N, D);
  stage.store(si);
  __syncthreads();

  float acc[RI][RU];
  float item_bias[RI];
  int tile = tile_begin, slab = 0, buf = 0;
  for (;;) {
    int next_tile = tile, next_slab = slab + 1;
    if (next_slab == slabs) {
      next_slab = 0;
      ++next_tile;
    }
    const bool more = next_tile < tile_end;
    if (more) stage.load(items, next_tile, next_slab, N, D);

    const int row0 = tile * TI;
    if (slab == 0) {
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int id = row0 + 4 * ig + r;
        item_bias[r] = id < N ? bias[id] : 0.0f;
#pragma unroll
        for (int c = 0; c < RU; ++c) acc[r][c] = -0.0f;
      }
    }
    const int d0 = slab * kSlabDepth;
    const float* slab_items = si + buf * kSlab + 4 * ig;
    const float* slab_users = su + d0 * US + RU * ug;
    if (D - d0 >= kSlabDepth)  // a full slab: a constant trip count
      dot_tile_accumulate<RI, RU>(acc, kSlabDepth, slab_items, kIS, 0,
                                  slab_users, US, 4);
    else
      dot_tile_accumulate<RI, RU>(acc, D - d0, slab_items, kIS, 0,
                                  slab_users, US, 4);

    const bool last = slab == slabs - 1;
    if (last) {
      // Rows at or past N score NaN, which no comparison counts.
      float s[RI][UPT];
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const bool live = row0 + 4 * ig + r < N;
        if constexpr (MP == 0) {
#pragma unroll
          for (int c = 0; c < UPT; ++c)
            s[r][c] = live ? __fadd_rn(acc[r][c], item_bias[r]) : nan;
        } else {
          s[r][0] = live ? mixture_combine<MP>(acc[r], mixtures, item_bias[r])
                         : nan;
        }
      }
      if constexpr (WIDE) {
        // With one slab a tile, no barrier yet separates the last tile's
        // searches from this tile's scores.
        if (slabs == 1) __syncthreads();
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          float* row = ss + (4 * ig + r) * kSS + UPT * ug;
          if constexpr (UPT == 4) {
            *reinterpret_cast<float4*>(row) =
                make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
          } else {
#pragma unroll
            for (int c = 0; c < UPT; ++c) row[c] = s[r][c];
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < UPT; ++c)
#pragma unroll
          for (int t = 0; t < TP; ++t)
#pragma unroll
            for (int r = 0; r < RI; ++r)
              count[c * TP + t] += compare<GE>(s[r][c], ts[c * TP + t]);
      }
    }
    if (more) stage.store(si + (buf ^ 1) * kSlab);
    __syncthreads();
    if constexpr (WIDE) {
      if (last) {
        const float* sorted = st + cu;
#pragma unroll 2
        for (int k = 0; k < TI / kRows; ++k) {
          const float s = ss[(trow + kRows * k) * kSS + cu];
          const int p = count_below<TP>(sorted, U, s);
          int q = p;
          while (q < TP && sorted[q * U] <= s) ++q;
          // Bin 0 counts for no target.
          if (p == q) {
            if (p != 0) atomicAdd(&bins[p * U + cu], 1 + GE);
          } else {
            if (p != 0) atomicAdd(&bins[p * U + cu], 1);
            atomicAdd(&bins[q * U + cu], GE);
          }
        }
      }
    }
    if (!more) break;
    tile = next_tile;
    slab = next_slab;
    buf ^= 1;
  }

  // The split's counts of (user u, target t), added to global memory; K5
  // first takes out the comparisons of row tids[b, t] if it lies in this
  // split (an id outside the split, or outside [0, N), excludes nothing
  // here).
  const int row_begin = tile_begin * TI;
  const int row_end = min(N, tile_end * TI);
  // a: K1's half units or K5's greater count; ge: K5's greater-or-equal
  // count.
  auto finish = [&](int u, int t, int a, int ge) {
    const int b = b0 + u;
    if (b >= B || t >= T) return;
    const long long bt = (long long)b * T + t;
    if constexpr (COUNTS) {
      int e = ge - a;
      const int id = tids[bt];
      if (id >= row_begin && id < row_end) {
        const float s = row_score<MP>(su + u * S::kCols,
                                      items + (long long)id * D, bias[id],
                                      D, mixtures);
        const float target = tscores[bt];
        a -= s > target ? 1 : 0;
        e -= s == target ? 1 : 0;
      }
      if (e != 0) atomicAdd(&out_b[bt], e);
    }
    if (a != 0) atomicAdd(&out_a[bt], a);
  };

  if constexpr (WIDE) {
    __syncthreads();
    // Bin j of user u becomes the sum of its bins above j: the packed
    // count of the target of rank j (K5's halves stay below 2^16 each).
    for (int u = tid; u < U; u += kT) {
      int run = 0;
      int bin = bins[TP * U + u];
      for (int j = TP; j >= 1; --j) {
        run += bin;
        bin = bins[(j - 1) * U + u];
        bins[(j - 1) * U + u] = run;
      }
    }
    __syncthreads();
    // Equal targets share their counts, so a target reads them at the
    // first slot of its score; a NaN target counts nothing.
    for (int e = tid; e < U * T; e += kT) {
      const int u = e % U, t = e / U;
      if (b0 + u >= B) continue;
      const float v = tscores[(long long)(b0 + u) * T + t];
      const int packed =
          v != v ? 0 : bins[count_below<TP>(st + u, U, v) * U + u];
      if constexpr (COUNTS)
        finish(u, t, packed & 0xffff, (int)((unsigned)packed >> 16));
      else
        finish(u, t, packed, 0);
    }
  } else {
    int* red_a = red;
    int* red_b = red + U * TP;
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      // Unpacked before the sum: a block's count may pass 2^16.
      int a = count[h], e = 0;
      if constexpr (COUNTS) {
        a = count[h] & 0xffff;
        e = (int)((unsigned)count[h] >> 16);
      }
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, m);
        if constexpr (COUNTS) e += __shfl_xor_sync(0xffffffffu, e, m);
      }
      if ((lane & 3) == 0) {
        const int slot = (UPT * ug + h / TP) * TP + h % TP;
        atomicAdd(&red_a[slot], a);
        if constexpr (COUNTS) atomicAdd(&red_b[slot], e);
      }
    }
    __syncthreads();
    for (int slot = tid; slot < U * TP; slot += kT)
      finish(slot / TP, slot % TP, red_a[slot], red_b[slot]);
  }
}

template <typename Item, int MP, int TP, bool WIDE, bool COUNTS>
int launch_rank(const float* users, const void* items, const float* bias,
                const float* tscores, const int* tids, int* out_a,
                int* out_b, int B, int N, int D, int T, int mixtures,
                int splits, cudaStream_t stream) {
  using S = RankShape<MP>;
  const size_t smem = rank_smem_bytes<MP>(D, WIDE ? TP : 0);
  auto kernel = rank_kernel<Item, MP, TP, WIDE, COUNTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (N + S::kItems - 1) / S::kItems;
  // K5 counts in half words: a narrow thread meets S::kRI rows of each
  // tile, a wide block's bin all of them, and neither may pass 65,535 rows.
  constexpr int kMaxTiles = 65535 / (WIDE ? S::kItems : S::kRI);
  const int per_split = min(kMaxTiles, (num_tiles + splits - 1) / splits);
  const int used_splits = (num_tiles + per_split - 1) / per_split;
  dim3 grid((B + S::kUsers - 1) / S::kUsers, used_splits);
  kernel<<<grid, S::kThreads, smem, stream>>>(
      users, static_cast<const Item*>(items), bias, tscores, tids, out_a,
      out_b, B, N, D, T, mixtures, per_split);
  return cudaGetLastError();
}

// Widest target block one launch takes at width D: the widest wide launch
// whose shared memory fits, else a narrow one.
template <int MP>
int max_targets(int D) {
  if constexpr (MP != 0) {
    return rank_smem_bytes<MP>(D, kWideMixtureTargets) <= kMaxSharedBytes
               ? kWideMixtureTargets : narrow_targets<MP>();
  } else {
    int tp = kWideTargets;
    while (tp > kNarrowTargets &&
           rank_smem_bytes<MP>(D, tp) > kMaxSharedBytes)
      tp /= 2;
    return tp;
  }
}

// The narrowest instantiation that holds T targets.
template <typename Item, int MP, bool COUNTS>
int dispatch_rank(const float* users, const void* items, const float* bias,
                  const float* tscores, const int* tids, int* out_a,
                  int* out_b, int B, int N, int D, int T, int mixtures,
                  int splits, cudaStream_t stream) {
#define SPOTLIGHT_RANK(TP, WIDE)                                         \
  return launch_rank<Item, MP, TP, WIDE, COUNTS>(                        \
      users, items, bias, tscores, tids, out_a, out_b, B, N, D, T,       \
      mixtures, splits, stream)
  if (T <= 1) SPOTLIGHT_RANK(1, false);
  if constexpr (MP == 0) {
    if (T <= 2) SPOTLIGHT_RANK(2, false);
    if (T <= kNarrowTargets) SPOTLIGHT_RANK(kNarrowTargets, false);
    if (T <= 8) SPOTLIGHT_RANK(8, true);
    if (T <= 16) SPOTLIGHT_RANK(16, true);
    if (T <= 32) SPOTLIGHT_RANK(32, true);
    if (T <= 64) SPOTLIGHT_RANK(64, true);
    if (T <= kWideTargets) SPOTLIGHT_RANK(kWideTargets, true);
  } else {
    if constexpr (narrow_targets<MP>() > 1)
      if (T <= kNarrowTargets) SPOTLIGHT_RANK(kNarrowTargets, false);
    if (T <= kWideMixtureTargets) SPOTLIGHT_RANK(kWideMixtureTargets, true);
  }
  return cudaErrorInvalidValue;
#undef SPOTLIGHT_RANK
}

// K1 (COUNTS = false: tids and out_b unused) or K5.
template <typename Item, bool COUNTS>
int dispatch(const float* users, const void* items, const float* bias,
             const float* tscores, const int* tids, int* out_a, int* out_b,
             int B, int N, int D, int T, int mixtures, int splits,
             cudaStream_t stream) {
  return with_shape(mixtures, [&](auto mp) {
    return dispatch_rank<Item, decltype(mp)::value, COUNTS>(
        users, items, bias, tscores, tids, out_a, out_b, B, N, D, T,
        mixtures, splits, stream);
  });
}

// ---- matched pairs (K1c and K4, dot and mixture scoring) ------------------

// Threads a matched block holds at most; dimensions a staged slab holds, and
// its padded row (a row of 65 floats puts dimension d of row r in bank
// (r + d) % 32).
constexpr int kMatchedThreads = 256;
constexpr int kMatchedSlab = 64;
constexpr int kMatchedStride = kMatchedSlab + 1;

// Lanes a pair takes: one dot with dot scoring, one dot a column (2 MP)
// with mixtures.
template <int MP>
__host__ __device__ constexpr int matched_lanes() {
  return MP == 0 ? 1 : 2 * MP;
}

// Shared memory of a matched block of `users` users x `chunk` targets: the
// users' columns and the pairs' item rows, one slab of each, and the
// pairs' ids.
template <int MP>
size_t matched_smem_bytes(int users, int chunk) {
  const size_t pairs = (size_t)users * chunk;
  return sizeof(float) * (((size_t)users * matched_lanes<MP>() + pairs) *
                              kMatchedStride + pairs);
}

// The elements of 16 bytes of item rows, upcast to float32: 4 floats, or
// 8 bf16 (each the high half of its float32, the lower address first).
template <typename Item>
__device__ __forceinline__ void unpack_items(const uint4& raw, float* dst) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (std::is_same<Item, float>::value) {
      dst[j] = __uint_as_float(words[j]);
    } else {
      dst[2 * j] = __uint_as_float(words[j] << 16);
      dst[2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
    }
  }
}

// K1c (MP = 0) and K4 (MP = 2, 4, 8: mixtures of mixtures <= MP
// components): out[b, t] = the score of item ids[b, t], clamped into
// [0, N), for user b.  Block (x, y) takes users [x U, x U + U) and targets
// [y TC, y TC + TC) of each, U = block_users, TC = chunk; thread
// p * lanes + col owns pair p (user p / TC, target p % TC) and its column
// col, and all 256 threads stage.  Each slab of D, the block stages its
// users' columns (tastes, then attentions, zeros past M) and its pairs'
// item rows in shared memory (as 16-byte vectors where `vectors`, else an
// element a lane; consecutive lanes on consecutive elements, four loads in
// flight a thread), then each thread adds its column's products in d
// order, each rounded on its own, from -0.0 (dot_tile_accumulate's order:
// the catalogue pass's bits).  With dots the thread adds the bias; with
// mixtures the pair's first lane takes its 2 MP dots by warp shuffles
// (exact) and calls mixture_combine.
template <typename Item, typename Id, int MP>
__global__ void __launch_bounds__(kMatchedThreads)
matched_kernel(const float* __restrict__ users, const Item* __restrict__ items,
               const float* __restrict__ bias, const Id* __restrict__ ids,
               float* __restrict__ out, int B, int N, int D, int T,
               int mixtures, int block_users, int chunk, bool vectors) {
  constexpr int C = matched_lanes<MP>();
  extern __shared__ __align__(16) float matched_smem[];
  const int pairs = block_users * chunk;
  float* su = matched_smem;                           // [U * C][stride]
  float* si = su + block_users * C * kMatchedStride;  // [pairs][stride]
  int* sid = reinterpret_cast<int*>(si + pairs * kMatchedStride);

  const int b0 = blockIdx.x * block_users;
  const int t0 = blockIdx.y * chunk;
  const int tid = threadIdx.x;
  const int p = tid / C;
  const int col = tid - p * C;
  const int ul = p / chunk;
  const int b = b0 + ul;
  const int t = t0 + p - ul * chunk;
  const bool owner = p < pairs;
  const bool live = owner && b < B && t < T;
  const int width = MP == 0 ? D : 2 * mixtures * D;  // a user's row

  for (int e = tid; e < pairs; e += kMatchedThreads) {
    const int eu = e / chunk;
    const int et = t0 + e - eu * chunk;
    long long id = 0;
    if (b0 + eu < B && et < T) {
      id = (long long)ids[(long long)(b0 + eu) * T + et];
      id = id < 0 ? 0 : (id >= N ? N - 1 : id);
    }
    sid[e] = (int)id;
  }

  float acc = -0.0f;
  for (int d0 = 0; d0 < D; d0 += kMatchedSlab) {
    const int depth = min(kMatchedSlab, D - d0);
    // Column c of user u of the block (its row u * C + c) from d0 on:
    // tastes, then attentions; none past M or past the batch.
    auto column = [&](int row) -> const float* {
      const int u = row / C;
      const int c = row - u * C;
      const int m = c < MP ? c : c - MP;
      if (b0 + u >= B || (MP != 0 && m >= mixtures)) return nullptr;
      const int k = MP == 0 ? 0 : (c < MP ? m : mixtures + m);
      return users + (long long)(b0 + u) * width + k * D + d0;
    };
    __syncthreads();  // the ids are staged; the last slab is scored
    if (vectors) {
      const int uvecs = depth / 4;
#pragma unroll 4
      for (int e = tid; e < block_users * C * uvecs; e += kMatchedThreads) {
        const int row = e / uvecs;
        const int v = e - row * uvecs;
        const float* src = column(row);
        const float4 x = src ? *reinterpret_cast<const float4*>(src + 4 * v)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float* dst = su + row * kMatchedStride + 4 * v;
        dst[0] = x.x;
        dst[1] = x.y;
        dst[2] = x.z;
        dst[3] = x.w;
      }
      constexpr int V = 16 / sizeof(Item);
      const int vecs = depth / V;
#pragma unroll 4
      for (int e = tid; e < pairs * vecs; e += kMatchedThreads) {
        const int q = e / vecs;
        const int v = e - q * vecs;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            items + (long long)sid[q] * D + d0 + v * V);
        unpack_items<Item>(raw, si + q * kMatchedStride + v * V);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < block_users * C * depth; e += kMatchedThreads) {
        const int row = e / depth;
        const int dd = e - row * depth;
        const float* src = column(row);
        su[row * kMatchedStride + dd] = src ? src[dd] : 0.0f;
      }
#pragma unroll 4
      for (int e = tid; e < pairs * depth; e += kMatchedThreads) {
        const int q = e / depth;
        const int dd = e - q * depth;
        si[q * kMatchedStride + dd] =
            to_f32(items[(long long)sid[q] * D + d0 + dd]);
      }
    }
    __syncthreads();
    if (owner) {
      const float* ur = su + (ul * C + col) * kMatchedStride;
      const float* ir = si + p * kMatchedStride;
#pragma unroll 8
      for (int dd = 0; dd < depth; ++dd)
        acc = __fadd_rn(acc, __fmul_rn(ur[dd], ir[dd]));
    }
  }

  if constexpr (MP == 0) {
    if (live) out[(long long)b * T + t] = __fadd_rn(acc, bias[sid[p]]);
  } else {
    // The pair's lanes are adjacent in one warp (C divides 32), and every
    // lane of the block reaches the shuffles.
    const int first = (tid & 31) - col;
    float dots[C];
#pragma unroll
    for (int k = 0; k < C; ++k)
      dots[k] = __shfl_sync(0xffffffffu, acc, first + k);
    if (live && col == 0)
      out[(long long)b * T + t] = mixture_combine<MP>(dots, mixtures,
                                                      bias[sid[p]]);
  }
}

template <typename Item, typename Id, int MP>
int launch_matched(const float* users, const void* items, bool vectors,
                   const float* bias, const void* ids, float* out, int B,
                   int N, int D, int T, int mixtures, int block_users,
                   int chunk, cudaStream_t stream) {
  constexpr int C = matched_lanes<MP>();
  if ((long long)block_users * chunk * C > kMatchedThreads)
    return cudaErrorInvalidValue;
  const size_t smem = matched_smem_bytes<MP>(block_users, chunk);
  auto kernel = matched_kernel<Item, Id, MP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + block_users - 1) / block_users,
                  (T + chunk - 1) / chunk);
  kernel<<<grid, kMatchedThreads, smem, stream>>>(
      users, static_cast<const Item*>(items), bias,
      static_cast<const Id*>(ids), out, B, N, D, T, mixtures, block_users,
      chunk, vectors);
  return cudaGetLastError();
}

template <typename Item, typename Id>
int dispatch_matched(const float* users, const void* items, const float* bias,
                     const void* ids, float* out, int B, int N, int D, int T,
                     int mixtures, int block_users, int chunk,
                     cudaStream_t stream) {
  // 16-byte vectors need user and item rows that start on 16 bytes.
  const bool vectors = D % (16 / sizeof(Item)) == 0 &&
                       reinterpret_cast<uintptr_t>(items) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(users) % 16 == 0;
  return with_shape(mixtures, [&](auto mp) {
    return launch_matched<Item, Id, decltype(mp)::value>(
        users, items, vectors, bias, ids, out, B, N, D, T, mixtures,
        block_users, chunk, stream);
  });
}

}  // namespace

extern "C" {

// Widest target block one K1 or K5 launch takes at width D; the wrapper
// chunks wider ones.
int spotlight_rank_max_targets(int D, int mixtures) {
  return with_shape(mixtures, [&](auto mp) {
    return max_targets<decltype(mp)::value>(D);
  });
}

// Users per block of the rank kernel.
int spotlight_rank_block_users(int mixtures) {
  return with_shape(mixtures, [](auto mp) {
    return RankShape<decltype(mp)::value>::kUsers;
  });
}

// Shared memory of the narrowest launch at width D.
size_t spotlight_rank_smem_bytes(int D, int mixtures) {
  return (size_t)with_shape(mixtures, [&](auto mp) {
    return (int)rank_smem_bytes<decltype(mp)::value>(D, 0);
  });
}

// half_units (B, T) int32 must be zeroed by the caller.  users are (B, D)
// for mixtures = 0 (dot scoring), else (B, 2 * mixtures * D).  Returns a
// cudaError_t (0 on success).
int spotlight_rank_weights(const float* users, const void* items,
                           int items_bf16, const float* bias,
                           const float* tscores, int* half_units, int B,
                           int N, int D, int T, int mixtures, int splits,
                           void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || T <= 0 || splits <= 0 || mixtures < 0 ||
      mixtures > kMaxMixtures)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items_bf16)
    return dispatch<__nv_bfloat16, false>(users, items, bias, tscores,
                                          nullptr, half_units, nullptr, B, N,
                                          D, T, mixtures, splits, s);
  return dispatch<float, false>(users, items, bias, tscores, nullptr,
                                half_units, nullptr, B, N, D, T, mixtures,
                                splits, s);
}

// K5.  greater and equal (B, T) int32 must be zeroed by the caller; tids
// (B, T) int32 are the target ids (any value; one outside [0, N) excludes
// nothing).  Returns a cudaError_t (0 on success).
int spotlight_rank_counts(const float* users, const void* items,
                          int items_bf16, const float* bias,
                          const float* tscores, const int* tids, int* greater,
                          int* equal, int B, int N, int D, int T,
                          int mixtures, int splits, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || T <= 0 || splits <= 0 || mixtures < 0 ||
      mixtures > kMaxMixtures)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items_bf16)
    return dispatch<__nv_bfloat16, true>(users, items, bias, tscores, tids,
                                         greater, equal, B, N, D, T,
                                         mixtures, splits, s);
  return dispatch<float, true>(users, items, bias, tscores, tids, greater,
                               equal, B, N, D, T, mixtures, splits, s);
}

// Pair slots of one matched launch (its users x targets at most).
int spotlight_matched_pair_slots(int mixtures) {
  return with_shape(mixtures, [](auto mp) {
    return kMatchedThreads / matched_lanes<decltype(mp)::value>();
  });
}

// K1c (mixtures = 0) and K4: out (B, T) float32 = the score of item
// ids[b, t] (int32, or int64 where ids_int64; clamped into [0, N)) for user
// b, whose row of users is (D) for dots, else (2 * mixtures * D): its
// tastes, then attentions.  A launch's blocks take block_users users x
// chunk targets (block_users * chunk <= spotlight_matched_pair_slots).
// Returns a cudaError_t (0 on success).
int spotlight_matched_scores(const float* users, const void* items,
                             int items_bf16, const float* bias,
                             const void* ids, int ids_int64, float* out,
                             int B, int N, int D, int T, int mixtures,
                             int block_users, int chunk, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || T <= 0 || mixtures < 0 ||
      mixtures > kMaxMixtures || block_users <= 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPOTLIGHT_MATCHED(ITEM, ID)                                        \
  return dispatch_matched<ITEM, ID>(users, items, bias, ids, out, B, N, D, \
                                    T, mixtures, block_users, chunk, s)
  if (items_bf16) {
    if (ids_int64) SPOTLIGHT_MATCHED(__nv_bfloat16, long long);
    SPOTLIGHT_MATCHED(__nv_bfloat16, int);
  }
  if (ids_int64) SPOTLIGHT_MATCHED(float, long long);
  SPOTLIGHT_MATCHED(float, int);
#undef SPOTLIGHT_MATCHED
}

}  // extern "C"
