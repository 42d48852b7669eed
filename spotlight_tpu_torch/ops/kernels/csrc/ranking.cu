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
// adds 1 half unit), where score is item . user + item_bias in
// score_block's order (dot_tile_accumulate, then the bias) or comes from
// mixture_score_block (common.cuh).  The wrapper returns half_units * 0.5.
//
// K5 is the same kernels with COUNTS = true: two exact int32 counters per
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
// operations) plus M expf.  The exact-tie contract forbids the tensor cores
// (TF32 rounds the operands) and FMA contraction, so every multiply and
// every add is its own instruction on the float32 CUDA cores: the floor is
// 2 * B * N * D instructions at ~33.5e12 a second (132 SMs x 128 lanes x
// ~1.98 GHz), half the data sheet's FMA rate.
//
// Dot scoring (rank_dot_kernel, K1 and K5 with mixtures == 0) is K2's dot
// stage 1 (topk.cu) with its filter replaced by counting.  One block of 512
// threads an SM keeps 64 users resident in shared memory (transposed, rows
// 16-byte aligned) and walks its contiguous split of the catalogue in
// 128-item tiles, 32 dimensions a slab.  The slabs are double-buffered
// through registers: the next slab's global loads are issued before this
// slab is scored and stored (transposed, bf16 upcast) after it, one
// barrier a slab, no index division.  Each thread scores 4 items x 4 users
// with dot_tile_accumulate (two float4 shared loads feed 16 products), then
// adds the bias: score_block's order, so the scores tie K1c's bit for bit.
// Rows at or past N score NaN, which no comparison counts.  Counting:
// - narrow (T <= 4): the thread compares its own 16 scores against the
//   T target scores of its 4 users, held in registers; at the split's end
//   the 32 threads sharing a user add their counts (two warp shuffles,
//   then shared-memory integer atomics) and one atomicAdd a (user, target)
//   goes to global memory;
// - wide (T <= 128 a launch; the wrapper chunks wider T): comparing every
//   score with every target costs T integer-pipe instructions or more a
//   score, so the block sorts each user's targets once into shared memory,
//   the tile's scores go to shared memory, and each thread binary-searches
//   16 of them a tile for one user: a score that beats p targets and
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
// Mixture scoring (rank_weights_kernel) holds 2M vectors a user (512
// floats at M = 4, D = 64), so a block keeps 32 users (67 KB of users, 93
// KB in all: two blocks an SM) in shared memory and walks 64-item tiles
// staged element by element; each thread scores a 4 x 2 block with
// mixture_score_block, whose M softmax weights per pair stay in registers.
// The tile's scores go to shared memory; each thread then owns one user
// and up to MAXP targets and compares the tile against them from
// registers.
//
// Counts are int32 half units: exact and independent of order, so the
// splits add their counts with atomicAdd in any order.  The TPU kernel's
// grid ran in sequence and accumulated in VMEM; here the splits run in
// parallel.
//
// K1c and K4 score one (user, id) pair a thread through score_block /
// mixture_score_block, so their scores are bit-equal to the catalogue
// pass's.  The JAX K4 scored every gathered row against every user of the
// batch and kept the diagonal; here only the B * T pairs are scored.
#include "common.cuh"

using namespace spotlight;

namespace {

// ---- dot scoring ----------------------------------------------------------

constexpr int kDotThreads = 512;
constexpr int kDotUsers = 64;                 // users a block, resident
constexpr int kDotItems = 128;                // items a tile
constexpr int kDotDepth = 32;                 // dimensions a staged slab
constexpr int kDotStride = kDotItems + 4;     // padded row of a slab
constexpr int kDotRI = 4;                     // items a thread scores
constexpr int kDotRU = 4;                     // users a thread scores
constexpr int kScoreStride = kDotUsers + 4;   // padded row of a score tile
// Targets a narrow launch holds in registers; target slots of the widest
// wide launch.
constexpr int kNarrowTargets = 4;
constexpr int kWideTargets = 128;
// Shared memory one H100 block may use.
constexpr size_t kMaxSharedBytes = 232448;

// Shared memory of the dot kernel: the resident users and two item slabs,
// then the narrow path's per-block counts or the wide path's score tile,
// sorted targets and count bins (TP target slots, TP = 0 for narrow).
// 232,448 bytes a block allow D <= 768 narrow, D <= 383 at TP = 128.
size_t rank_dot_smem_bytes(int D, int TP) {
  const size_t extra =
      TP == 0 ? 2 * kDotUsers * kNarrowTargets
              : kDotItems * kScoreStride + (2 * (size_t)TP + 1) * kDotUsers;
  return sizeof(float) *
         ((size_t)D * kDotUsers + 2 * kDotDepth * kDotStride + extra);
}

// The dot score of one (user, row) pair in dot_tile_accumulate's order
// (from -0.0, one product added at a time), then the bias: the same bits
// as the catalogue pass's score of that pair.
template <typename Item>
__device__ __forceinline__ float dot_row_score(const float* user,
                                               int user_stride,
                                               const Item* row, float bias,
                                               int D) {
  float acc = -0.0f;
  for (int d = 0; d < D; ++d)
    acc = __fadd_rn(acc, __fmul_rn(user[d * user_stride], to_f32(row[d])));
  return __fadd_rn(acc, bias);
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
// whose id is tids[b, t] left out) with dot scoring.
// - Narrow (WIDE = false): T <= TP <= kNarrowTargets; each thread holds TP
//   target scores of each of its kDotRU users in registers and compares
//   its own scores against them.
// - Wide: T <= TP, a power of two; the block sorts each user's targets
//   into shared memory once, then each thread takes one user and 16 items
//   of the tile's shared scores and finds, by binary search, how many
//   targets each score beats (p) or reaches (q); bins p and q of the user
//   count it, and at the end target j's count is the sum of the bins above
//   its rank j, so a score costs log2(TP) + 2 shared loads, not T compares.
template <typename Item, int TP, bool WIDE, bool COUNTS>
__global__ void __launch_bounds__(kDotThreads, 1)
rank_dot_kernel(const float* __restrict__ users,
                const Item* __restrict__ items,
                const float* __restrict__ bias,
                const float* __restrict__ tscores,
                const int* __restrict__ tids, int* __restrict__ out_a,
                int* __restrict__ out_b, int B, int N, int D, int T,
                int tiles_per_split) {
  constexpr int U = kDotUsers;
  constexpr int RI = kDotRI;
  constexpr int RU = kDotRU;
  constexpr int kT = kDotThreads;
  constexpr int kWarps = kT / 32;
  constexpr int kLoads = kDotItems * kDotDepth / kT;  // slab loads a thread
  constexpr int kUserWarps = U / RU / 8;  // warps across the user groups
  constexpr int kSlab = kDotDepth * kDotStride;
  constexpr int kRows = kT / U;           // wide: threads a user
  constexpr int kHeld = WIDE ? 1 : RU * TP;  // narrow: targets in registers
  constexpr int GE = COUNTS ? 1 << 16 : 1;
  static_assert((kDotItems / RI) * (U / RU) == kT, "one tile a block");
  static_assert(WIDE ? (TP & (TP - 1)) == 0 && TP <= kWideTargets
                     : TP <= kNarrowTargets, "target slots");

  extern __shared__ __align__(16) float dot_smem[];
  float* su = dot_smem;                     // [D][U] resident users
  float* si = su + D * U;                   // [2][kDotDepth][kDotStride]
  float* ss = si + 2 * kSlab;               // wide: [kDotItems][kScoreStride]
  float* st = ss + kDotItems * kScoreStride;  // wide: [TP][U] sorted targets
  int* bins = reinterpret_cast<int*>(st + TP * U);  // wide: [TP + 1][U]
  int* red = reinterpret_cast<int*>(ss);    // narrow: [2][U][TP] counts

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * U;
  for (int e = tid; e < U * D; e += kT) {
    const int u = e / D;
    const int d = e - u * D;
    su[d * U + u] = b0 + u < B ? users[(long long)(b0 + u) * D + d] : 0.0f;
  }

  // Scoring ownership: items 4 ig + r, users 4 ug + c; a warp covers 4
  // item groups x 8 user groups, so its float4 reads of a dimension touch
  // 64 and 128 contiguous bytes, and the 4 lanes that differ in lane & 3
  // share users.
  const int ug = (warp % kUserWarps) * 8 + (lane >> 2);
  const int ig = (warp / kUserWarps) * 4 + (lane & 3);
  // Staging ownership: dimension sd of rows sr + kWarps j; a warp loads
  // 32-byte runs of 4 rows and stores them to 32 distinct banks.
  const int sd = 8 * (warp & 3) + (lane >> 2);
  const int sr = 4 * (warp >> 2) + (lane & 3);
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
      const int b = b0 + 4 * ug + h / TP;
      const int t = h % TP;
      ts[h] = b < B && t < T ? tscores[(long long)b * T + t] : nan;
      count[h] = 0;
    }
  }

  const int num_tiles = (N + kDotItems - 1) / kDotItems;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(num_tiles, tile_begin + tiles_per_split);
  const int slabs = (D + kDotDepth - 1) / kDotDepth;

  Item staged[kLoads];
  auto load_slab = [&](int tile, int slab) {
    const int d = slab * kDotDepth + sd;
    const long long row = (long long)tile * kDotItems + sr;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long r = row + kWarps * j;
      staged[j] = d < D && r < N ? items[r * D + d] : Item(0.0f);
    }
  };
  auto store_slab = [&](float* slab) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      slab[sd * kDotStride + sr + kWarps * j] = to_f32(staged[j]);
  };

  load_slab(tile_begin, 0);
  store_slab(si);
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
    if (more) load_slab(next_tile, next_slab);

    const int row0 = tile * kDotItems;
    if (slab == 0) {
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int id = row0 + 4 * ig + r;
        item_bias[r] = id < N ? bias[id] : 0.0f;
#pragma unroll
        for (int c = 0; c < RU; ++c) acc[r][c] = -0.0f;
      }
    }
    const int d0 = slab * kDotDepth;
    const float* slab_items = si + buf * kSlab + 4 * ig;
    const float* slab_users = su + d0 * U + 4 * ug;
    if (D - d0 >= kDotDepth)  // a full slab: a constant trip count
      dot_tile_accumulate<RI, RU>(acc, kDotDepth, slab_items, kDotStride, 0,
                                  slab_users, U, 0);
    else
      dot_tile_accumulate<RI, RU>(acc, D - d0, slab_items, kDotStride, 0,
                                  slab_users, U, 0);

    const bool last = slab == slabs - 1;
    if (last) {
      // Rows at or past N score NaN, which no comparison counts.
      float s[RI][RU];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RU; ++c)
          s[r][c] = row0 + 4 * ig + r < N
                        ? __fadd_rn(acc[r][c], item_bias[r]) : nan;
      if constexpr (WIDE) {
        // With one slab a tile, no barrier yet separates the last tile's
        // searches from this tile's scores.
        if (slabs == 1) __syncthreads();
#pragma unroll
        for (int r = 0; r < RI; ++r)
          *reinterpret_cast<float4*>(
              ss + (4 * ig + r) * kScoreStride + 4 * ug) =
              make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
      } else {
#pragma unroll
        for (int c = 0; c < RU; ++c)
#pragma unroll
          for (int t = 0; t < TP; ++t)
#pragma unroll
            for (int r = 0; r < RI; ++r)
              count[c * TP + t] += compare<GE>(s[r][c], ts[c * TP + t]);
      }
    }
    if (more) store_slab(si + (buf ^ 1) * kSlab);
    __syncthreads();
    if constexpr (WIDE) {
      if (last) {
        const float* sorted = st + cu;
#pragma unroll 2
        for (int k = 0; k < kDotItems / kRows; ++k) {
          const float s = ss[(trow + kRows * k) * kScoreStride + cu];
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
  const int row_begin = tile_begin * kDotItems;
  const int row_end = min(N, tile_end * kDotItems);
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
        const float s = dot_row_score(su + u, U, items + (long long)id * D,
                                      bias[id], D);
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
        const int slot = (4 * ug + h / TP) * TP + h % TP;
        atomicAdd(&red_a[slot], a);
        if constexpr (COUNTS) atomicAdd(&red_b[slot], e);
      }
    }
    __syncthreads();
    for (int slot = tid; slot < U * TP; slot += kT)
      finish(slot / TP, slot % TP, red_a[slot], red_b[slot]);
  }
}
template <typename Item, int TP, bool WIDE, bool COUNTS>
int launch_dot(const float* users, const void* items, const float* bias,
               const float* tscores, const int* tids, int* out_a,
               int* out_b, int B, int N, int D, int T, int splits,
               cudaStream_t stream) {
  const size_t smem = rank_dot_smem_bytes(D, WIDE ? TP : 0);
  auto kernel = rank_dot_kernel<Item, TP, WIDE, COUNTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (N + kDotItems - 1) / kDotItems;
  // K5 counts in half words: a narrow thread meets kDotRI rows of each
  // tile, a wide block's bin all of them, and neither may pass 65,535 rows.
  constexpr int kMaxTiles = 65535 / (WIDE ? kDotItems : kDotRI);
  const int per_split = min(kMaxTiles, (num_tiles + splits - 1) / splits);
  const int used_splits = (num_tiles + per_split - 1) / per_split;
  dim3 grid((B + kDotUsers - 1) / kDotUsers, used_splits);
  kernel<<<grid, kDotThreads, smem, stream>>>(
      users, static_cast<const Item*>(items), bias, tscores, tids, out_a,
      out_b, B, N, D, T, per_split);
  return cudaGetLastError();
}

// The narrowest instantiation that holds T targets.
template <typename Item, bool COUNTS>
int dispatch_dot(const float* users, const void* items, const float* bias,
                 const float* tscores, const int* tids, int* out_a,
                 int* out_b, int B, int N, int D, int T, int splits,
                 cudaStream_t stream) {
#define SPOTLIGHT_DOT(TP, WIDE)                                              \
  return launch_dot<Item, TP, WIDE, COUNTS>(users, items, bias, tscores,    \
                                            tids, out_a, out_b, B, N, D, T, \
                                            splits, stream)
  if (T <= 1) SPOTLIGHT_DOT(1, false);
  if (T <= 2) SPOTLIGHT_DOT(2, false);
  if (T <= kNarrowTargets) SPOTLIGHT_DOT(kNarrowTargets, false);
  if (T <= 8) SPOTLIGHT_DOT(8, true);
  if (T <= 16) SPOTLIGHT_DOT(16, true);
  if (T <= 32) SPOTLIGHT_DOT(32, true);
  if (T <= 64) SPOTLIGHT_DOT(64, true);
  if (T <= kWideTargets) SPOTLIGHT_DOT(kWideTargets, true);
  return cudaErrorInvalidValue;
#undef SPOTLIGHT_DOT
}

// Widest target block one dot launch takes at width D: the widest wide
// launch whose shared memory fits, else a narrow one.
int dot_max_targets(int D) {
  int tp = kWideTargets;
  while (tp > kNarrowTargets &&
         rank_dot_smem_bytes(D, tp) > kMaxSharedBytes)
    tp /= 2;
  return tp;
}

// ---- mixture scoring ------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kItems = 64;              // items per tile
constexpr int kIS = kItems + 1;         // padded stride of the item tile
constexpr int kMixRU = 2;               // users a thread scores
constexpr int kMixUsers = 16 * kMixRU;  // users a block (16 threads across)

// Mixtures of at most MAXM tastes.  COUNTS = false writes K1's half units
// to out_a (tids and out_b unused); COUNTS = true writes K5's greater
// counts to out_a and equal counts to out_b, excluding the row whose id is
// tids[b, t].
template <typename Item, int MAXP, int MAXM, bool COUNTS>
__global__ void __launch_bounds__(kThreads)
rank_weights_kernel(const float* __restrict__ users,
                    const Item* __restrict__ items,
                    const float* __restrict__ bias,
                    const float* __restrict__ tscores,
                    const int* __restrict__ tids, int* __restrict__ out_a,
                    int* __restrict__ out_b, int B, int N, int D, int T,
                    int mixtures, int tiles_per_split) {
  constexpr int RU = kMixRU;
  constexpr int kUsers = kMixUsers;
  constexpr int kUS = kUsers + 1;
  constexpr int kRows = kThreads / kUsers;
  const int K = 2 * mixtures * D;  // user operand width
  extern __shared__ float smem[];
  float* su = smem;               // [K][kUS]   resident users
  float* si = su + K * kUS;       // [D][kIS]   item tile
  float* ss = si + D * kIS;       // [kItems][kUS] tile scores
  float* sb = ss + kItems * kUS;  // [kItems]   tile biases

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kUsers;
  stage_transposed(su, users, b0, kUsers, B, K, kUS);

  // Comparison ownership: one user, targets t0, t0 + kRows, ...
  const int cu = tid % kUsers;
  const int t0 = tid / kUsers;
  const int b = b0 + cu;
  float ts[MAXP];
  int count[MAXP];
  int target_id[COUNTS ? MAXP : 1];
  int equal[COUNTS ? MAXP : 1];
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    const int t = t0 + kRows * k;
    const bool real = b < B && t < T;
    ts[k] = real ? tscores[(long long)b * T + t] : 0.0f;
    count[k] = 0;
    if constexpr (COUNTS) {
      target_id[k] = real ? tids[(long long)b * T + t] : -1;
      equal[k] = 0;
    }
  }
  // Scoring ownership: items ti + 16 r, users tu + 16 c.
  const int ti = tid / 16;
  const int tu = tid % 16;

  const int num_tiles = (N + kItems - 1) / kItems;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(num_tiles, tile_begin + tiles_per_split);
  __syncthreads();

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int row0 = tile * kItems;
    stage_transposed(si, items, row0, kItems, N, D, kIS);
    for (int i = tid; i < kItems; i += kThreads)
      sb[i] = row0 + i < N ? bias[row0 + i] : 0.0f;
    __syncthreads();

    float acc[4][RU];
    mixture_score_block<4, RU, MAXM>(
        acc, mixtures, D,
        [&](int r, int d) { return si[d * kIS + ti + 16 * r]; },
        [&](int c, int k, int d) {
          return su[(k * D + d) * kUS + tu + 16 * c];
        },
        [&](int r) { return sb[ti + 16 * r]; });
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < RU; ++c)
        ss[(ti + 16 * r) * kUS + tu + 16 * c] = acc[r][c];
    __syncthreads();

    // Rows past the catalogue end never count.
    const int valid = min(kItems, N - row0);
    for (int i = 0; i < valid; ++i) {
      const float s = ss[i * kUS + cu];
      if constexpr (COUNTS) {
#pragma unroll
        for (int k = 0; k < MAXP; ++k) {
          const int other = row0 + i != target_id[k];
          count[k] += other & (s > ts[k]);
          equal[k] += other & (s == ts[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < MAXP; ++k)
          count[k] += 2 * (s > ts[k]) + (s == ts[k]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    const int t = t0 + kRows * k;
    if (b >= B || t >= T) continue;
    if (count[k] != 0) atomicAdd(&out_a[(long long)b * T + t], count[k]);
    if constexpr (COUNTS)
      if (equal[k] != 0) atomicAdd(&out_b[(long long)b * T + t], equal[k]);
  }
}

template <typename Item>
__global__ void matched_scores_kernel(const float* __restrict__ users,
                                      const Item* __restrict__ items,
                                      const float* __restrict__ bias,
                                      const int* __restrict__ ids,
                                      float* __restrict__ out, int B, int T,
                                      int D) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * T) return;
  const long long b = idx / T;
  const long long id = ids[idx];
  const float* u = users + b * D;
  const Item* row = items + id * D;
  float acc[1][1];
  score_block<1, 1>(
      acc, D, [&](int, int d) { return to_f32(row[d]); },
      [&](int, int d) { return u[d]; }, [&](int) { return bias[id]; });
  out[idx] = acc[0][0];
}

template <typename Item>
__global__ void candidate_scores_kernel(const float* __restrict__ users,
                                        const Item* __restrict__ items,
                                        const float* __restrict__ bias,
                                        const int* __restrict__ ids,
                                        float* __restrict__ out, int B, int T,
                                        int D, int mixtures) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * T) return;
  const long long b = idx / T;
  const long long id = ids[idx];
  const float* u = users + b * 2 * mixtures * D;
  const Item* row = items + id * D;
  float acc[1][1];
  mixture_score_block<1, 1, kMaxMixtures>(
      acc, mixtures, D, [&](int, int d) { return to_f32(row[d]); },
      [&](int, int k, int d) { return u[k * D + d]; },
      [&](int) { return bias[id]; });
  out[idx] = acc[0][0];
}

size_t rank_mixture_smem_bytes(int D, int mixtures) {
  const size_t K = 2 * (size_t)mixtures * D;
  return sizeof(float) * (K * (kMixUsers + 1) + (size_t)D * kIS +
                          (size_t)kItems * (kMixUsers + 1) + kItems);
}

template <typename Item, int MAXP, int MAXM, bool COUNTS>
int launch_mixture(const float* users, const void* items, const float* bias,
                   const float* tscores, const int* tids, int* out_a,
                   int* out_b, int B, int N, int D, int T, int mixtures,
                   int splits, cudaStream_t stream) {
  const size_t smem = rank_mixture_smem_bytes(D, mixtures);
  auto kernel = rank_weights_kernel<Item, MAXP, MAXM, COUNTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (N + kItems - 1) / kItems;
  const int per_split = (num_tiles + splits - 1) / splits;
  const int used_splits = (num_tiles + per_split - 1) / per_split;
  dim3 grid((B + kMixUsers - 1) / kMixUsers, used_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      users, static_cast<const Item*>(items), bias, tscores, tids, out_a,
      out_b, B, N, D, T, mixtures, per_split);
  return cudaGetLastError();
}

// At most 4 targets a thread (32 a launch), since each carries a score (and
// for K5 an id and two counters) in registers beside the M weights a pair.
template <typename Item, bool COUNTS>
int dispatch_mixture(const float* users, const void* items, const float* bias,
                     const float* tscores, const int* tids, int* out_a,
                     int* out_b, int B, int N, int D, int T, int mixtures,
                     int splits, cudaStream_t stream) {
#define SPOTLIGHT_MIXTURE(MAXP, MAXM)                                      \
  return launch_mixture<Item, MAXP, MAXM, COUNTS>(                         \
      users, items, bias, tscores, tids, out_a, out_b, B, N, D, T,         \
      mixtures, splits, stream)
  constexpr int rows = kThreads / kMixUsers;
  if (mixtures <= 4) {
    if (T <= 1 * rows) SPOTLIGHT_MIXTURE(1, 4);
    if (T <= 4 * rows) SPOTLIGHT_MIXTURE(4, 4);
    return cudaErrorInvalidValue;
  }
  if (T <= 1 * rows) SPOTLIGHT_MIXTURE(1, kMaxMixtures);
  if (T <= 4 * rows) SPOTLIGHT_MIXTURE(4, kMaxMixtures);
  return cudaErrorInvalidValue;
#undef SPOTLIGHT_MIXTURE
}

// K1 (COUNTS = false: tids and equal unused) or K5.
template <typename Item, bool COUNTS>
int dispatch(const float* users, const void* items, const float* bias,
             const float* tscores, const int* tids, int* out_a, int* out_b,
             int B, int N, int D, int T, int mixtures, int splits,
             cudaStream_t stream) {
  if (mixtures == 0)
    return dispatch_dot<Item, COUNTS>(users, items, bias, tscores, tids,
                                      out_a, out_b, B, N, D, T, splits,
                                      stream);
  return dispatch_mixture<Item, COUNTS>(users, items, bias, tscores, tids,
                                        out_a, out_b, B, N, D, T, mixtures,
                                        splits, stream);
}

}  // namespace

extern "C" {

// Widest target block one K1 or K5 launch takes at width D; the wrapper
// chunks wider ones.
int spotlight_rank_max_targets(int D, int mixtures) {
  return mixtures > 0 ? 4 * (kThreads / kMixUsers) : dot_max_targets(D);
}

// Users per block of the rank kernels.
int spotlight_rank_block_users(int mixtures) {
  return mixtures > 0 ? kMixUsers : kDotUsers;
}

// Shared memory of the narrowest launch at width D.
size_t spotlight_rank_smem_bytes(int D, int mixtures) {
  return mixtures > 0 ? rank_mixture_smem_bytes(D, mixtures)
                      : rank_dot_smem_bytes(D, 0);
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

// out (B, T) float32 = dot score of item ids[b, t] for user b.
int spotlight_matched_scores(const float* users, const void* items,
                             int items_bf16, const float* bias,
                             const int* ids, float* out, int B, int T, int D,
                             void* stream) {
  if (B <= 0 || T <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * T;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (items_bf16)
    matched_scores_kernel<<<blocks, threads, 0, s>>>(
        users, static_cast<const __nv_bfloat16*>(items), bias, ids, out, B,
        T, D);
  else
    matched_scores_kernel<<<blocks, threads, 0, s>>>(
        users, static_cast<const float*>(items), bias, ids, out, B, T, D);
  return cudaGetLastError();
}

// out (B, T) float32 = mixture score of item ids[b, t] for user b, whose
// row of users (B, 2 * mixtures * D) holds its tastes, then attentions.
int spotlight_candidate_scores(const float* users, const void* items,
                               int items_bf16, const float* bias,
                               const int* ids, float* out, int B, int T,
                               int D, int mixtures, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || mixtures <= 0 ||
      mixtures > kMaxMixtures)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)B * T;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (items_bf16)
    candidate_scores_kernel<<<blocks, threads, 0, s>>>(
        users, static_cast<const __nv_bfloat16*>(items), bias, ids, out, B,
        T, D, mixtures);
  else
    candidate_scores_kernel<<<blocks, threads, 0, s>>>(
        users, static_cast<const float*>(items), bias, ids, out, B, T, D,
        mixtures);
  return cudaGetLastError();
}

}  // extern "C"
