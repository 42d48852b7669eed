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
// adds 1 half unit), where score comes from score_block (dot: item . user +
// item_bias) or mixture_score_block (common.cuh).  The wrapper returns
// half_units * 0.5.
//
// K5 is the same kernel with COUNTS = true: two exact int32 counters per
// (user, target), greater[b, t] = count(score > ts) and equal[b, t] =
// count(score == ts), over the catalogue rows whose id differs from the
// target's id tids[b, t].  The target is excluded by id, not by score, so
// the target scores may come from any arithmetic; an id outside [0, N)
// matches no row (per-shard callers pass shifted ids on purpose).  Rows at
// or past N never count: the loop stops at the catalogue's end.
//
// What bounds it on an H100: arithmetic.  At B = 2048 users, N = 200K items,
// D = 64 the dot catalogue pass is 2 * B * N * D = 5.2e10 float32 operations
// against a 51 MB read of the item table, about 1,000 operations per byte;
// mixture scoring with M = 4 does 2M = 8 such dots per pair (4.2e11
// operations) plus M expf.  The exact-tie contract forbids the tensor cores
// (TF32 rounds the operands) and FMA contraction, so every multiply and
// every add is its own instruction on the float32 CUDA cores.
//
// What the design does about it: each block keeps its users resident in
// shared memory and walks its own contiguous split of the catalogue in
// 64-item tiles staged through shared memory (transposed, padded against
// bank conflicts).  Dot scoring keeps 64 users a block and gives each
// thread a 4 x 4 block of (item, user) pairs, so every shared load feeds
// four multiply-adds.  Mixture scoring holds 2M vectors a user (512 floats
// at M = 4, D = 64), so a block keeps 32 users (67 KB of users, 93 KB in
// all: two blocks an SM) and each thread a 4 x 2 block, whose M softmax
// weights per pair stay in registers.  The tile's scores go to shared
// memory; each thread then owns one user and up to MAXP targets and
// compares the tile against them from registers.  Counts are int32 half
// units: exact and independent of order, so the splits add their counts
// with atomicAdd in any order.  The TPU kernel's grid ran in sequence and
// accumulated in VMEM; here the splits run in parallel.
//
// K1c and K4 score one (user, id) pair a thread through the same
// score_block / mixture_score_block, so their scores are bit-equal to the
// catalogue pass's.  The JAX K4 scored every gathered row against every
// user of the batch and kept the diagonal; here only the B * T pairs are
// scored.
#include "common.cuh"

using namespace spotlight;

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 64;           // items per tile
constexpr int kIS = kItems + 1;      // padded stride of the item tile

// Users per block for RU users a thread (16 threads across the users).
template <int RU>
__host__ __device__ constexpr int block_users() { return 16 * RU; }

// RU = 4 for dot scoring (64 users a block), 2 for mixtures (32 users).
__host__ __device__ constexpr int users_per_thread(bool mixture) {
  return mixture ? 2 : 4;
}

// MAXM = 0 scores dot products, MAXM > 0 mixtures of at most MAXM tastes.
// COUNTS = false writes K1's half units to out_a (tids and out_b unused);
// COUNTS = true writes K5's greater counts to out_a and equal counts to
// out_b, excluding the row whose id is tids[b, t].
template <typename Item, int MAXP, int RU, int MAXM, bool COUNTS>
__global__ void __launch_bounds__(kThreads)
rank_weights_kernel(const float* __restrict__ users,
                    const Item* __restrict__ items,
                    const float* __restrict__ bias,
                    const float* __restrict__ tscores,
                    const int* __restrict__ tids, int* __restrict__ out_a,
                    int* __restrict__ out_b, int B, int N, int D, int T,
                    int mixtures, int tiles_per_split) {
  constexpr int kUsers = block_users<RU>();
  constexpr int kUS = kUsers + 1;
  constexpr int kTargetRows = kThreads / kUsers;
  const int K = MAXM == 0 ? D : 2 * mixtures * D;  // user operand width
  extern __shared__ float smem[];
  float* su = smem;               // [K][kUS]   resident users
  float* si = su + K * kUS;       // [D][kIS]   item tile
  float* ss = si + D * kIS;       // [kItems][kUS] tile scores
  float* sb = ss + kItems * kUS;  // [kItems]   tile biases

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kUsers;
  stage_transposed(su, users, b0, kUsers, B, K, kUS);

  // Comparison ownership: one user, targets t0, t0 + kTargetRows, ...
  const int cu = tid % kUsers;
  const int t0 = tid / kUsers;
  const int b = b0 + cu;
  float ts[MAXP];
  int count[MAXP];
  int target_id[COUNTS ? MAXP : 1];
  int equal[COUNTS ? MAXP : 1];
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    const int t = t0 + kTargetRows * k;
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
    auto item_at = [&](int r, int d) { return si[d * kIS + ti + 16 * r]; };
    auto bias_at = [&](int r) { return sb[ti + 16 * r]; };
    if constexpr (MAXM == 0) {
      score_block<4, RU>(
          acc, D, item_at,
          [&](int c, int d) { return su[d * kUS + tu + 16 * c]; }, bias_at);
    } else {
      mixture_score_block<4, RU, MAXM>(
          acc, mixtures, D, item_at,
          [&](int c, int k, int d) {
            return su[(k * D + d) * kUS + tu + 16 * c];
          },
          bias_at);
    }
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
    const int t = t0 + kTargetRows * k;
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

size_t rank_smem_bytes(int D, int mixtures) {
  const bool mixture = mixtures > 0;
  const int users = 16 * users_per_thread(mixture);
  const size_t K = mixture ? 2 * (size_t)mixtures * D : (size_t)D;
  return sizeof(float) * (K * (users + 1) + (size_t)D * kIS +
                          (size_t)kItems * (users + 1) + kItems);
}

template <typename Item, int MAXP, int RU, int MAXM, bool COUNTS>
int launch_rank(const float* users, const void* items, const float* bias,
                const float* tscores, const int* tids, int* out_a,
                int* out_b, int B, int N, int D, int T, int mixtures,
                int splits, cudaStream_t stream) {
  const size_t smem = rank_smem_bytes(D, mixtures);
  auto kernel = rank_weights_kernel<Item, MAXP, RU, MAXM, COUNTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (N + kItems - 1) / kItems;
  const int per_split = (num_tiles + splits - 1) / splits;
  const int used_splits = (num_tiles + per_split - 1) / per_split;
  constexpr int kUsers = block_users<RU>();
  dim3 grid((B + kUsers - 1) / kUsers, used_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      users, static_cast<const Item*>(items), bias, tscores, tids, out_a,
      out_b, B, N, D, T, mixtures, per_split);
  return cudaGetLastError();
}

template <typename Item>
int dispatch_rank(const float* users, const void* items, const float* bias,
                  const float* tscores, int* half_units, int B, int N, int D,
                  int T, int mixtures, int splits, cudaStream_t stream) {
#define SPOTLIGHT_RANK(MAXP, RU, MAXM)                                      \
  return launch_rank<Item, MAXP, RU, MAXM, false>(                          \
      users, items, bias, tscores, nullptr, half_units, nullptr, B, N, D, T, \
      mixtures, splits, stream)
  if (mixtures == 0) {
    constexpr int rows = kThreads / block_users<4>();
    if (T <= 1 * rows) SPOTLIGHT_RANK(1, 4, 0);
    if (T <= 2 * rows) SPOTLIGHT_RANK(2, 4, 0);
    if (T <= 8 * rows) SPOTLIGHT_RANK(8, 4, 0);
    if (T <= 32 * rows) SPOTLIGHT_RANK(32, 4, 0);
    return cudaErrorInvalidValue;
  }
  constexpr int rows = kThreads / block_users<2>();
  if (mixtures <= 4) {
    if (T <= 1 * rows) SPOTLIGHT_RANK(1, 2, 4);
    if (T <= 4 * rows) SPOTLIGHT_RANK(4, 2, 4);
    return cudaErrorInvalidValue;
  }
  if (mixtures <= kMaxMixtures) {
    if (T <= 1 * rows) SPOTLIGHT_RANK(1, 2, kMaxMixtures);
    if (T <= 4 * rows) SPOTLIGHT_RANK(4, 2, kMaxMixtures);
  }
  return cudaErrorInvalidValue;
#undef SPOTLIGHT_RANK
}

// K5: at most 8 targets a thread (32 a launch), since each carries a
// score, an id and two counters in registers.
template <typename Item>
int dispatch_counts(const float* users, const void* items, const float* bias,
                    const float* tscores, const int* tids, int* greater,
                    int* equal, int B, int N, int D, int T, int mixtures,
                    int splits, cudaStream_t stream) {
#define SPOTLIGHT_COUNTS(MAXP, RU, MAXM)                                     \
  return launch_rank<Item, MAXP, RU, MAXM, true>(                            \
      users, items, bias, tscores, tids, greater, equal, B, N, D, T,         \
      mixtures, splits, stream)
  if (mixtures == 0) {
    constexpr int rows = kThreads / block_users<4>();
    if (T <= 1 * rows) SPOTLIGHT_COUNTS(1, 4, 0);
    if (T <= 2 * rows) SPOTLIGHT_COUNTS(2, 4, 0);
    if (T <= 8 * rows) SPOTLIGHT_COUNTS(8, 4, 0);
    return cudaErrorInvalidValue;
  }
  constexpr int rows = kThreads / block_users<2>();
  if (mixtures <= 4) {
    if (T <= 1 * rows) SPOTLIGHT_COUNTS(1, 2, 4);
    if (T <= 4 * rows) SPOTLIGHT_COUNTS(4, 2, 4);
    return cudaErrorInvalidValue;
  }
  if (mixtures <= kMaxMixtures) {
    if (T <= 1 * rows) SPOTLIGHT_COUNTS(1, 2, kMaxMixtures);
    if (T <= 4 * rows) SPOTLIGHT_COUNTS(4, 2, kMaxMixtures);
  }
  return cudaErrorInvalidValue;
#undef SPOTLIGHT_COUNTS
}

}  // namespace

extern "C" {

// Widest target block one launch takes; the wrapper chunks wider ones.
int spotlight_rank_max_targets(int mixtures) {
  return mixtures > 0 ? 4 * (kThreads / block_users<2>())
                      : 32 * (kThreads / block_users<4>());
}

// Widest target block one K5 launch takes; the wrapper chunks wider ones.
int spotlight_rank_counts_max_targets(int mixtures) {
  return mixtures > 0 ? 4 * (kThreads / block_users<2>())
                      : 8 * (kThreads / block_users<4>());
}

// Users per block of the rank kernel.
int spotlight_rank_block_users(int mixtures) {
  return 16 * users_per_thread(mixtures > 0);
}

size_t spotlight_rank_smem_bytes(int D, int mixtures) {
  return rank_smem_bytes(D, mixtures);
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
    return dispatch_rank<__nv_bfloat16>(users, items, bias, tscores,
                                        half_units, B, N, D, T, mixtures,
                                        splits, s);
  return dispatch_rank<float>(users, items, bias, tscores, half_units, B, N,
                              D, T, mixtures, splits, s);
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
    return dispatch_counts<__nv_bfloat16>(users, items, bias, tscores, tids,
                                          greater, equal, B, N, D, T,
                                          mixtures, splits, s);
  return dispatch_counts<float>(users, items, bias, tscores, tids, greater,
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
