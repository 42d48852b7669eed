// Streaming rank weights (K1) and matched target scores (K1c).
//
// Replaces: spotlight_tpu/ops/kernels/ranking.py, _rank_weight_kernel (the
// Pallas kernel behind rank_weights) and the MXU arithmetic of
// matched_target_scores.
//
// What it computes: for every user b and target t,
//     half_units[b, t] = 2 * count(score > ts[b, t]) + count(score == ts[b, t])
// over the whole catalogue, the target itself included (its exact self-tie
// adds 1 half unit), where score = item . user + item_bias comes from
// score_block (common.cuh).  The wrapper returns half_units * 0.5.
//
// What bounds it on an H100: arithmetic.  At B = 2048 users, N = 200K items,
// D = 64 the catalogue pass is 2 * B * N * D = 5.2e10 float32 operations
// against a 51 MB read of the item table, about 1,000 operations per byte.
// The exact-tie contract forbids the tensor cores (TF32 rounds the
// operands) and FMA contraction, so every multiply and every add is its own
// instruction on the float32 CUDA cores.
//
// What the design does about it: each block keeps 64 users resident in
// shared memory and walks its own contiguous split of the catalogue in
// 64-item tiles staged through shared memory (transposed, padded against
// bank conflicts).  Each thread scores a 4 x 4 block of (item, user) pairs,
// so every shared load feeds four multiply-adds.  The tile's scores go to
// shared memory; each thread then owns one user and up to MAXP targets and
// compares the tile against them from registers.  Counts are int32 half
// units: exact and independent of order, so the splits add their counts
// with atomicAdd in any order.  The TPU kernel's grid ran in sequence and
// accumulated in VMEM; here the splits run in parallel.
#include "common.cuh"

using namespace spotlight;

namespace {

constexpr int kThreads = 256;
constexpr int kUsers = 64;           // users per block
constexpr int kItems = 64;           // items per tile
constexpr int kUS = kUsers + 1;      // padded strides of the shared tiles
constexpr int kIS = kItems + 1;
constexpr int kTargetRows = kThreads / kUsers;  // 4 target rows per pass

template <typename Item, int MAXP>
__global__ void __launch_bounds__(kThreads)
rank_weights_kernel(const float* __restrict__ users,
                    const Item* __restrict__ items,
                    const float* __restrict__ bias,
                    const float* __restrict__ tscores,
                    int* __restrict__ half_units, int B, int N, int D, int T,
                    int tiles_per_split) {
  extern __shared__ float smem[];
  float* su = smem;               // [D][kUS]   resident users
  float* si = su + D * kUS;       // [D][kIS]   item tile
  float* ss = si + D * kIS;       // [kItems][kUS] tile scores
  float* sb = ss + kItems * kUS;  // [kItems]   tile biases

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kUsers;
  stage_transposed(su, users, b0, kUsers, B, D, kUS);

  // Comparison ownership: one user, targets t0, t0 + 4, t0 + 8, ...
  const int cu = tid % kUsers;
  const int t0 = tid / kUsers;
  const int b = b0 + cu;
  float ts[MAXP];
  int count[MAXP];
#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    const int t = t0 + kTargetRows * k;
    ts[k] = (b < B && t < T) ? tscores[(long long)b * T + t] : 0.0f;
    count[k] = 0;
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

    float acc[4][4];
    score_block<4, 4>(
        acc, D,
        [&](int r, int d) { return si[d * kIS + ti + 16 * r]; },
        [&](int c, int d) { return su[d * kUS + tu + 16 * c]; },
        [&](int r) { return sb[ti + 16 * r]; });
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ss[(ti + 16 * r) * kUS + tu + 16 * c] = acc[r][c];
    __syncthreads();

    // Rows past the catalogue end never count.
    const int valid = min(kItems, N - row0);
    for (int i = 0; i < valid; ++i) {
      const float s = ss[i * kUS + cu];
#pragma unroll
      for (int k = 0; k < MAXP; ++k)
        count[k] += 2 * (s > ts[k]) + (s == ts[k]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < MAXP; ++k) {
    const int t = t0 + kTargetRows * k;
    if (b < B && t < T && count[k] != 0)
      atomicAdd(&half_units[(long long)b * T + t], count[k]);
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

size_t rank_smem_bytes(int D) {
  return sizeof(float) *
         ((size_t)D * kUS + (size_t)D * kIS + kItems * kUS + kItems);
}

template <typename Item, int MAXP>
int launch_rank(const float* users, const void* items, const float* bias,
                const float* tscores, int* half_units, int B, int N, int D,
                int T, int splits, cudaStream_t stream) {
  const size_t smem = rank_smem_bytes(D);
  auto kernel = rank_weights_kernel<Item, MAXP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (N + kItems - 1) / kItems;
  const int per_split = (num_tiles + splits - 1) / splits;
  const int used_splits = (num_tiles + per_split - 1) / per_split;
  dim3 grid((B + kUsers - 1) / kUsers, used_splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      users, static_cast<const Item*>(items), bias, tscores, half_units, B, N, D,
      T, per_split);
  return cudaGetLastError();
}

template <typename Item>
int dispatch_rank(const float* users, const void* items, const float* bias,
                  const float* tscores, int* half_units, int B, int N, int D,
                  int T, int splits, cudaStream_t stream) {
  if (T <= 1 * kTargetRows)
    return launch_rank<Item, 1>(users, items, bias, tscores, half_units, B, N,
                             D, T, splits, stream);
  if (T <= 2 * kTargetRows)
    return launch_rank<Item, 2>(users, items, bias, tscores, half_units, B, N,
                             D, T, splits, stream);
  if (T <= 8 * kTargetRows)
    return launch_rank<Item, 8>(users, items, bias, tscores, half_units, B, N,
                             D, T, splits, stream);
  if (T <= 32 * kTargetRows)
    return launch_rank<Item, 32>(users, items, bias, tscores, half_units, B, N,
                              D, T, splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Widest target block one launch takes; the wrapper chunks wider ones.
int spotlight_rank_max_targets() { return 32 * kTargetRows; }

size_t spotlight_rank_smem_bytes(int D) { return rank_smem_bytes(D); }

// half_units (B, T) int32 must be zeroed by the caller.  Returns a
// cudaError_t (0 on success).
int spotlight_rank_weights(const float* users, const void* items,
                           int items_bf16, const float* bias,
                           const float* tscores, int* half_units, int B,
                           int N, int D, int T, int splits, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || T <= 0 || splits <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (items_bf16)
    return dispatch_rank<__nv_bfloat16>(users, items, bias, tscores,
                                        half_units, B, N, D, T, splits, s);
  return dispatch_rank<float>(users, items, bias, tscores, half_units, B, N,
                              D, T, splits, s);
}

// out (B, T) float32 = score of item ids[b, t] for user b.
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

}  // extern "C"
