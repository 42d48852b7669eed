// Streaming top-k over the catalogue (K2).
//
// Replaces: spotlight_tpu/ops/kernels/topk.py, _topk_kernel (the Pallas
// kernel behind streaming_topk).
//
// What it computes: per user, the k best items in the order (score
// descending, id ascending), the order of lax.top_k, without materialising
// the (B, N) score matrix.  Items at or before a per-user resume key
// (resume_score, resume_id) in that order are skipped, so the wrapper can
// fetch a wide top-k in rounds.  Scores come from score_block (common.cuh),
// so they are bit-identical to the plain PyTorch version's.
//
// What bounds it on an H100: the same float32 catalogue scoring as the rank
// kernel (2 * B * N * D operations on the CUDA cores, no FMA contraction),
// plus the selection, whose cost follows the number of top-k updates
// (about k * ln(N / k) per user over a randomly ordered catalogue) rather
// than N.
//
// What the design does about it: stage 1 runs one block per (32 users,
// catalogue split).  The block scores 64-item tiles as the rank kernel does
// and keeps, per user, a sorted list of KP (k rounded up to a power of two)
// 64-bit keys in shared memory: the order-preserving bits of the score in
// the high word (-0.0 made +0.0 first, since == treats them as a tie), and
// the inverted id in the low word, so that one unsigned comparison is the
// (score desc, id asc) order.  Only a score whose key beats the user's
// KP-th key as of the last merge is appended to a candidate buffer behind
// the list.  A block-wide bitonic sort merges buffers and lists only when
// some user's buffer could overflow on the next tile, and once at the end:
// a merge per tile (sorting 32 rows of 2 KP keys whenever any one user had
// a candidate) cost more than the scoring, and at KP = 256 was measured no
// faster than sorting the materialised scores.  With the threshold rising
// as k * ln(n / k) updates arrive, most tiles cost their scoring and one
// comparison per pair.  Stage 2 runs one block
// per user and merges the S split lists with the same bitonic sort.  The
// TPU kernel walked its grid in order with one running list; here the
// splits run in parallel and meet in stage 2.
#include "common.cuh"

using namespace spotlight;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kUsers = 32;       // users per stage-1 block
constexpr int kItems = 64;       // items per tile
constexpr int kUS = kUsers + 1;
constexpr int kIS = kItems + 1;
constexpr int kRows = kThreads / kUsers;  // candidate rows checked per pass
constexpr int kStage2Threads = 1024;

__device__ __forceinline__ uint32_t ordered_bits(float s) {
  s = (s == 0.0f) ? 0.0f : s;  // -0.0 and +0.0 tie
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ u64 make_key(float s, int id) {
  return ((u64)ordered_bits(s) << 32) | (u64)(~(uint32_t)id);
}

// Bitonic sort, descending, of `groups` rows of `len` keys each (len a
// power of two); rows with skip(g) true are left alone.  All threads of
// the block take part and leave synchronised.
template <class Skip>
__device__ __forceinline__ void bitonic_desc(u64* keys, int groups, int len,
                                             Skip skip) {
  const int half = len / 2;
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < groups * half; p += blockDim.x) {
        const int g = p / half;
        if (skip(g)) continue;
        const int j = p - g * half;
        const int i = 2 * j - (j & (stride - 1));
        u64* row = keys + (long long)g * len;
        const u64 a = row[i];
        const u64 c = row[i + stride];
        const bool desc = (i & size) == 0;
        if (desc ? (a < c) : (a > c)) {
          row[i] = c;
          row[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Keys per user row in stage 1: the sorted list (KP) and a candidate
// buffer behind it; a power of two for the bitonic sort.  The buffer holds
// several tiles' candidates (at least 2 x kItems below KP = 256), so the
// threshold goes stale between merges but the merges stay rare.
template <int KP>
__host__ __device__ constexpr int row_len() {
  return KP >= 256 ? 2 * KP : (4 * KP > 128 ? 4 * KP : 128);
}

template <int KP>
size_t stage1_smem_bytes(int D) {
  return sizeof(u64) * ((size_t)kUsers * row_len<KP>() + kUsers) +
         sizeof(float) * ((size_t)D * kUS + (size_t)D * kIS + kItems * kUS +
                          kItems) +
         sizeof(int) * (kUsers + 1);
}

// Sorts each user's list and buffered candidates (rows without candidates
// are left alone), keeps the first KP, empties the buffers and moves each
// threshold up to the new KP-th key.  All threads take part and leave
// synchronised.
template <int KP>
__device__ __forceinline__ void merge_candidates(u64* keys, u64* thr,
                                                 int* cand, int* full) {
  constexpr int kLen = row_len<KP>();
  constexpr int kBuf = kLen - KP;
  if (threadIdx.x == 0) *full = 0;
  bitonic_desc(keys, kUsers, kLen, [&](int g) { return cand[g] == 0; });
  for (int e = threadIdx.x; e < kUsers * kBuf; e += blockDim.x) {
    const int g = e / kBuf;
    keys[g * kLen + KP + (e - g * kBuf)] = 0;
  }
  for (int g = threadIdx.x; g < kUsers; g += blockDim.x) {
    if (cand[g] != 0) thr[g] = keys[g * kLen + KP - 1];
    cand[g] = 0;
  }
  __syncthreads();
}

template <typename T, int KP>
__global__ void __launch_bounds__(kThreads)
topk_stage1(const float* __restrict__ users, const T* __restrict__ items,
            const float* __restrict__ bias,
            const float* __restrict__ resume_scores,
            const int* __restrict__ resume_ids, int B, int N, int D,
            int tiles_per_split, int splits, u64* __restrict__ partial) {
  constexpr int kLen = row_len<KP>();
  constexpr int kBuf = kLen - KP;
  extern __shared__ u64 smem64[];
  u64* keys = smem64;                       // [kUsers][kLen]
  u64* thr = keys + kUsers * kLen;          // [kUsers] KP-th key at last merge
  float* su = reinterpret_cast<float*>(thr + kUsers);  // [D][kUS]
  float* si = su + D * kUS;                 // [D][kIS]
  float* ss = si + D * kIS;                 // [kItems][kUS]
  float* sb = ss + kItems * kUS;            // [kItems]
  int* cand = reinterpret_cast<int*>(sb + kItems);     // [kUsers]
  int* full = cand + kUsers;                // [1] some buffer is nearly full

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kUsers;
  for (int e = tid; e < kUsers * kLen; e += kThreads) keys[e] = 0;
  for (int e = tid; e < kUsers; e += kThreads) {
    thr[e] = 0;
    cand[e] = 0;
  }
  if (tid == 0) *full = 0;
  stage_transposed(su, users, b0, kUsers, B, D, kUS);

  // Candidate ownership: one user, rows r0, r0 + 8, ... of each tile.
  const int cu = tid % kUsers;
  const int r0 = tid / kUsers;
  const int b = b0 + cu;
  const bool resume = resume_scores != nullptr && b < B;
  const float rs = resume ? resume_scores[b] : 0.0f;
  const int rid = resume ? resume_ids[b] : 0;
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

    float acc[4][2];
    score_block<4, 2>(
        acc, D,
        [&](int r, int d) { return si[d * kIS + ti + 16 * r]; },
        [&](int c, int d) { return su[d * kUS + tu + 16 * c]; },
        [&](int r) { return sb[ti + 16 * r]; });
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        ss[(ti + 16 * r) * kUS + tu + 16 * c] = acc[r][c];
    __syncthreads();

    // Append every key above the user's threshold to its buffer.  A
    // buffer holds at most kBuf - kItems keys before a tile, so the tile
    // cannot overflow it; one that passes that mark asks for a merge.
    if (b < B) {
      const int valid = min(kItems, N - row0);
      const u64 threshold = thr[cu];
      for (int i = r0; i < valid; i += kRows) {
        const float s = ss[i * kUS + cu];
        const int id = row0 + i;
        if (resume && (s > rs || (s == rs && id <= rid))) continue;
        const u64 key = make_key(s, id);
        if (key > threshold) {
          const int pos = atomicAdd(&cand[cu], 1);
          keys[cu * kLen + KP + pos] = key;
          if (pos >= kBuf - kItems) *full = 1;
        }
      }
    }
    __syncthreads();
    const int merge = *full;
    __syncthreads();
    if (merge) merge_candidates<KP>(keys, thr, cand, full);
  }
  merge_candidates<KP>(keys, thr, cand, full);

  for (int e = tid; e < kUsers * KP; e += kThreads) {
    const int g = e / KP;
    const int j = e - g * KP;
    if (b0 + g < B)
      partial[((long long)(b0 + g) * splits + blockIdx.y) * KP + j] =
          keys[g * kLen + j];
  }
}

__global__ void __launch_bounds__(kStage2Threads)
topk_stage2(const u64* __restrict__ partial, int n, int len, int k,
            float* __restrict__ out_scores, int* __restrict__ out_ids) {
  extern __shared__ u64 sk[];  // [len], len = n rounded up to a power of 2
  const long long b = blockIdx.x;
  for (int e = threadIdx.x; e < len; e += blockDim.x)
    sk[e] = e < n ? partial[b * n + e] : 0;
  __syncthreads();
  bitonic_desc(sk, 1, len, [](int) { return false; });
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const u64 key = sk[j];
    out_scores[b * k + j] = from_ordered((uint32_t)(key >> 32));
    out_ids[b * k + j] = (int)(~(uint32_t)key);
  }
}

template <typename T, int KP>
int launch_topk(const float* users, const void* items, const float* bias,
                const float* resume_scores, const int* resume_ids, int B,
                int N, int D, int k, int splits, u64* partial,
                float* out_scores, int* out_ids, cudaStream_t stream) {
  const size_t smem1 = stage1_smem_bytes<KP>(D);
  auto stage1 = topk_stage1<T, KP>;
  cudaError_t err = cudaFuncSetAttribute(
      stage1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  const int num_tiles = (N + kItems - 1) / kItems;
  const int per_split = (num_tiles + splits - 1) / splits;
  const int used = (num_tiles + per_split - 1) / per_split;
  dim3 grid1((B + kUsers - 1) / kUsers, used);
  stage1<<<grid1, kThreads, smem1, stream>>>(
      users, static_cast<const T*>(items), bias, resume_scores, resume_ids, B,
      N, D, per_split, used, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int n = used * KP;
  int len = 1;
  while (len < n) len <<= 1;
  const size_t smem2 = sizeof(u64) * (size_t)len;
  err = cudaFuncSetAttribute(topk_stage2,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  topk_stage2<<<B, kStage2Threads, smem2, stream>>>(partial, n, len, k,
                                                    out_scores, out_ids);
  return cudaGetLastError();
}

template <typename T>
int dispatch_topk(int kp, const float* users, const void* items,
                  const float* bias, const float* rs, const int* ri, int B,
                  int N, int D, int k, int splits, u64* partial, float* os,
                  int* oi, cudaStream_t s) {
  switch (kp) {
    case 16:
      return launch_topk<T, 16>(users, items, bias, rs, ri, B, N, D, k,
                                splits, partial, os, oi, s);
    case 32:
      return launch_topk<T, 32>(users, items, bias, rs, ri, B, N, D, k,
                                splits, partial, os, oi, s);
    case 64:
      return launch_topk<T, 64>(users, items, bias, rs, ri, B, N, D, k,
                                splits, partial, os, oi, s);
    case 128:
      return launch_topk<T, 128>(users, items, bias, rs, ri, B, N, D, k,
                                 splits, partial, os, oi, s);
    case 256:
      return launch_topk<T, 256>(users, items, bias, rs, ri, B, N, D, k,
                                 splits, partial, os, oi, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

size_t spotlight_topk_stage1_smem_bytes(int kp, int D) {
  switch (kp) {
    case 16: return stage1_smem_bytes<16>(D);
    case 32: return stage1_smem_bytes<32>(D);
    case 64: return stage1_smem_bytes<64>(D);
    case 128: return stage1_smem_bytes<128>(D);
    case 256: return stage1_smem_bytes<256>(D);
    default: return 0;
  }
}

// One top-k fetch: k <= kp, kp a power of two in [16, 256].  partial is
// scratch of B * splits * kp 64-bit keys; splits * kp must round up to at
// most 8192 keys (64 KB of stage-2 shared memory).  resume_scores and
// resume_ids are (B,) or both null.  Returns a cudaError_t.
int spotlight_streaming_topk(const float* users, const void* items,
                             int items_bf16, const float* bias,
                             const float* resume_scores,
                             const int* resume_ids, int B, int N, int D,
                             int k, int kp, int splits, void* partial,
                             float* out_scores, int* out_ids, void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || k <= 0 || k > kp || k > N ||
      splits <= 0 || (long long)splits * kp > 8192)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* p = static_cast<u64*>(partial);
  if (items_bf16)
    return dispatch_topk<__nv_bfloat16>(kp, users, items, bias,
                                        resume_scores, resume_ids, B, N, D,
                                        k, splits, p, out_scores, out_ids, s);
  return dispatch_topk<float>(kp, users, items, bias, resume_scores,
                              resume_ids, B, N, D, k, splits, p, out_scores,
                              out_ids, s);
}

}  // extern "C"
