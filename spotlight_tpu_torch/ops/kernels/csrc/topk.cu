// Streaming top-k over the catalogue (K2, dot and mixture scoring).
//
// Replaces: spotlight_tpu/ops/kernels/topk.py, _topk_kernel (the Pallas
// kernel behind streaming_topk, with the default dot score_fn and with
// make_mixture_score_fn).
//
// What it computes: per user, the k best items in the order (score
// descending, id ascending), the order of lax.top_k, without materialising
// the (B, N) score matrix.  Items at or before a per-user resume key
// (resume_score, resume_id) in that order are skipped, so the wrapper can
// fetch a wide top-k in rounds.  Scores are bit-identical to the plain
// PyTorch version's, the sign of a zero included: every score comes from
// dot_tile_accumulate, then the bias (dots) or mixture_combine (mixtures)
// in registers (common.cuh), the exact-tie contract's order, so a K2 score
// has the bits of the rank pass's (K1, K5) and of K1c's or K4's.
//
// What bounds it on an H100: the float32 catalogue scoring, 2 * B * N * K
// operations with K the user width (D for dots, 2 M D for a mixture of M
// tastes).  The contract bars FMA, so each multiply and each add is its own
// instruction: the floor is 2 * B * N * K instructions over 132 SMs x 128
// lanes x ~1.98 GHz, about 33.5e12 a second, half the 67 TFLOP/s the data
// sheet counts with FMA.  Selection adds about k * ln(N / k) list updates
// per user and split over a randomly ordered catalogue, not N.
//
// Keys: each kept item is one 64-bit key, the order-preserving bits of the
// score in the high word (-0.0 made +0.0 first, since == treats them as a
// tie), and in the low word the inverted id shifted up by one over a bit
// that records a -0.0 score, so that one unsigned comparison is the
// (score desc, id asc) order and the score comes back with its sign.  Per
// user, stage 1 keeps a sorted list of its best k keys so far and a
// candidate buffer behind it in shared memory.  A key joins the buffer only
// if it beats the list's last key as of the last merge.  Buffers merge into
// lists when some buffer could overflow on the next tile, and once at the
// end: a warp per row with candidates sorts list and buffer in its
// registers (bitonic, through shuffles).  Stage 2 runs one block per user
// and sorts the S split lists in shared memory.  The TPU kernel walked its
// grid in order with one running list; here the catalogue splits run in
// parallel and meet in stage 2.
//
// Stage 1 (topk_stage1<T, KP, MP>), one block per (users, catalogue split),
// one block an SM, is the rank pass's block (RankShape, common.cuh) with
// its counting replaced by a filter:
// - scoring is register-tiled: the block's users stay resident in shared
//   memory for the whole split, items stream through in 128-item tiles, 32
//   dimensions a slab, double-buffered through registers (SlabStage), and
//   each thread scores 4 items with one dot_tile_accumulate call a slab:
//   with dot scoring (MP = 0) against 4 users of one column each, from two
//   float4 shared loads a dimension; with mixtures against one user's 2 MP
//   adjacent columns (tastes, then attentions; M rounded up to 2, 4 or 8,
//   zero columns past M), then mixture_combine turns each item's 2M dots
//   into its score in registers;
// - the filter runs in registers on the thread's own scores: a float
//   compare against its user's threshold score rejects almost every item,
//   then the resume test and the key compare, and an atomicAdd into the
//   user's buffer; the overflow flag rides on the slab's barrier
//   (__syncthreads_or);
// - the split's first tile is merged at once (warm start), so thresholds
//   are real k-th keys from the second tile on;
// - rows of 256 keys at KP <= 64 and 512 above (list and buffer, the buffer
//   at least 64 keys more than a tile); a block holds 64 dot users at
//   KP <= 64 and 32 above (512 and 256 threads), or 16 mixture users (512
//   threads), so that the rows, the users' columns and the slabs fit the
//   227 KB a block may use.
#include "common.cuh"

using namespace spotlight;

namespace {

typedef unsigned long long u64;

constexpr int kStage2Threads = 1024;

__device__ __forceinline__ uint32_t ordered_bits(float s) {
  s = (s == 0.0f) ? 0.0f : s;  // -0.0 and +0.0 tie
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Ids are below 2^31, so the inverted id fits 31 bits; bit 0 marks -0.0.
// Two keys of one score differ in their ids before that bit.
__device__ __forceinline__ u64 make_key(float s, int id) {
  const uint32_t negative_zero = s == 0.0f ? __float_as_uint(s) >> 31 : 0u;
  const uint32_t low = ((~(uint32_t)id & 0x7fffffffu) << 1) | negative_zero;
  return ((u64)ordered_bits(s) << 32) | (u64)low;
}

// The score of a key.  Key 0 (an empty slot, below every real key) reads
// as a NaN, which no score compares below.
__device__ __forceinline__ float key_score(u64 key) {
  return (key & 1u) ? -0.0f : from_ordered((uint32_t)(key >> 32));
}

__device__ __forceinline__ int key_id(u64 key) {
  return (int)(~((uint32_t)key >> 1) & 0x7fffffffu);
}

// Bitonic sort, descending, of len keys (a power of two) in shared
// memory.  All threads of the block take part and leave synchronised.
__device__ __forceinline__ void bitonic_desc(u64* keys, int len) {
  const int half = len / 2;
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      for (int j = threadIdx.x; j < half; j += blockDim.x) {
        const int i = 2 * j - (j & (stride - 1));
        const u64 a = keys[i];
        const u64 c = keys[i + stride];
        const bool desc = (i & size) == 0;
        if (desc ? (a < c) : (a > c)) {
          keys[i] = c;
          keys[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Bitonic sort, descending, of LEN keys held by one warp in registers: key
// i = E lane + e is v[e], E = LEN / 32.  Exchanges of keys closer than E
// stay in registers, the rest go through shuffles (15 of the 45 steps at
// LEN = 512); nothing touches shared memory.
template <int LEN>
__device__ __forceinline__ void warp_sort_desc(u64 (&v)[LEN / 32],
                                               int lane) {
  constexpr int E = LEN / 32;
#pragma unroll
  for (int size = 2; size <= LEN; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool desc = ((E * lane + e) & size) == 0;
        if (stride < E) {
          const int f = e ^ stride;
          if (f < e) continue;
          const u64 a = v[e];
          const u64 b = v[f];
          const bool swap = desc ? a < b : a > b;
          v[e] = swap ? b : a;
          v[f] = swap ? a : b;
        } else {
          const int mask = stride / E;
          const u64 p = __shfl_xor_sync(0xffffffffu, v[e], mask);
          // The lower index of a pair keeps the larger key in a
          // descending run.
          const bool keep_max = ((lane & mask) == 0) == desc;
          v[e] = keep_max ? max(v[e], p) : min(v[e], p);
        }
      }
    }
  }
}

// Sorts each of USERS rows of LEN keys (its list, then its buffered
// candidates; rows without candidates are left alone), keeps the first
// `keep`, empties the rest and moves each threshold up to the new
// keep-th key.  One warp sorts a row in its registers, so rows go in
// parallel with no block barrier and no shared-memory round trip between
// the sort's steps.  All threads take part and leave synchronised.
template <int USERS, int LEN>
__device__ __forceinline__ void merge_candidates(u64* keys, u64* thr,
                                                 int* cand, int keep) {
  constexpr int E = LEN / 32;
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < USERS; g += blockDim.x >> 5) {
    if (cand[g] == 0) continue;
    u64* row = keys + g * LEN;
    u64 v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = row[E * lane + e];
    warp_sort_desc<LEN>(v, lane);
#pragma unroll
    for (int e = 0; e < E; ++e)
      row[E * lane + e] = E * lane + e < keep ? v[e] : 0;
    __syncwarp();
    if (lane == 0) {
      thr[g] = row[keep - 1];
      cand[g] = 0;
    }
  }
  __syncthreads();
}

// Writes each live user's KP best keys of this split to partial.
template <int USERS, int LEN, int KP>
__device__ __forceinline__ void write_lists(const u64* keys, int b0, int B,
                                            int splits, u64* partial) {
  for (int e = threadIdx.x; e < USERS * KP; e += blockDim.x) {
    const int g = e / KP;
    const int j = e - g * KP;
    if (b0 + g < B)
      partial[((long long)(b0 + g) * splits + blockIdx.y) * KP + j] =
          keys[g * LEN + j];
  }
}

// ---- stage 1 ---------------------------------------------------------------

// The block of a stage 1 at list width KP with MP mixture components (0:
// dot scoring): the rank pass's 16 user slots, 8 for dot lists past 64 keys.
template <int KP, int MP>
using Stage1Shape = RankShape<MP, (MP == 0 && KP > 64) ? 8 : 16>;

// Keys per user row: the list (k <= KP keys) and a buffer of at least
// 128 + 64 keys (a tile and more), a power of two for the warp sort.
template <int KP>
__host__ __device__ constexpr int row_len() {
  return KP <= 64 ? 256 : 512;
}

// Shared memory of a stage-1 block: the key rows, thresholds and candidate
// counts, the resident users and two item slabs.
template <int KP, int MP>
size_t stage1_smem_bytes(int D) {
  using S = Stage1Shape<KP, MP>;
  return sizeof(u64) * ((size_t)S::kUsers * row_len<KP>() + S::kUsers) +
         sizeof(int) * S::kUsers +
         sizeof(float) * ((size_t)D * S::kUserStride + 2 * S::kSlab);
}

template <typename T, int KP, int MP>
__global__ void __launch_bounds__(Stage1Shape<KP, MP>::kThreads, 1)
topk_stage1(const float* __restrict__ users, const T* __restrict__ items,
            const float* __restrict__ bias,
            const float* __restrict__ resume_scores,
            const int* __restrict__ resume_ids, int B, int N, int D,
            int mixtures, int keep, int tiles_per_split, int splits,
            u64* __restrict__ partial) {
  using S = Stage1Shape<KP, MP>;
  constexpr int U = S::kUsers;
  constexpr int L = row_len<KP>();
  constexpr int kT = S::kThreads;
  constexpr int RI = S::kRI;
  constexpr int RU = S::kRU;
  constexpr int UPT = S::kUPT;
  constexpr int US = S::kUserStride;
  constexpr int TI = S::kItems;

  extern __shared__ __align__(16) unsigned char stage1_smem[];
  u64* keys = reinterpret_cast<u64*>(stage1_smem);  // [U][L]
  u64* thr = keys + U * L;                        // [U] keep-th key, last merge
  int* cand = reinterpret_cast<int*>(thr + U);    // [U] buffered candidates
  float* su = reinterpret_cast<float*>(cand + U);  // [D][US] resident users
  float* si = su + D * US;                        // [2][kSlabDepth][kIS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * U;
  for (int e = tid; e < U * L; e += kT) keys[e] = 0;
  for (int e = tid; e < U; e += kT) {
    thr[e] = 0;
    cand[e] = 0;
  }
  stage_users<S>(su, users, b0, B, D, mixtures);

  // Scoring ownership: items 4 ig + r, user slot ug (users UPT ug + c); a
  // warp covers 4 item groups x 8 user slots, so its float4 reads of a
  // dimension touch 64 contiguous bytes of items and 8 slots of users.
  const int ug = (warp % S::kUserWarps) * 8 + (lane >> 2);
  const int ig = (warp / S::kUserWarps) * 4 + (lane & 3);

  const bool resume = resume_scores != nullptr;
  bool live[UPT];
  float thr_score[UPT];
  u64 thr_key[UPT];
#pragma unroll
  for (int c = 0; c < UPT; ++c) {
    live[c] = b0 + UPT * ug + c < B;
    thr_key[c] = 0;
    thr_score[c] = key_score(0);
  }

  const int num_tiles = (N + TI - 1) / TI;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(num_tiles, tile_begin + tiles_per_split);
  const int slabs = (D + kSlabDepth - 1) / kSlabDepth;

  SlabStage<T, S> stage;
  stage.load(items, tile_begin, 0, N, D);
  stage.store(si);
  __syncthreads();

  // Registers are tight at MP = 8 (64 accumulators a thread), so nothing
  // is held longer than it must be: acc enters each tile holding -0.0
  // (dot_tile_accumulate's start) and is reset after the tile's filter and
  // merge, the next slab is stored before the filter, the item biases are
  // loaded after the tile's last slab is scored, and the resume keys are
  // read only for a score that passes its threshold.
  float acc[RI][RU];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RU; ++c) acc[r][c] = -0.0f;
  int tile = tile_begin, slab = 0, buf = 0;
  for (;;) {
    int next_tile = tile, next_slab = slab + 1;
    if (next_slab == slabs) {
      next_slab = 0;
      ++next_tile;
    }
    const bool more = next_tile < tile_end;
    const bool last = slab == slabs - 1;
    if (more) stage.load(items, next_tile, next_slab, N, D);

    const int row0 = tile * TI;
    const int d0 = slab * kSlabDepth;
    const float* slab_items = si + buf * S::kSlab + 4 * ig;
    const float* slab_users = su + d0 * US + RU * ug;
    if (D - d0 >= kSlabDepth)  // a full slab: a constant trip count
      dot_tile_accumulate<RI, RU>(acc, kSlabDepth, slab_items,
                                  S::kItemStride, 0, slab_users, US, 4);
    else
      dot_tile_accumulate<RI, RU>(acc, D - d0, slab_items, S::kItemStride,
                                  0, slab_users, US, 4);
    // The other buffer was last read before the previous barrier.
    if (more) stage.store(si + (buf ^ 1) * S::kSlab);

    if (last) {
      float item_bias[RI];
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const int id = row0 + 4 * ig + r;
        item_bias[r] = id < N ? bias[id] : 0.0f;
      }
      // The filter: append each key above its user's threshold to the
      // user's buffer, the L - keep slots behind its list.  A buffer
      // holds at most L - keep - TI keys before a tile, so one tile
      // cannot overflow it; a buffer that passes that mark asks for a
      // merge.
      int merge = tile == tile_begin;  // warm start
#pragma unroll
      for (int c = 0; c < UPT; ++c) {
        if (!live[c]) continue;
        const int u = UPT * ug + c;
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const int id = row0 + 4 * ig + r;
          float s;
          if constexpr (MP == 0)
            s = __fadd_rn(acc[r][c], item_bias[r]);
          else
            s = mixture_combine<MP>(acc[r], mixtures, item_bias[r]);
          // s below the threshold's score means its key is below too.
          if (id >= N || s < thr_score[c]) continue;
          if (resume) {  // read here, on the rare path, not held
            const float rs = resume_scores[b0 + u];
            if (s > rs || (s == rs && id <= resume_ids[b0 + u])) continue;
          }
          const u64 key = make_key(s, id);
          if (key <= thr_key[c]) continue;
          const int pos = atomicAdd(&cand[u], 1);
          keys[u * L + keep + pos] = key;
          merge |= pos >= L - keep - TI;
        }
      }
      // The slab's barrier, which also tells every thread whether some
      // buffer asks for a merge.
      if (__syncthreads_or(merge)) {
        merge_candidates<U, L>(keys, thr, cand, keep);
#pragma unroll
        for (int c = 0; c < UPT; ++c) {
          thr_key[c] = thr[UPT * ug + c];
          thr_score[c] = key_score(thr_key[c]);
        }
      }
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RU; ++c) acc[r][c] = -0.0f;
    } else {
      __syncthreads();
    }
    if (!more) break;
    tile = next_tile;
    slab = next_slab;
    buf ^= 1;
  }
  merge_candidates<U, L>(keys, thr, cand, keep);
  write_lists<U, L, KP>(keys, b0, B, splits, partial);
}

// ---- stage 2 and the launches ---------------------------------------------

__global__ void __launch_bounds__(kStage2Threads)
topk_stage2(const u64* __restrict__ partial, int n, int len, int k,
            float* __restrict__ out_scores, int* __restrict__ out_ids) {
  extern __shared__ u64 sk[];  // [len], len = n rounded up to a power of 2
  const long long b = blockIdx.x;
  for (int e = threadIdx.x; e < len; e += blockDim.x)
    sk[e] = e < n ? partial[b * n + e] : 0;
  __syncthreads();
  bitonic_desc(sk, len);
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const u64 key = sk[j];
    out_scores[b * k + j] = key_score(key);
    out_ids[b * k + j] = key_id(key);
  }
}

// Stage 2 over `used` split lists of KP keys per user; a block has one
// thread per compare-exchange of the sort, at most kStage2Threads.
int launch_stage2(const u64* partial, int B, int used, int kp, int k,
                  float* out_scores, int* out_ids, cudaStream_t stream) {
  const int n = used * kp;
  int len = 1;
  while (len < n) len <<= 1;
  const size_t smem = sizeof(u64) * (size_t)len;
  cudaError_t err = cudaFuncSetAttribute(
      topk_stage2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = max(32, min(kStage2Threads, len / 2));
  topk_stage2<<<B, threads, smem, stream>>>(partial, n, len, k, out_scores,
                                            out_ids);
  return cudaGetLastError();
}

// Splits actually used: `splits` rounded to whole tiles per split.
int split_tiles(int num_tiles, int splits) {
  return (num_tiles + splits - 1) / splits;
}

template <typename T, int KP, int MP>
int launch_stage1(const float* users, const void* items, const float* bias,
                  const float* resume_scores, const int* resume_ids, int B,
                  int N, int D, int mixtures, int k, int splits,
                  u64* partial, float* out_scores, int* out_ids,
                  cudaStream_t stream) {
  using S = Stage1Shape<KP, MP>;
  const size_t smem = stage1_smem_bytes<KP, MP>(D);
  auto stage1 = topk_stage1<T, KP, MP>;
  cudaError_t err = cudaFuncSetAttribute(
      stage1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (N + S::kItems - 1) / S::kItems;
  const int per_split = split_tiles(num_tiles, splits);
  const int used = (num_tiles + per_split - 1) / per_split;
  dim3 grid((B + S::kUsers - 1) / S::kUsers, used);
  stage1<<<grid, S::kThreads, smem, stream>>>(
      users, static_cast<const T*>(items), bias, resume_scores, resume_ids, B,
      N, D, mixtures, k, per_split, used, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stage2(partial, B, used, KP, k, out_scores, out_ids, stream);
}

template <typename T, int KP>
int launch_topk(const float* users, const void* items, const float* bias,
                const float* rs, const int* ri, int B, int N, int D,
                int mixtures, int k, int splits, u64* partial, float* os,
                int* oi, cudaStream_t s) {
  return with_shape(mixtures, [&](auto mp) {
    return launch_stage1<T, KP, decltype(mp)::value>(
        users, items, bias, rs, ri, B, N, D, mixtures, k, splits, partial,
        os, oi, s);
  });
}

template <typename T>
int dispatch_kp(int kp, const float* users, const void* items,
                const float* bias, const float* rs, const int* ri, int B,
                int N, int D, int mixtures, int k, int splits, u64* partial,
                float* os, int* oi, cudaStream_t s) {
#define SPOTLIGHT_TOPK(KP)                                                 \
  case KP:                                                                 \
    return launch_topk<T, KP>(users, items, bias, rs, ri, B, N, D,         \
                              mixtures, k, splits, partial, os, oi, s)
  switch (kp) {
    SPOTLIGHT_TOPK(16);
    SPOTLIGHT_TOPK(32);
    SPOTLIGHT_TOPK(64);
    SPOTLIGHT_TOPK(128);
    SPOTLIGHT_TOPK(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef SPOTLIGHT_TOPK
}

}  // namespace

extern "C" {

// Shared memory of a stage-1 block at list width kp (0: no such width).
size_t spotlight_topk_stage1_smem_bytes(int kp, int D, int mixtures) {
  return with_shape(mixtures, [&](auto mp) -> size_t {
    constexpr int MP = decltype(mp)::value;
    switch (kp) {
      case 16: return stage1_smem_bytes<16, MP>(D);
      case 32: return stage1_smem_bytes<32, MP>(D);
      case 64: return stage1_smem_bytes<64, MP>(D);
      case 128: return stage1_smem_bytes<128, MP>(D);
      case 256: return stage1_smem_bytes<256, MP>(D);
      default: return 0;
    }
  });
}

// Users per stage-1 block of a fetch at kp.
int spotlight_topk_block_users(int kp, int mixtures) {
  return with_shape(mixtures, [&](auto mp) {
    constexpr int MP = decltype(mp)::value;
    return kp <= 64 ? Stage1Shape<64, MP>::kUsers
                    : Stage1Shape<256, MP>::kUsers;
  });
}

// One top-k fetch: k <= kp, kp a power of two in [16, 256].  users are
// (B, D) for mixtures = 0 (dot scoring), else (B, 2 * mixtures * D).
// partial is scratch of B * splits * kp 64-bit keys; splits * kp must round
// up to at most 8192 keys (64 KB of stage-2 shared memory).  resume_scores
// and resume_ids are (B,) or both null.  Returns a cudaError_t.
int spotlight_streaming_topk(const float* users, const void* items,
                             int items_bf16, const float* bias,
                             const float* resume_scores,
                             const int* resume_ids, int B, int N, int D,
                             int mixtures, int k, int kp, int splits,
                             void* partial, float* out_scores, int* out_ids,
                             void* stream) {
  if (B <= 0 || N <= 0 || D <= 0 || k <= 0 || k > kp || k > N ||
      splits <= 0 || (long long)splits * kp > 8192 || mixtures < 0 ||
      mixtures > kMaxMixtures)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  u64* p = static_cast<u64*>(partial);
  if (items_bf16)
    return dispatch_kp<__nv_bfloat16>(kp, users, items, bias, resume_scores,
                                      resume_ids, B, N, D, mixtures, k,
                                      splits, p, out_scores, out_ids, s);
  return dispatch_kp<float>(kp, users, items, bias, resume_scores,
                            resume_ids, B, N, D, mixtures, k, splits, p,
                            out_scores, out_ids, s);
}

}  // extern "C"
