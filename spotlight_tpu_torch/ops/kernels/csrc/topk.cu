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
// PyTorch version's, the sign of a zero included: dot scores come from
// dot_tile_accumulate, mixture scores from mixture_score_block
// (common.cuh), both in the exact-tie contract's order.
//
// What bounds it on an H100: the float32 catalogue scoring, 2 * B * N * D
// operations for dots (2M times that for mixtures).  The contract bars
// FMA, so each multiply and each add is its own instruction: the floor is
// 2 * B * N * D instructions over 132 SMs x 128 lanes x ~1.98 GHz, about
// 33.5e12 a second, half the 67 TFLOP/s the data sheet counts with FMA.
// Selection adds about k * ln(N / k) list updates per user and split over
// a randomly ordered catalogue, not N.
//
// Keys: each kept item is one 64-bit key, the order-preserving bits of the
// score in the high word (-0.0 made +0.0 first, since == treats them as a
// tie), and in the low word the inverted id shifted up by one over a bit
// that records a -0.0 score, so that one unsigned comparison is the
// (score desc, id asc) order and the score comes back with its sign.  Per
// user, stage 1 keeps a sorted list of its best keys so far (k of them in
// dot stage 1; KP, k rounded up to a power of two, in mixture stage 1)
// and a candidate buffer behind it in shared memory.  A key joins the
// buffer only if it beats the list's last key as of the last merge.
// Buffers merge into lists when some buffer could overflow on the next
// tile, and once at the end: a warp per row with candidates sorts list and
// buffer in its registers (bitonic, through shuffles).  Stage 2 runs one
// block per user and sorts the S split lists in shared memory.  The
// TPU kernel walked its grid in order with one running list; here the
// catalogue splits run in parallel and meet in stage 2.
//
// Dot stage 1 (topk_dot_stage1), one block per (U users, catalogue
// split), one block an SM:
// - scoring is register-tiled: each thread owns 4 items x 4 users and per
//   dimension reads them as two float4s from transposed shared tiles, so
//   the loop is bound by the float32 pipes rather than by shared-memory
//   issue; 512 threads (16 warps an SM) at U = 64, 256 at U = 32.  The
//   U users stay resident for the whole split; items stream through in
//   128-item tiles, 32 dimensions a slab, double-buffered through
//   registers: the next slab's global loads are issued before this slab
//   is scored and stored after it (cp.async cannot transpose the 2-byte
//   elements of a bf16 table, and one path serves both types);
// - the filter runs in registers on the thread's own scores: a float
//   compare against the user's threshold score rejects almost every item,
//   then the resume test and the key compare; the overflow flag rides on
//   the slab's barrier (__syncthreads_or);
// - the split's first tile is merged at once (warm start), so thresholds
//   are real k-th keys from the second tile on;
// - U = 64 users at KP <= 64 and 32 above, so that rows of 256 or 512
//   keys (list and buffer, the buffer at least 64 keys more than a tile)
//   and the tiles fit the 227 KB a block may use.
//
// Mixture stage 1 (topk_mixture_stage1): one block per (32 users, split)
// scores 64-item tiles with mixture_score_block (a block holds its users'
// 2M vectors each: 67 KB at M = 4, D = 64, beside 128 KB of keys at
// KP = 256) through a shared score tile, then filters and merges as above
// with a threshold that starts cold.
#include "common.cuh"

using namespace spotlight;

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kStage2Threads = 1024;

// Dot stage 1: items per tile, dimensions per staged slab, the padded row
// stride of a transposed slab (a multiple of 4 floats for float4 reads; 4
// mod 32 makes the staging stores conflict-free).
constexpr int kDotItems = 128;
constexpr int kDotDepth = 32;
constexpr int kDotStride = kDotItems + 4;

// Mixture stage 1: users per block, items per tile, padded strides.
constexpr int kMixUsers = 32;
constexpr int kMixItems = 64;
constexpr int kMixUS = kMixUsers + 1;
constexpr int kMixIS = kMixItems + 1;
constexpr int kMixRows = kThreads / kMixUsers;  // candidate rows per pass

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

// ---- dot stage 1 ----------------------------------------------------------

template <int KP>
__host__ __device__ constexpr int dot_users() {
  return KP <= 64 ? 64 : 32;
}

template <int KP>
__host__ __device__ constexpr int dot_threads() {
  return KP <= 64 ? 512 : 256;
}

// Keys per user row: the list (k <= KP keys) and a buffer of at least
// kDotItems + 64 keys, a power of two for the warp sort.
template <int KP>
__host__ __device__ constexpr int dot_row_len() {
  return KP <= 64 ? 256 : 512;
}

template <int KP>
size_t dot_smem_bytes(int D) {
  constexpr int U = dot_users<KP>();
  return sizeof(u64) * ((size_t)U * dot_row_len<KP>() + U) +
         sizeof(int) * U + sizeof(float) * ((size_t)D * U +
                                            2 * kDotDepth * kDotStride);
}

template <typename T, int KP>
__global__ void __launch_bounds__(dot_threads<KP>(), 1)
topk_dot_stage1(const float* __restrict__ users, const T* __restrict__ items,
                const float* __restrict__ bias,
                const float* __restrict__ resume_scores,
                const int* __restrict__ resume_ids, int B, int N, int D,
                int keep, int tiles_per_split, int splits,
                u64* __restrict__ partial) {
  constexpr int U = dot_users<KP>();
  constexpr int L = dot_row_len<KP>();
  constexpr int kT = dot_threads<KP>();
  constexpr int kWarps = kT / 32;
  constexpr int kLoads = kDotItems * kDotDepth / kT;  // slab loads a thread
  constexpr int RU = 4;
  constexpr int RI = kDotItems * U / (kT * RU);
  // Item r of a thread is (r / 4) * kItemGap + 4 * ig + r % 4: the two
  // float4s of an 8-item tile lie half a tile apart.
  constexpr int kItemGap = kDotItems * 4 / RI;
  constexpr int kUserWarps = U / RU / 8;  // warps across the user groups
  constexpr int kSlab = kDotDepth * kDotStride;
  static_assert((kDotItems / RI) * (U / RU) == kT, "one tile a block");

  extern __shared__ __align__(16) unsigned char dot_smem[];
  u64* keys = reinterpret_cast<u64*>(dot_smem);   // [U][L]
  u64* thr = keys + U * L;                        // [U] KP-th key, last merge
  int* cand = reinterpret_cast<int*>(thr + U);    // [U] buffered candidates
  float* su = reinterpret_cast<float*>(cand + U);  // [D][U]
  float* si = su + D * U;                         // [2][kDotDepth][kDotStride]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * U;
  for (int e = tid; e < U * L; e += kT) keys[e] = 0;
  for (int e = tid; e < U; e += kT) {
    thr[e] = 0;
    cand[e] = 0;
  }
  for (int e = tid; e < U * D; e += kT) {
    const int u = e / D;
    const int d = e - u * D;
    su[d * U + u] = b0 + u < B ? users[(long long)(b0 + u) * D + d] : 0.0f;
  }

  // Scoring ownership: a warp covers 4 item groups x 8 user groups, so its
  // float4 reads of a dimension touch 64 and 128 contiguous bytes.
  const int ug = (warp % kUserWarps) * 8 + (lane >> 2);
  const int ig = (warp / kUserWarps) * 4 + (lane & 3);
  // Staging ownership: dimension sd of rows sr + kWarps j; a warp loads
  // 32-byte runs of 4 rows and stores them to 32 distinct banks.
  const int sd = 8 * (warp & 3) + (lane >> 2);
  const int sr = 4 * (warp >> 2) + (lane & 3);

  const bool resume = resume_scores != nullptr;
  bool live[RU];
  float rs[RU], thr_score[RU];
  int rid[RU];
  u64 thr_key[RU];
#pragma unroll
  for (int c = 0; c < RU; ++c) {
    const int b = b0 + 4 * ug + c;
    live[c] = b < B;
    rs[c] = resume && live[c] ? resume_scores[b] : 0.0f;
    rid[c] = resume && live[c] ? resume_ids[b] : 0;
    thr_key[c] = 0;
    thr_score[c] = key_score(0);
  }

  const int num_tiles = (N + kDotItems - 1) / kDotItems;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(num_tiles, tile_begin + tiles_per_split);
  const int slabs = (D + kDotDepth - 1) / kDotDepth;

  T staged[kLoads];
  auto load_slab = [&](int tile, int slab) {
    const int d = slab * kDotDepth + sd;
    const long long row = (long long)tile * kDotItems + sr;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long r = row + kWarps * j;
      staged[j] = d < D && r < N ? items[r * D + d] : T(0.0f);
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
        const int id = row0 + (r >> 2) * kItemGap + 4 * ig + (r & 3);
        item_bias[r] = id < N ? bias[id] : 0.0f;
#pragma unroll
        for (int c = 0; c < RU; ++c) acc[r][c] = -0.0f;
      }
    }
    const int d0 = slab * kDotDepth;
    const float* slab_items = si + buf * kSlab + 4 * ig;
    const float* slab_users = su + d0 * U + 4 * ug;
    if (D - d0 >= kDotDepth)  // a full slab: a constant trip count
      dot_tile_accumulate<RI, RU>(acc, kDotDepth, slab_items, kDotStride,
                                  kItemGap, slab_users, U, 0);
    else
      dot_tile_accumulate<RI, RU>(acc, D - d0, slab_items, kDotStride,
                                  kItemGap, slab_users, U, 0);

    // The filter: append each key above its user's threshold to the
    // user's buffer, the L - keep slots behind its list.  A buffer holds
    // at most L - keep - kDotItems keys before a tile, so one tile cannot
    // overflow it; a buffer that passes that mark asks for a merge.
    int merge = 0;
    if (slab == slabs - 1) {
      merge = tile == tile_begin;  // warm start
#pragma unroll
      for (int c = 0; c < RU; ++c) {
        if (!live[c]) continue;
        const int u = 4 * ug + c;
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const int id = row0 + (r >> 2) * kItemGap + 4 * ig + (r & 3);
          const float s = __fadd_rn(acc[r][c], item_bias[r]);
          // s below the threshold's score means its key is below too.
          if (id >= N || s < thr_score[c]) continue;
          if (resume && (s > rs[c] || (s == rs[c] && id <= rid[c])))
            continue;
          const u64 key = make_key(s, id);
          if (key <= thr_key[c]) continue;
          const int pos = atomicAdd(&cand[u], 1);
          keys[u * L + keep + pos] = key;
          merge |= pos >= L - keep - kDotItems;
        }
      }
    }
    if (more) store_slab(si + (buf ^ 1) * kSlab);
    merge = __syncthreads_or(merge);
    if (merge) {
      merge_candidates<U, L>(keys, thr, cand, keep);
#pragma unroll
      for (int c = 0; c < RU; ++c) {
        thr_key[c] = thr[4 * ug + c];
        thr_score[c] = key_score(thr_key[c]);
      }
    }
    if (!more) break;
    tile = next_tile;
    slab = next_slab;
    buf ^= 1;
  }
  merge_candidates<U, L>(keys, thr, cand, keep);
  write_lists<U, L, KP>(keys, b0, B, splits, partial);
}

// ---- mixture stage 1 ------------------------------------------------------

// Keys per user row: the list (KP) and a buffer of several tiles'
// candidates (at least 2 x kMixItems below KP = 256), so the threshold
// goes stale between merges but the merges stay rare.
template <int KP>
__host__ __device__ constexpr int mix_row_len() {
  return KP >= 256 ? 2 * KP : (4 * KP > 128 ? 4 * KP : 128);
}

// K is the user operand's width, 2 * mixtures * D.
template <int KP>
size_t mix_smem_bytes(int D, int K) {
  return sizeof(u64) * ((size_t)kMixUsers * mix_row_len<KP>() + kMixUsers) +
         sizeof(float) * ((size_t)K * kMixUS + (size_t)D * kMixIS +
                          kMixItems * kMixUS + kMixItems) +
         sizeof(int) * (kMixUsers + 1);
}

// Mixtures of at most MAXM tastes.
template <typename T, int KP, int MAXM>
__global__ void __launch_bounds__(kThreads)
topk_mixture_stage1(const float* __restrict__ users,
                    const T* __restrict__ items,
                    const float* __restrict__ bias,
                    const float* __restrict__ resume_scores,
                    const int* __restrict__ resume_ids, int B, int N, int D,
                    int mixtures, int tiles_per_split, int splits,
                    u64* __restrict__ partial) {
  constexpr int kLen = mix_row_len<KP>();
  constexpr int kBuf = kLen - KP;
  const int K = 2 * mixtures * D;  // user operand width
  extern __shared__ u64 mix_smem[];
  u64* keys = mix_smem;                       // [kMixUsers][kLen]
  u64* thr = keys + kMixUsers * kLen;         // [kMixUsers] KP-th key
  float* su = reinterpret_cast<float*>(thr + kMixUsers);  // [K][kMixUS]
  float* si = su + K * kMixUS;                // [D][kMixIS]
  float* ss = si + D * kMixIS;                // [kMixItems][kMixUS]
  float* sb = ss + kMixItems * kMixUS;        // [kMixItems]
  int* cand = reinterpret_cast<int*>(sb + kMixItems);  // [kMixUsers]
  int* full = cand + kMixUsers;               // [1] some buffer nearly full

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * kMixUsers;
  for (int e = tid; e < kMixUsers * kLen; e += kThreads) keys[e] = 0;
  for (int e = tid; e < kMixUsers; e += kThreads) {
    thr[e] = 0;
    cand[e] = 0;
  }
  if (tid == 0) *full = 0;
  stage_transposed(su, users, b0, kMixUsers, B, K, kMixUS);

  // Candidate ownership: one user, rows r0, r0 + 8, ... of each tile.
  const int cu = tid % kMixUsers;
  const int r0 = tid / kMixUsers;
  const int b = b0 + cu;
  const bool resume = resume_scores != nullptr && b < B;
  const float rs = resume ? resume_scores[b] : 0.0f;
  const int rid = resume ? resume_ids[b] : 0;
  // Scoring ownership: items ti + 16 r, users tu + 16 c.
  const int ti = tid / 16;
  const int tu = tid % 16;

  const int num_tiles = (N + kMixItems - 1) / kMixItems;
  const int tile_begin = blockIdx.y * tiles_per_split;
  const int tile_end = min(num_tiles, tile_begin + tiles_per_split);
  __syncthreads();

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int row0 = tile * kMixItems;
    stage_transposed(si, items, row0, kMixItems, N, D, kMixIS);
    for (int i = tid; i < kMixItems; i += kThreads)
      sb[i] = row0 + i < N ? bias[row0 + i] : 0.0f;
    __syncthreads();

    float acc[4][2];
    mixture_score_block<4, 2, MAXM>(
        acc, mixtures, D,
        [&](int r, int d) { return si[d * kMixIS + ti + 16 * r]; },
        [&](int c, int k, int d) {
          return su[(k * D + d) * kMixUS + tu + 16 * c];
        },
        [&](int r) { return sb[ti + 16 * r]; });
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        ss[(ti + 16 * r) * kMixUS + tu + 16 * c] = acc[r][c];
    __syncthreads();

    // Append every key above the user's threshold to its buffer.  A
    // buffer holds at most kBuf - kMixItems keys before a tile, so the
    // tile cannot overflow it; one that passes that mark asks for a merge.
    if (b < B) {
      const int valid = min(kMixItems, N - row0);
      const u64 threshold = thr[cu];
      for (int i = r0; i < valid; i += kMixRows) {
        const float s = ss[i * kMixUS + cu];
        const int id = row0 + i;
        if (resume && (s > rs || (s == rs && id <= rid))) continue;
        const u64 key = make_key(s, id);
        if (key > threshold) {
          const int pos = atomicAdd(&cand[cu], 1);
          keys[cu * kLen + KP + pos] = key;
          if (pos >= kBuf - kMixItems) *full = 1;
        }
      }
    }
    __syncthreads();
    const int merge = *full;
    __syncthreads();
    if (merge) {
      if (tid == 0) *full = 0;
      merge_candidates<kMixUsers, kLen>(keys, thr, cand, KP);
    }
  }
  merge_candidates<kMixUsers, kLen>(keys, thr, cand, KP);
  write_lists<kMixUsers, kLen, KP>(keys, b0, B, splits, partial);
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

template <typename T, int KP>
int launch_dot(const float* users, const void* items, const float* bias,
               const float* resume_scores, const int* resume_ids, int B,
               int N, int D, int k, int splits, u64* partial,
               float* out_scores, int* out_ids, cudaStream_t stream) {
  const size_t smem = dot_smem_bytes<KP>(D);
  auto stage1 = topk_dot_stage1<T, KP>;
  cudaError_t err = cudaFuncSetAttribute(
      stage1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (N + kDotItems - 1) / kDotItems;
  const int per_split = split_tiles(num_tiles, splits);
  const int used = (num_tiles + per_split - 1) / per_split;
  constexpr int U = dot_users<KP>();
  dim3 grid((B + U - 1) / U, used);
  stage1<<<grid, dot_threads<KP>(), smem, stream>>>(
      users, static_cast<const T*>(items), bias, resume_scores, resume_ids, B,
      N, D, k, per_split, used, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stage2(partial, B, used, KP, k, out_scores, out_ids, stream);
}

template <typename T, int KP, int MAXM>
int launch_mixture(const float* users, const void* items, const float* bias,
                   const float* resume_scores, const int* resume_ids, int B,
                   int N, int D, int mixtures, int k, int splits,
                   u64* partial, float* out_scores, int* out_ids,
                   cudaStream_t stream) {
  const size_t smem = mix_smem_bytes<KP>(D, 2 * mixtures * D);
  auto stage1 = topk_mixture_stage1<T, KP, MAXM>;
  cudaError_t err = cudaFuncSetAttribute(
      stage1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (N + kMixItems - 1) / kMixItems;
  const int per_split = split_tiles(num_tiles, splits);
  const int used = (num_tiles + per_split - 1) / per_split;
  dim3 grid((B + kMixUsers - 1) / kMixUsers, used);
  stage1<<<grid, kThreads, smem, stream>>>(
      users, static_cast<const T*>(items), bias, resume_scores, resume_ids, B,
      N, D, mixtures, per_split, used, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stage2(partial, B, used, KP, k, out_scores, out_ids, stream);
}

template <typename T, int KP>
int launch_topk(const float* users, const void* items, const float* bias,
                const float* rs, const int* ri, int B, int N, int D,
                int mixtures, int k, int splits, u64* partial, float* os,
                int* oi, cudaStream_t s) {
  if (mixtures == 0)
    return launch_dot<T, KP>(users, items, bias, rs, ri, B, N, D, k, splits,
                             partial, os, oi, s);
  if (mixtures <= 4)
    return launch_mixture<T, KP, 4>(users, items, bias, rs, ri, B, N, D,
                                    mixtures, k, splits, partial, os, oi, s);
  return launch_mixture<T, KP, kMaxMixtures>(users, items, bias, rs, ri, B,
                                             N, D, mixtures, k, splits,
                                             partial, os, oi, s);
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

template <int KP>
size_t stage1_smem_bytes(int D, int mixtures) {
  return mixtures > 0 ? mix_smem_bytes<KP>(D, 2 * mixtures * D)
                      : dot_smem_bytes<KP>(D);
}

}  // namespace

extern "C" {

size_t spotlight_topk_stage1_smem_bytes(int kp, int D, int mixtures) {
  switch (kp) {
    case 16: return stage1_smem_bytes<16>(D, mixtures);
    case 32: return stage1_smem_bytes<32>(D, mixtures);
    case 64: return stage1_smem_bytes<64>(D, mixtures);
    case 128: return stage1_smem_bytes<128>(D, mixtures);
    case 256: return stage1_smem_bytes<256>(D, mixtures);
    default: return 0;
  }
}

// Users per stage-1 block of a fetch at kp.
int spotlight_topk_block_users(int kp, int mixtures) {
  return mixtures > 0 ? kMixUsers : (kp <= 64 ? dot_users<64>()
                                              : dot_users<256>());
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
