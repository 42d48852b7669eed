// Shared pieces of the evaluation kernels (ranking.cu, topk.cu): the
// exact-tie arithmetic and the register-tiled catalogue pass's block shape,
// user staging and item slabs.
//
// The exact-tie contract.  The rank kernel counts a target's own score as a
// tie with itself (weight 0.5) instead of excluding the target by id, so
// the target score computed on its own (matched scores, candidate scores)
// must equal, bit for bit, the score the catalogue pass computes for the
// same (user, item) pair.  Every score that is ever compared is therefore
// produced in one fixed order: dot products, then the bias added; mixtures
// by 2M such dots and one combine, mixture_combine.  Every dot is in this
// order (dot_tile_accumulate on the catalogue pass's register tile, one dot
// a thread in the matched-pair kernel):
//
//     acc = u[0] * float(i[0]); for d in 1..D-1: acc = acc + u[d] * float(i[d])
//
// with each product and each sum rounded on its own (__fmul_rn, __fadd_rn:
// nvcc may not contract them into an FMA, which would round once).  The
// sum starts from the first product, not from +0.0, so a dot of -0.0
// products stays -0.0 as the JAX package's one-term dot does; every other
// value is the same either way.  The PyTorch plain versions
// (ops/kernels/ranking.py) run the same order as separate elementwise ops,
// so kernel and plain version agree bit for bit, on the card and on the
// CPU.  bf16 items are upcast on load, which is exact.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace spotlight {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The contract's dots on a register tile, for operands staged in shared
// memory transposed ([d][row] float32, rows 16-byte aligned).  The thread
// owns RI items x RU users (multiples of 4): item r = 4q + e is
// items[d * item_stride + q * item_gap + e] and user c = 4q + e is
// users[d * user_stride + q * user_gap + e], each group of four read as
// one float4, so one pass over d costs RI / 4 + RU / 4 shared loads for
// RI * RU products.  acc carries the sum across calls (slabs of d in
// order); it enters the first slab holding -0.0, and -0.0 + p == p for
// every p, the signs of zeros included, so the result is the contract's
// dot, bit for bit: the products added one at a time in d order, each
// product and each sum rounded on its own.
template <int RI, int RU>
__device__ __forceinline__ void dot_tile_accumulate(
    float (&acc)[RI][RU], int depth, const float* __restrict__ items,
    int item_stride, int item_gap, const float* __restrict__ users,
    int user_stride, int user_gap) {
  static_assert(RI % 4 == 0 && RU % 4 == 0, "register tiles are float4s");
#pragma unroll 4
  for (int d = 0; d < depth; ++d) {
    float iv[RI], uv[RU];
#pragma unroll
    for (int q = 0; q < RI / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          items + d * item_stride + q * item_gap);
      iv[4 * q] = v.x;
      iv[4 * q + 1] = v.y;
      iv[4 * q + 2] = v.z;
      iv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < RU / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          users + d * user_stride + q * user_gap);
      uv[4 * q] = v.x;
      uv[4 * q + 1] = v.y;
      uv[4 * q + 2] = v.z;
      uv[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RU; ++c)
        acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(uv[c], iv[r]));
  }
}

// Mixture-of-tastes scores (replaces mixture_combine and
// make_mixture_score_fn of spotlight_tpu/ops/kernels/ranking.py).  Each
// user is 2M vectors of width D: tastes are components k = 0..M-1,
// attentions k = M..2M-1.  For each (item, user) pair, in this order:
//
//     a_m = dot(attention_m, item), t_m = dot(taste_m, item)
//     amax = a_0, then amax = fmaxf(amax, a_m) for m = 1..M-1
//     w_m = expf(a_m - amax)
//     denom = w_0, then denom = denom + w_m
//     out = w_0 * t_0, then out = out + w_m * t_m
//     score = out / denom + bias
//
// each operation rounded on its own; expf is the accurate libdevice
// function (no --use_fast_math, no __expf).  M = mixtures is a run-time
// value of at most MAXM: the per-pair weights live in registers, indexed
// by unrolled constants.  The combine (everything after the dots) is
// mixture_combine, on a pair's 2M dots held in registers, which every
// mixture kernel calls: the catalogue pass's register tile (K1 and K5 in
// ranking.cu, K2's stage 1 in topk.cu) and the matched-pair kernel (K4 in
// ranking.cu, whose 2M lanes a pair bring their dots to one lane).

// The score of one pair from its dots: dots[m] is t_m and dots[MAXM + m]
// is a_m (components past mixtures unused).  The weights are computed in
// place over a copy of the attention dots, which keeps the live ranges as
// short as the register tiles need (no spills at MAXM = 8).
template <int MAXM>
__device__ __forceinline__ float mixture_combine(const float (&dots)[2 * MAXM],
                                                 int mixtures, float bias) {
  float w[MAXM];
#pragma unroll
  for (int m = 0; m < MAXM; ++m) w[m] = dots[MAXM + m];
  float amax = w[0];
#pragma unroll
  for (int m = 1; m < MAXM; ++m)
    if (m < mixtures) amax = fmaxf(amax, w[m]);
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
    if (m < mixtures) w[m] = expf(__fsub_rn(w[m], amax));
  float denom = w[0];
#pragma unroll
  for (int m = 1; m < MAXM; ++m)
    if (m < mixtures) denom = __fadd_rn(denom, w[m]);
  float out = 0.0f;
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m >= mixtures) continue;
    const float term = __fmul_rn(w[m], dots[m]);
    out = m == 0 ? term : __fadd_rn(out, term);
  }
  return __fadd_rn(__fdiv_rn(out, denom), bias);
}

// Widest mixture count a kernel takes: its per-pair weights are registers.
constexpr int kMaxMixtures = 8;

// ---- the register-tiled catalogue pass (ranking.cu, topk.cu) ---------------
//
// A block keeps its users resident in shared memory (transposed, rows
// 16-byte aligned) and walks a contiguous split of the catalogue in 128-item
// tiles, kSlabDepth dimensions a slab, double-buffered through registers
// (SlabStage).  Each thread scores kRI items x kRU register columns with
// dot_tile_accumulate.

// Dimensions a staged item slab holds.
constexpr int kSlabDepth = 32;

// The shape of a catalogue-pass block whose users have MP mixture
// components (MP = 0: dot scoring) and SLOTS user slots.  A thread owns kRI
// items x kRU register columns: with dot scoring 4 users of one column each,
// with mixture scoring one user's 2 MP columns, its tastes then its
// attentions (MP is the user's M rounded up to 2, 4 or 8; the columns past
// M hold zeros and are never combined).  A block scores 128-item tiles
// with 32 threads a slot.
template <int MP, int SLOTS = 16>
struct RankShape {
  static constexpr int kMixtures = MP;
  static constexpr int kCols = MP == 0 ? 1 : 2 * MP;   // columns a user
  static constexpr int kUPT = MP == 0 ? 4 : 1;         // users a thread
  static constexpr int kRU = kUPT * kCols;             // columns a thread
  static constexpr int kRI = 4;                        // items a thread
  static constexpr int kUsers = SLOTS * kUPT;          // users a block
  static constexpr int kThreads = 32 * SLOTS;
  static constexpr int kUserWarps = SLOTS / 8;  // warps across the slots
  static constexpr int kUserStride = kUsers * kCols;   // staged users' row
  static constexpr int kItems = 128;                   // items a tile
  static constexpr int kItemStride = kItems + 4;       // padded slab row
  static constexpr int kSlab = kSlabDepth * kItemStride;
  static constexpr int kScoreStride = kUsers + 4;      // padded score row
  static_assert(kRU % 4 == 0, "register tiles are float4s");
  static_assert((kItems / kRI) * SLOTS == kThreads, "one tile a block");
};

// Calls f(std::integral_constant<int, MP>()) with the MP of a launch of
// mixtures components (0: dot scoring).
template <class F>
auto with_shape(int mixtures, F f) {
  if (mixtures == 0) return f(std::integral_constant<int, 0>());
  if (mixtures <= 2) return f(std::integral_constant<int, 2>());
  if (mixtures <= 4) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, kMaxMixtures>());
}

// Stages users [b0, b0 + S::kUsers) of the user operand into shared memory:
// column k of user u, dimension d, at su[d * S::kUserStride + u * S::kCols
// + k].  With dot scoring a user is its row of D; with mixtures its row
// holds M tastes, then M attentions, of D each, and its 2 MP columns are
// its tastes, then its attentions, zeros past M.  Users past B are zeros.
template <class S>
__device__ __forceinline__ void stage_users(float* su,
                                            const float* __restrict__ users,
                                            int b0, int B, int D,
                                            int mixtures) {
  constexpr int U = S::kUsers;
  if constexpr (S::kMixtures == 0) {
    for (int e = threadIdx.x; e < U * D; e += S::kThreads) {
      const int u = e / D;
      const int d = e - u * D;
      su[d * U + u] = b0 + u < B ? users[(long long)(b0 + u) * D + d] : 0.0f;
    }
  } else {
    constexpr int MP = S::kMixtures;
    const int width = 2 * mixtures * D;  // a user's row: tastes, attentions
    for (int e = threadIdx.x; e < U * S::kCols * D; e += S::kThreads) {
      const int u = e / (S::kCols * D);
      const int rest = e - u * S::kCols * D;
      const int col = rest / D;
      const int d = rest - col * D;
      const int m = col < MP ? col : col - MP;    // the component's number
      const int k = col < MP ? m : mixtures + m;  // its place in the row
      su[d * S::kUserStride + u * S::kCols + col] =
          b0 + u < B && m < mixtures
              ? users[(long long)(b0 + u) * width + k * D + d] : 0.0f;
    }
  }
}

// The item slabs of a block of shape S, from a row-major (N, D) table: slab
// s of tile t is rows [128 t, 128 t + 128) x dimensions [32 s, 32 s + 32),
// staged transposed in float32 (dst[d * S::kItemStride + row]; bf16 upcast,
// zeros past N and D).  load() issues a slab's global loads into
// registers, store() writes them out: the next slab is loaded before this
// one is scored and stored after it, one barrier a slab (cp.async cannot
// transpose the 2-byte elements of a bf16 table, and one path serves both
// types).  A thread stages dimension sd of rows sr + kWarps j: a warp loads
// 32-byte runs of 4 rows and stores them to 32 distinct banks.
template <typename Item, class S>
struct SlabStage {
  static constexpr int kWarps = S::kThreads / 32;
  static constexpr int kLoads = S::kItems * kSlabDepth / S::kThreads;
  Item staged[kLoads];
  int sd, sr;

  __device__ __forceinline__ SlabStage() {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    sd = 8 * (warp & 3) + (lane >> 2);
    sr = 4 * (warp >> 2) + (lane & 3);
  }

  __device__ __forceinline__ void load(const Item* __restrict__ items,
                                       int tile, int slab, int N, int D) {
    const int d = slab * kSlabDepth + sd;
    const long long row = (long long)tile * S::kItems + sr;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long r = row + kWarps * j;
      staged[j] = d < D && r < N ? items[r * D + d] : Item(0.0f);
    }
  }

  __device__ __forceinline__ void store(float* slab) const {
#pragma unroll
    for (int j = 0; j < kLoads; ++j)
      slab[sd * S::kItemStride + sr + kWarps * j] = to_f32(staged[j]);
  }
};

}  // namespace spotlight
