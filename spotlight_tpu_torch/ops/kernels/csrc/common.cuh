// Shared pieces of the evaluation kernels (ranking.cu, topk.cu).
//
// The exact-tie contract.  The rank kernel counts a target's own score as a
// tie with itself (weight 0.5) instead of excluding the target by id, so
// the target score computed on its own (matched_scores) must equal, bit for
// bit, the score the catalogue pass computes for the same (user, item)
// pair.  Every score that is ever compared is therefore produced by ONE
// function, score_block, in one fixed order:
//
//     acc = 0; for d in 0..D-1: acc = acc + u[d] * float(i[d]); acc + bias
//
// with each product and each sum rounded on its own (__fmul_rn, __fadd_rn:
// nvcc may not contract them into an FMA, which would round once).  The
// PyTorch plain versions (ops/kernels/ranking.py) run the same order as
// separate elementwise ops, so kernel and plain version agree bit for bit,
// on the card and on the CPU.  bf16 items are upcast on load, which is
// exact.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spotlight {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Scores an RI x RU block of (item, user) pairs: out[r][c] is the score of
// item r against user c.  item_at(r, d) and user_at(c, d) return float32
// operands (from shared or global memory), bias_at(r) the item's bias.  The
// loop order inside one element is the contract above, whatever RI and RU.
template <int RI, int RU, class ItemAt, class UserAt, class BiasAt>
__device__ __forceinline__ void score_block(float (&out)[RI][RU], int dim,
                                            ItemAt item_at, UserAt user_at,
                                            BiasAt bias_at) {
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RU; ++c) out[r][c] = 0.0f;
  for (int d = 0; d < dim; ++d) {
    float iv[RI], uv[RU];
#pragma unroll
    for (int r = 0; r < RI; ++r) iv[r] = item_at(r, d);
#pragma unroll
    for (int c = 0; c < RU; ++c) uv[c] = user_at(c, d);
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < RU; ++c)
        out[r][c] = __fadd_rn(out[r][c], __fmul_rn(uv[c], iv[r]));
  }
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const float b = bias_at(r);
#pragma unroll
    for (int c = 0; c < RU; ++c) out[r][c] = __fadd_rn(out[r][c], b);
  }
}

// Stages rows [row0, row0 + rows) of a row-major (n, dim) table into shared
// memory transposed, as dst[d * stride + r] in float32 (zeros past n).  The
// stride is rows + 1 so the transposed stores fall in distinct banks.
template <typename T>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 long long row0, int rows,
                                                 long long n, int dim,
                                                 int stride) {
  const int total = rows * dim;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / dim;
    const int d = e - r * dim;
    const long long row = row0 + r;
    dst[d * stride + r] =
        row < n ? to_f32(src[row * (long long)dim + d]) : 0.0f;
  }
}

}  // namespace spotlight
