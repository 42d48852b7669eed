// Row-sparse Adam on the rows named by occurrence ids (P1).
//
// Replaces: scripts/fused_rowupdate_probe.py, _row_update_kernel (the
// Pallas kernel behind fused_row_update), and with it the row update of
// spotlight_tpu/ops/lazy_adam.py, sparse_adam_rows (its segment-sum and the
// gathers and scatters of the touched rows), which the lazy training engine
// runs twice a step.
//
// What it computes.  The occurrence ids of a step name rows of a table
// (R, W) with repeats; occurrence e carries a gradient row grads[e].  The
// wrapper (ops/kernels/row_update.py) groups the occurrences by row with a
// stable sort: order (n,) lists the occurrences by ascending row id, equal
// ids in occurrence order; segment s covers order[offsets[s] .. offsets[s+1])
// and names row rows[s]; *count segments exist (a device scalar: the
// number of distinct ids never reaches the host).  For each segment whose
// row lies in [0, R), in this order and each operation rounded on its own:
//
//     g = +0.0; g = g + grads[order[e]][c] for e ascending
//     if l2 != 0:  g = g + l2 * param[row][c]
//     m = b1 * mu[row][c] + omb1 * g
//     v = b2 * nu[row][c] + (omb2 * g) * g
//     delta = (neg_lr * (m / bc1)) / (sqrt(v / bc2) + eps)
//     param[row][c] = param[row][c] + T(delta);  mu = m;  nu = v
//
// T(delta) rounds the update to the table's dtype (float32 or bfloat16)
// before the addition, as JAX's param.at[uids].add(delta.astype(dtype))
// does; the moments are float32.  A row outside [0, R) (the JAX mesh
// engine's sentinel R, or any other) updates nothing.  b1, omb1 = 1 - b1,
// b2, omb2, neg_lr = -lr, eps, l2 and the bias corrections bc1 = 1 - b1^t,
// bc2 = 1 - b2^t are float32 values the host computes as JAX's weak typing
// rounds them.  The probe's kernel (pre-summed unique rows, l2 = 0) is the
// case order = arange(n), offsets = arange(n + 1).  The arithmetic uses the
// _rn intrinsics (no FMA contraction) and IEEE sqrt and division (no fast
// math), so the PyTorch plain version repeats it bit for bit.
//
// What bounds it on an H100: bytes.  Each distinct row's param, mu and nu
// are read and written once (six rows of W values), each occurrence's
// gradient row is read once; there are ~20 operations per element, far
// below the card's balance point.  At the lazy engine's shapes (W = 65,
// 8,192 user ids and 16,384 item ids a step) that is a few MB per call.
//
// What the design does about it.  One warp per segment, the lanes over the
// W columns: neighbouring lanes read neighbouring addresses of a row, and
// the row's id, offsets and occurrence list are warp-uniform loads.  One
// writer per row: no atomics, the same bits in every launch.  Slots past
// the device-side count return at once, so the launch is sized by the
// occurrence count n and needs no readback.  Making it fast (several rows a
// warp for narrow W, vector loads) is later work.
#include "common.cuh"

using namespace spotlight;

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

struct AdamScalars {
  float b1, omb1, b2, omb2, neg_lr, eps, l2, bc1, bc2;
};

__device__ __forceinline__ float round_update(float x, float*) { return x; }
__device__ __forceinline__ float round_update(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store_param(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store_param(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_adam_kernel(T* __restrict__ param, float* __restrict__ mu,
                float* __restrict__ nu, const float* __restrict__ grads,
                const int* __restrict__ order,
                const int* __restrict__ offsets,
                const int* __restrict__ rows, const int* __restrict__ count,
                int n, int num_rows, int width, AdamScalars s) {
  const int segment = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (segment >= n || segment >= *count) return;
  const int row = rows[segment];
  if (row < 0 || row >= num_rows) return;
  const int begin = offsets[segment];
  const int end = offsets[segment + 1];
  const long long base = (long long)row * width;

  for (int c = lane; c < width; c += 32) {
    float g = 0.0f;
    for (int e = begin; e < end; ++e)
      g = __fadd_rn(g, grads[(long long)order[e] * width + c]);
    const float p = to_f32(param[base + c]);
    if (s.l2 != 0.0f) g = __fadd_rn(g, __fmul_rn(s.l2, p));
    const float m = __fadd_rn(__fmul_rn(s.b1, mu[base + c]),
                              __fmul_rn(s.omb1, g));
    const float v = __fadd_rn(__fmul_rn(s.b2, nu[base + c]),
                              __fmul_rn(__fmul_rn(s.omb2, g), g));
    const float m_hat = __fdiv_rn(m, s.bc1);
    const float v_hat = __fdiv_rn(v, s.bc2);
    const float delta = __fdiv_rn(__fmul_rn(s.neg_lr, m_hat),
                                  __fadd_rn(__fsqrt_rn(v_hat), s.eps));
    store_param(__fadd_rn(p, round_update(delta, param)), &param[base + c]);
    mu[base + c] = m;
    nu[base + c] = v;
  }
}

}  // namespace

extern "C" {

// In-place Adam on the segments of a sorted occurrence list (see above).
// param (R, W) float32 or, with param_bf16, bfloat16; mu, nu (R, W)
// float32; grads (n, W) float32; order (n,), offsets (n + 1,), rows (n,)
// int32; count a device int32 scalar, the number of segments (at most n).
// Returns a cudaError_t (0 on success).
int spotlight_row_adam(void* param, int param_bf16, float* mu, float* nu,
                       const float* grads, const int* order,
                       const int* offsets, const int* rows, const int* count,
                       int n, int num_rows, int width, float b1, float omb1,
                       float b2, float omb2, float neg_lr, float eps,
                       float l2, float bc1, float bc2, void* stream) {
  if (n <= 0 || num_rows <= 0 || width <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamScalars s{b1, omb1, b2, omb2, neg_lr, eps, l2, bc1, bc2};
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) /
                                     kWarpsPerBlock);
  if (param_bf16)
    row_adam_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<__nv_bfloat16*>(param), mu, nu, grads, order, offsets,
        rows, count, n, num_rows, width, s);
  else
    row_adam_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<float*>(param), mu, nu, grads, order, offsets, rows,
        count, n, num_rows, width, s);
  return cudaGetLastError();
}

}  // extern "C"
