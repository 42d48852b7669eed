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
// wrapper (ops/kernels/row_update.py) sorts the ids once with a stable
// sort: sorted_ids (n,) ascending, order (n,) the occurrence at each sorted
// position, so equal ids keep their occurrence order.  A segment is a run
// of equal sorted ids.  For each segment whose id (its row) lies in [0, R),
// in this order and each operation rounded on its own:
//
//     g = +0.0; g = g + grads[order[e]][c] for e ascending over the run
//     if l2 != 0:  g = g + l2 * param[row][c]
//     m = b1 * mu[row][c] + omb1 * g
//     v = b2 * nu[row][c] + (omb2 * g) * g
//     delta = (neg_lr * (m / bc1)) / (sqrt(v / bc2) + eps)
//     param[row][c] = param[row][c] + T(delta);  mu = m;  nu = v
//
// T(delta) rounds the update to the table's dtype (float32 or bfloat16)
// before the addition, as JAX's param.at[uids].add(delta.astype(dtype))
// does; the moments are float32.  A row outside [0, R) (the JAX mesh
// engine's sentinel R, a negative id, which sorts first) updates nothing.
// b1, omb1 = 1 - b1, b2, omb2, neg_lr = -lr, eps, l2 and the bias
// corrections bc1 = 1 - b1^t, bc2 = 1 - b2^t are float32 values the host
// computes as JAX's weak typing rounds them.  The probe's kernel
// (pre-summed unique rows, l2 = 0) is the case of unique sorted ids and
// order = arange(n).  The arithmetic uses the _rn intrinsics (no FMA
// contraction) and IEEE sqrt and division (no fast math), so the PyTorch
// plain version repeats it bit for bit.
//
// What bounds it on an H100: bytes.  Each distinct row's param, mu and nu
// are read and written once (six rows of W values), each occurrence's
// gradient row is read once; there are ~20 operations per element, far
// below the card's balance point.  At the lazy engine's shapes (W = 65,
// 8,192 user ids and 16,384 item ids a step) that is a few MB per call, so
// what a call costs is its launches on the host: the sort, and this one.
//
// What the design does about it.  No segment arrays: the kernel reads the
// sort's two outputs directly, so a call is the sort's kernels and one
// launch, with no cumsum, searchsorted, cast or readback between them.  A
// warp owns one sorted position and one slice of 32 columns (a row of W
// columns takes ceil(W / 32) warps, side by side); a position whose id
// equals its predecessor's returns at once, so only segment heads work.
// The head walks its run 32 positions at a time: each lane reads one
// position's id and occurrence (coalesced), a ballot counts the run's
// members in the chunk (a prefix: the ids are sorted), and the lanes, one
// column each, issue 8 gradient loads together and add them in order.
// The sum of a column stays in one thread, so its bits do not depend on
// the run's length: skew (each lazy step's ~60 padded examples name user 0
// and item 0) costs time, 8 occurrences per memory round trip, not bits.
// 32 registers a thread keep the SM full of these short-lived warps: a
// walk of 32 loads in flight took 60 registers and was 1.5x slower at the
// probe's shape, though 3x faster on a 7,616-occurrence run (PERF.md,
// section 6).
// One writer per row: no atomics, the same bits in every launch.
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

constexpr unsigned kFull = 0xffffffffu;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
row_adam_kernel(T* __restrict__ param, float* __restrict__ mu,
                float* __restrict__ nu, const float* __restrict__ grads,
                const I* __restrict__ sorted_ids,
                const long long* __restrict__ order, int n, int num_rows,
                int width, int slices, AdamScalars s) {
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int p = warp / slices;
  if (p >= n) return;
  const I id = sorted_ids[p];
  if (p > 0 && sorted_ids[p - 1] == id) return;     // not a segment head
  if (id < 0 || id >= (I)num_rows) return;          // updates nothing
  const int c = (warp - p * slices) * 32 + lane;
  const bool live = c < width;
  const long long at = (long long)id * width + c;

  // The row's old values: their loads do not wait for the walk.
  const float p_old = live ? to_f32(param[at]) : 0.0f;
  const float m_old = live ? mu[at] : 0.0f;
  const float v_old = live ? nu[at] : 0.0f;

  // The run's chunk at e0: each lane's occurrence, and the members' count.
  int e0 = p;
  auto chunk = [&](long long& occurrence) {
    const int e = e0 + lane;
    const bool member = e < n && sorted_ids[e] == id;
    occurrence = member ? order[e] : 0;
    return __popc(__ballot_sync(kFull, member));
  };
  long long occurrence;
  int count = chunk(occurrence);
  float g = 0.0f;
  while (true) {
    for (int j0 = 0; j0 < count; j0 += 8) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long o = __shfl_sync(kFull, occurrence, j0 + j);
        v[j] = live && j0 + j < count ? grads[o * width + c] : 0.0f;
      }
      // Past the run's end the terms are +0.0, which changes no sum that
      // started from +0.0 (such a sum is never -0.0).
#pragma unroll
      for (int j = 0; j < 8; ++j) g = __fadd_rn(g, v[j]);
    }
    if (count < 32) break;
    e0 += 32;
    count = chunk(occurrence);
  }
  if (!live) return;

  if (s.l2 != 0.0f) g = __fadd_rn(g, __fmul_rn(s.l2, p_old));
  const float m = __fadd_rn(__fmul_rn(s.b1, m_old), __fmul_rn(s.omb1, g));
  const float v = __fadd_rn(__fmul_rn(s.b2, v_old),
                            __fmul_rn(__fmul_rn(s.omb2, g), g));
  const float m_hat = __fdiv_rn(m, s.bc1);
  const float v_hat = __fdiv_rn(v, s.bc2);
  const float delta = __fdiv_rn(__fmul_rn(s.neg_lr, m_hat),
                                __fadd_rn(__fsqrt_rn(v_hat), s.eps));
  store_param(__fadd_rn(p_old, round_update(delta, param)), &param[at]);
  mu[at] = m;
  nu[at] = v;
}

template <typename T, typename I>
int launch(void* param, float* mu, float* nu, const float* grads,
           const void* sorted_ids, const long long* order, int n,
           int num_rows, int width, const AdamScalars& s, cudaStream_t st) {
  const int slices = (width + 31) / 32;
  const long long warps = (long long)n * slices;
  const unsigned blocks = (unsigned)((warps + kWarpsPerBlock - 1) /
                                     kWarpsPerBlock);
  row_adam_kernel<T, I><<<blocks, kThreads, 0, st>>>(
      static_cast<T*>(param), mu, nu, grads, static_cast<const I*>(sorted_ids),
      order, n, num_rows, width, slices, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// In-place Adam on the segments of a stably sorted occurrence list (see
// above).  param (R, W) float32 or, with param_bf16, bfloat16; mu, nu
// (R, W) float32; grads (n, W) float32; sorted_ids (n,) int32 or, with
// ids_int64, int64; order (n,) int64.  Returns a cudaError_t (0 on
// success).
int spotlight_row_adam(void* param, int param_bf16, float* mu, float* nu,
                       const float* grads, const void* sorted_ids,
                       int ids_int64, const long long* order, int n,
                       int num_rows, int width, float b1, float omb1,
                       float b2, float omb2, float neg_lr, float eps,
                       float l2, float bc1, float bc2, void* stream) {
  if (n <= 0 || num_rows <= 0 || width <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamScalars s{b1, omb1, b2, omb2, neg_lr, eps, l2, bc1, bc2};
  if (param_bf16)
    return ids_int64
               ? launch<__nv_bfloat16, long long>(param, mu, nu, grads,
                                                  sorted_ids, order, n,
                                                  num_rows, width, s, st)
               : launch<__nv_bfloat16, int>(param, mu, nu, grads, sorted_ids,
                                            order, n, num_rows, width, s, st);
  return ids_int64 ? launch<float, long long>(param, mu, nu, grads,
                                              sorted_ids, order, n, num_rows,
                                              width, s, st)
                   : launch<float, int>(param, mu, nu, grads, sorted_ids,
                                        order, n, num_rows, width, s, st);
}

}  // extern "C"
