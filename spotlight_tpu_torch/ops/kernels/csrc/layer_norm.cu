// LayerNorm over the last dimension of narrow rows (SASRec's blocks).
//
// Replaces: no TPU kernel.  The JAX package has no LayerNorm, and SASRec
// (sequence.representations.SelfAttentionNet) is the port's own.  The
// kernel takes the place of torch's F.layer_norm in the blocks' five
// LayerNorms a forward pass, which at D = 50 (no multiple of 4) run torch's
// unvectorised two-kernel path: a whole thread block a 50-float row for the
// moments, then a second read of the row.
//
// What it computes, for x (rows, D), gain (D), offset (D):
//
//     mean = (x[r, 0] + ... + x[r, D-1]) / D
//     var  = ((x[r, 0] - mean)^2 + ... + (x[r, D-1] - mean)^2) / D
//     rstd = rsqrt(var + eps)
//     y[r, c] = (x[r, c] - mean) * rstd * gain[c] + offset[c]
//
// in the input's type (float32, or float64), the variance centred from the
// same registers (no E[x^2] - E[x]^2 cancellation).  A row of zeros (a
// padding step) has var = 0 and gives y = offset.  mean and rstd are
// written only when the caller hands their buffers (autograd's backward
// needs them); under no_grad only y is written.  The sums run as a warp's
// butterfly, another order than the plain version's (ops/kernels/
// layer_norm.py), so the two agree to float32 rounding, not bit for bit.
//
// What bounds it on an H100: bytes.  Each row is read once and written
// once, 2 * rows * D * 4 bytes in float32, at 3.35 TB/s; ~8 operations an
// element are far below the card's balance point.  At SASRec's call
// (2,048 histories x 200 steps = 409,600 rows of D = 50) that is 164 MB, a
// bound of 0.049 ms a LayerNorm.
//
// What the design does about it.  One warp normalises one row: each lane
// keeps its ceil(D / 32) values (VPL, a template of 1 to 32, rounded up to
// a power of two: D <= 1,024) in registers, loaded once, column
// j * 32 + lane, so every load and store of a warp is one coalesced span of
// the row.  The mean and then the centred variance are warp-shuffle sums
// of those registers; nothing goes through shared memory, and no block
// waits on a barrier.  Eight warps a block, and a grid-stride loop over
// the rows with at most as many blocks as fill every SM, so each warp
// walks many rows and the gain and offset stay in its registers.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kBlocksPerSm = 2048 / kThreads;
constexpr unsigned kFull = 0xffffffffu;
// The widest row: 32 values a lane.
constexpr int kMaxDim = 32 * 32;

__device__ __forceinline__ float inv_sqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double inv_sqrt(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(kFull, v, offset);
  return v;
}

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
layer_norm_warp(const T* __restrict__ x, const T* __restrict__ gain,
                const T* __restrict__ offset, T* __restrict__ y,
                T* __restrict__ mean_out, T* __restrict__ rstd_out,
                long long rows, int dim, T eps) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  T g[VPL], b[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int c = j * 32 + lane;
    g[j] = c < dim ? gain[c] : T(0);
    b[j] = c < dim ? offset[c] : T(0);
  }
  for (long long r = blockIdx.x * (long long)kWarpsPerBlock +
                     (threadIdx.x >> 5);
       r < rows; r += warps) {
    const T* row = x + r * dim;
    T v[VPL];
    T sum = T(0);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * 32 + lane;
      v[j] = c < dim ? row[c] : T(0);
      sum += v[j];
    }
    const T mean = warp_sum(sum) / T(dim);
    T squares = T(0);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * 32 + lane;
      const T d = c < dim ? v[j] - mean : T(0);
      squares += d * d;
    }
    const T rstd = inv_sqrt(warp_sum(squares) / T(dim) + eps);
    T* out = y + r * dim;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * 32 + lane;
      if (c < dim) out[c] = (v[j] - mean) * rstd * g[j] + b[j];
    }
    if (mean_out != nullptr && lane == 0) {
      mean_out[r] = mean;
      rstd_out[r] = rstd;
    }
  }
}

template <typename T, int VPL>
int launch(const void* x, const void* gain, const void* offset, void* y,
           void* mean, void* rstd, long long rows, int dim, double eps,
           int sms, cudaStream_t st) {
  const long long needed = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long full = (long long)sms * kBlocksPerSm;
  const unsigned blocks = (unsigned)(needed < full ? needed : full);
  layer_norm_warp<T, VPL><<<blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gain),
      static_cast<const T*>(offset), static_cast<T*>(y),
      static_cast<T*>(mean), static_cast<T*>(rstd), rows, dim, (T)eps);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* gain, const void* offset, void* y,
             void* mean, void* rstd, long long rows, int dim, double eps,
             int sms, cudaStream_t st) {
  const int vpl = (dim + 31) / 32;
  if (vpl <= 1)
    return launch<T, 1>(x, gain, offset, y, mean, rstd, rows, dim, eps, sms,
                        st);
  if (vpl <= 2)
    return launch<T, 2>(x, gain, offset, y, mean, rstd, rows, dim, eps, sms,
                        st);
  if (vpl <= 4)
    return launch<T, 4>(x, gain, offset, y, mean, rstd, rows, dim, eps, sms,
                        st);
  if (vpl <= 8)
    return launch<T, 8>(x, gain, offset, y, mean, rstd, rows, dim, eps, sms,
                        st);
  if (vpl <= 16)
    return launch<T, 16>(x, gain, offset, y, mean, rstd, rows, dim, eps, sms,
                         st);
  return launch<T, 32>(x, gain, offset, y, mean, rstd, rows, dim, eps, sms,
                       st);
}

}  // namespace

extern "C" {

// y (rows, dim) = LayerNorm of x (rows, dim) with gain and offset (dim),
// all contiguous float32 or, with is_double, float64; mean and rstd (rows)
// are written when both are non-null.  sms is the card's SM count, which
// caps the grid.  Returns a cudaError_t (0 on success).
int spotlight_layer_norm(const void* x, const void* gain, const void* offset,
                         void* y, void* mean, void* rstd, long long rows,
                         int dim, double eps, int is_double, int sms,
                         void* stream) {
  if (rows < 0 || dim <= 0 || dim > kMaxDim || sms <= 0 ||
      (mean == nullptr) != (rstd == nullptr))
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_double ? dispatch<double>(x, gain, offset, y, mean, rstd, rows,
                                      dim, eps, sms, st)
                   : dispatch<float>(x, gain, offset, y, mean, rstd, rows,
                                     dim, eps, sms, st);
}

}  // extern "C"
