// Bloom gather-sum (K6, K7f) and its deterministic transpose, a scatter-add
// grouped by row (K7b, and K6's backward).
//
// Replaces: spotlight_tpu/ops/kernels/bloom.py, _bloom_gather_kernel (the
// Pallas kernel behind bloom_gather_sum) and the XLA scatter-add of its
// custom VJP; spotlight_tpu/ops/kernels/multihot.py, _fwd_kernel and
// _bwd_kernel (the Pallas kernels behind multihot_gather_sum).
//
// What they compute, for a table (C, D) and hashed rows (B, k):
//
//     forward   out[b] = t_0 + t_1 + ... + t_{k-1},  t_j = table[rows[b, j]]
//               (0 when MASK and rows[b, j] == 0), summed in hash order from
//               the first term, each addition rounded on its own;
//     backward  dtable[c] = the sum of grad[b] over the (b, j) with
//               rows[b, j] == c, in ascending flat index b * k + j, from the
//               first term; a row nothing touches, and row 0 under MASK, is
//               zero.
//
// The accumulator is float32 or, with ACC_TABLE, rounded to the table's
// dtype after every addition: K6 sums a bfloat16 table in bfloat16, as the
// JAX kernel's accumulator has the output's dtype, and its backward
// scatter-adds in the cotangent's dtype, as XLA's does; K7f and K7b
// accumulate in float32 and round once at the end.  (K7f's MXU formulation
// split a float32 table into bf16 hi and lo halves, about 16 bits of it;
// here the float32 sum is exact to float32 rounding.)  Duplicated hashes add
// a row twice.  The PyTorch plain versions (ops/kernels/gather_sum.py) run
// the same order as separate elementwise ops, so kernel and plain version
// agree bit for bit, and the backward gives the same bits in every launch:
// no floating-point atomics.
//
// What bounds them on an H100: bytes.  The forward reads B * k rows of D
// values at random and writes B rows; it adds (k - 1) * B * D values.  At
// the bloom model's densify shape (B = 1e6 ids, k = 4, C = 200,000, D = 64,
// float32) that is 1 GB of row reads from a 51 MB table, which about fills
// the 50 MB L2, and 256 MB of output.  The backward reads B * k cotangent
// rows and writes the C x D table.
//
// What the design does about it.  Neither TPU formulation is the natural
// one here: K6's pipelined row DMAs worked around Mosaic's lane alignment,
// K7f's multi-hot matmul around the TPU's gather latency.  On the card a
// gather is plain loads: one thread per (id, 16-byte chunk of the row)
// reads the id's k row numbers (broadcast within the warp) and then its
// chunk of each row, neighbouring threads on neighbouring addresses, and
// writes its chunk of the output once.  The backward is the transpose
// without atomics: the wrapper groups the B * k contributions by row with a
// stable sort (index preparation: the sorted flat indices and each row's
// offset into them), and one thread per (row, 16-byte chunk) walks its
// row's list in order.  A row's work grows with its multiplicity, which is
// skewed (row 0 takes every padding id); nothing is sized for the mean.
#include "common.cuh"

using namespace spotlight;

namespace {

constexpr int kThreads = 256;

// The value of x rounded to T (float: itself).
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

// VEC consecutive elements at p (16 bytes, aligned, when VEC > 1).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  if constexpr (VEC > 1) {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(e[i]);
  } else {
    out[0] = to_f32(*p);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  if constexpr (VEC > 1) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_f32(in[i], &e[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    from_f32(in[0], p);
  }
}

template <typename T, int VEC, bool ACC_TABLE>
__device__ __forceinline__ void accumulate(float (&acc)[VEC],
                                           const float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float sum = __fadd_rn(acc[i], v[i]);
    acc[i] = ACC_TABLE ? round_to<T>(sum) : sum;
  }
}

template <typename T, int VEC, bool MASK, bool ACC_TABLE>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const T* __restrict__ table, const int* __restrict__ rows,
                  T* __restrict__ out, long long B, int k, int D) {
  const int chunks = D / VEC;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * chunks) return;
  const long long b = idx / chunks;
  const int d0 = (int)(idx - b * chunks) * VEC;
  const int* r = rows + b * k;

  auto term = [&](int j, float (&v)[VEC]) {
    const int row = r[j];
    if (MASK && row == 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.0f;
    } else {
      load_vec<T, VEC>(table + (long long)row * D + d0, v);
    }
  };
  float acc[VEC];
  term(0, acc);
#pragma unroll 4
  for (int j = 1; j < k; ++j) {
    float v[VEC];
    term(j, v);
    accumulate<T, VEC, ACC_TABLE>(acc, v);
  }
  store_vec<T, VEC>(out + b * D + d0, acc);
}

template <typename T, int VEC, bool MASK, bool ACC_TABLE>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const T* __restrict__ grad, const int* __restrict__ order,
                    const int* __restrict__ offsets, T* __restrict__ dtable,
                    int C, int k, int D) {
  const int chunks = D / VEC;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * chunks) return;
  const int c = (int)(idx / chunks);
  const int d0 = (int)(idx - (long long)c * chunks) * VEC;
  const int begin = offsets[c];
  const int end = offsets[c + 1];

  float acc[VEC];
  if (begin == end || (MASK && c == 0)) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  } else {
    load_vec<T, VEC>(grad + (long long)(order[begin] / k) * D + d0, acc);
    for (int e = begin + 1; e < end; ++e) {
      float v[VEC];
      load_vec<T, VEC>(grad + (long long)(order[e] / k) * D + d0, v);
      accumulate<T, VEC, ACC_TABLE>(acc, v);
    }
  }
  store_vec<T, VEC>(dtable + (long long)c * D + d0, acc);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

struct Gather {
  template <typename T, int VEC, bool MASK, bool ACC_TABLE>
  static int run(const void* table, const int* rows, void* out, long long B,
                 int k, int D, cudaStream_t s) {
    gather_sum_kernel<T, VEC, MASK, ACC_TABLE>
        <<<blocks_for(B * (D / VEC)), kThreads, 0, s>>>(
            static_cast<const T*>(table), rows, static_cast<T*>(out), B, k,
            D);
    return cudaGetLastError();
  }
};

struct Scatter {
  template <typename T, int VEC, bool MASK, bool ACC_TABLE>
  static int run(const void* grad, const int* order, const int* offsets,
                 void* dtable, int C, int k, int D, cudaStream_t s) {
    scatter_rows_kernel<T, VEC, MASK, ACC_TABLE>
        <<<blocks_for((long long)C * (D / VEC)), kThreads, 0, s>>>(
            static_cast<const T*>(grad), order, offsets,
            static_cast<T*>(dtable), C, k, D);
    return cudaGetLastError();
  }
};

template <class L, typename T, int VEC, class... Args>
int dispatch_flags(bool mask, bool acc_table, Args... args) {
  if (mask)
    return acc_table ? L::template run<T, VEC, true, true>(args...)
                     : L::template run<T, VEC, true, false>(args...);
  return acc_table ? L::template run<T, VEC, false, true>(args...)
                   : L::template run<T, VEC, false, false>(args...);
}

// Picks the instantiation: 16-byte vectors where the width and the
// pointers allow; for float32 tables rounding to the table's dtype changes
// nothing.
template <class L, class... Args>
int dispatch(bool bf16, bool wide, bool mask, bool acc_table, Args... args) {
  if (bf16)
    return wide ? dispatch_flags<L, __nv_bfloat16, 8>(mask, acc_table, args...)
                : dispatch_flags<L, __nv_bfloat16, 1>(mask, acc_table, args...);
  return wide ? dispatch_flags<L, float, 4>(mask, false, args...)
              : dispatch_flags<L, float, 1>(mask, false, args...);
}

}  // namespace

extern "C" {

// out (B, D) = the sum of the k rows of table (C, D) named by rows (B, k)
// int32, every row in [0, C) (the wrapper checks).  table and out are
// float32 or, with table_bf16, bfloat16.  mask zeroes row 0's terms;
// acc_table rounds the sum to the table's dtype after every addition.
// Returns a cudaError_t (0 on success).
int spotlight_gather_sum(const void* table, int table_bf16, const int* rows,
                         void* out, long long B, int k, int D, int mask,
                         int acc_table, void* stream) {
  if (B <= 0 || k <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = table_bf16 ? 8 : 4;
  const bool wide = D % vec == 0 && aligned16(table) && aligned16(out);
  return dispatch<Gather>(table_bf16, wide, mask, acc_table, table, rows, out,
                          B, k, D, s);
}

// dtable (C, D) = the transpose of spotlight_gather_sum applied to grad
// (B, D).  order (B * k,) int32 holds the flat indices b * k + j sorted by
// their row, ascending within a row; offsets (C + 1,) int32 the start of
// each row's run in order.  Returns a cudaError_t (0 on success).
int spotlight_scatter_rows(const void* grad, int grad_bf16, const int* order,
                           const int* offsets, void* dtable, int C, int k,
                           int D, int mask, int acc_table, void* stream) {
  if (C <= 0 || k <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = grad_bf16 ? 8 : 4;
  const bool wide = D % vec == 0 && aligned16(grad) && aligned16(dtable);
  return dispatch<Scatter>(grad_bf16, wide, mask, acc_table, grad, order,
                           offsets, dtable, C, k, D, s);
}

}  // extern "C"
