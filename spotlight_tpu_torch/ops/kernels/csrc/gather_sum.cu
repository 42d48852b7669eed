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
// gather is plain loads.  Forward: a block holds blockDim.y ids, and
// blockDim.x threads cover an id's row in 16-byte chunks, neighbouring
// threads on neighbouring addresses (no index division).  A thread reads
// its id's k row numbers in their own type (int32 or int64: no cast
// launch), checks each against [0, C), and sums the rows in hash order.
// What limits it is L2, not device memory: every id re-reads k rows
// through L2, 1 GB at the densify shape against 51 MB of table, so even a
// bfloat16 table that fits in L2 runs at ~4 TB/s of L2 traffic.  A k = 4
// kernel reading the row numbers in one vector load and issuing all row
// loads before the first addition, streaming stores for the output, an
// evict-last hint and a persisting L2 window over the table measured no
// faster (PERF.md, section 6).  The range check costs the host nothing:
// a row outside [0, C) prints the row and the bound and traps, so the
// launch fails with a device-side error at the caller's next
// synchronisation, as F.embedding_bag's index check does on the card; no
// value is ever read from outside the table.
// The backward is the transpose without atomics: the wrapper groups the
// B * k contributions by row with a stable sort (index preparation: the
// sorted flat indices and each row's offset into them), and one thread per
// (row, 16-byte chunk) walks its row's list in order.  A row's work grows
// with its multiplicity, which is skewed (row 0 takes every padding id);
// nothing is sized for the mean.
#include <cstdio>

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

// A row outside [0, C): report it and stop the launch.
__device__ __noinline__ void row_out_of_range(long long b, int j,
                                              long long row, long long C) {
  printf("spotlight gather_sum: rows[%lld, %d] = %lld lies outside "
         "[0, %lld)\n", b, j, row, C);
  __trap();
}

template <typename I>
__device__ __forceinline__ long long checked_row(I row, long long b, int j,
                                                 long long C) {
  const long long r = static_cast<long long>(row);
  if (static_cast<unsigned long long>(r) >= static_cast<unsigned long long>(C))
    row_out_of_range(b, j, r, C);
  return r;
}

template <typename T, int VEC, bool MASK>
__device__ __forceinline__ void load_term(const T* __restrict__ table,
                                          long long row, int D, int d0,
                                          float (&v)[VEC]) {
  if (MASK && row == 0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = 0.0f;
  } else {
    load_vec<T, VEC>(table + row * D + d0, v);
  }
}

// The forward.  Block (x, y): x over an id's 16-byte chunks, y over
// blockDim.y ids.
template <typename T, typename I, int VEC, bool MASK, bool ACC_TABLE>
__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const T* __restrict__ table, const I* __restrict__ rows,
                  T* __restrict__ out, long long B, int k, int D,
                  long long C) {
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const int chunks = D / VEC;
  const I* r = rows + b * k;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int d0 = c * VEC;
    float acc[VEC];
    load_term<T, VEC, MASK>(table, checked_row(r[0], b, 0, C), D, d0, acc);
#pragma unroll 4
    for (int j = 1; j < k; ++j) {
      float v[VEC];
      load_term<T, VEC, MASK>(table, checked_row(r[j], b, j, C), D, d0, v);
      accumulate<T, VEC, ACC_TABLE>(acc, v);
    }
    store_vec<T, VEC>(out + b * D + d0, acc);
  }
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

// The forward's block: x over an id's chunks, y over ids.
dim3 gather_block(int chunks) {
  const int x = chunks < kThreads ? chunks : kThreads;
  return dim3(x, kThreads / x);
}

struct Gather {
  template <typename T, typename I, int VEC, bool MASK, bool ACC_TABLE>
  static int launch(const void* table, const void* rows, void* out,
                    long long B, int k, int D, long long C, cudaStream_t s) {
    const dim3 block = gather_block(D / VEC);
    gather_sum_kernel<T, I, VEC, MASK, ACC_TABLE>
        <<<(unsigned)((B + block.y - 1) / block.y), block, 0, s>>>(
            static_cast<const T*>(table), static_cast<const I*>(rows),
            static_cast<T*>(out), B, k, D, C);
    return cudaGetLastError();
  }

  template <typename T, int VEC, bool MASK, bool ACC_TABLE>
  static int run(const void* table, const void* rows, int rows_int64,
                 void* out, long long B, int k, int D, long long C,
                 cudaStream_t s) {
    return rows_int64 ? launch<T, long long, VEC, MASK, ACC_TABLE>(
                            table, rows, out, B, k, D, C, s)
                      : launch<T, int, VEC, MASK, ACC_TABLE>(
                            table, rows, out, B, k, D, C, s);
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

// out (B, D) = the sum of the k rows of table (C, D) named by rows (B, k),
// int32 or, with rows_int64, int64.  A row outside [0, C) stops the launch
// with a device-side error (printed; it surfaces at the next
// synchronisation).  table and out are float32 or, with table_bf16,
// bfloat16.  mask zeroes row 0's terms; acc_table rounds the sum to the
// table's dtype after every addition.  Returns a cudaError_t (0 on
// success).
int spotlight_gather_sum(const void* table, int table_bf16, long long C,
                         const void* rows, int rows_int64, void* out,
                         long long B, int k, int D, int mask, int acc_table,
                         void* stream) {
  if (B <= 0 || k <= 0 || D <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = table_bf16 ? 8 : 4;
  const bool wide = D % vec == 0 && aligned16(table) && aligned16(out);
  return dispatch<Gather>(table_bf16, wide, mask, acc_table, table, rows,
                          rows_int64, out, B, k, D, C, s);
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
