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
// The backward is the transpose without atomics, one stable sort and one
// launch, as P1 (row_update.cu): the wrapper sorts the B * k flat rows once
// (torch's stable sort of int32 keys: the sorted rows and, for each, its
// flat index b * k + j, equal rows in ascending flat index), and the kernel
// reads the two as the sort returns them; no offsets, casts or
// searchsorted between them.  A group of lanes owns a row of the table:
// it finds the row's run among the sorted rows by a search that probes as
// many positions a step as it has lanes, then walks the run in order (see
// scatter_rows_kernel).  Every row of the table is written by the same
// launch, an untouched one (an empty run) and row 0 under MASK (skipped,
// not walked, though it takes every padding id) as zeros.  A row's work
// grows with its multiplicity, which is skewed; the sum of a column stays
// in one thread, so skew costs time, not bits.
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

constexpr unsigned kFull = 0xffffffffu;

// The backward.  A row of the table belongs to a group of L lanes of one
// warp (L, a power of two from 8 to 32, covers its 16-byte chunks; a row
// of more than 32 chunks takes them 32 at a time).  The group finds where
// the row's run starts among the sorted rows by an L-ary search (each step
// probes L positions at once and keeps the part between the last probe
// below c and the first one not below: about log_{L+1} n steps, each one
// round trip), then walks the run L positions at a time as P1 does: each
// lane reads one position's row and flat index (coalesced), a ballot
// counts the run's members among them (a prefix: the rows are sorted),
// and the lanes, one chunk each, load kInFlight contributions at once and
// add them in order; the next chunk's positions are loaded before this
// chunk's contributions.  The run ends at the first chunk of positions
// that is not full of members.  A column's sum stays in one thread, from
// its first term, so a run's bits do not depend on its length.
template <typename T, int VEC, bool MASK, bool ACC_TABLE>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(const T* __restrict__ grad,
                    const int* __restrict__ sorted_rows,
                    const long long* __restrict__ order, int n,
                    T* __restrict__ dtable, int C, int k, int D, int L) {
  constexpr int kInFlight = 4;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int g = lane % L;           // the lane's place in its group
  const int base = lane - g;        // the group's first lane
  const unsigned group = L == 32 ? kFull : ((1u << L) - 1) << base;
  const int c = warp * (32 / L) + lane / L;
  if (c >= C) return;               // whole groups leave together
  const bool walk = !(MASK && c == 0);

  // begin = how many sorted rows lie below c.
  int begin = 0;
  for (int len = walk ? n : 0; len > 0;) {
    const int step = (len + L) / (L + 1);
    const long long probe = (long long)begin + (long long)step * (g + 1) - 1;
    const bool below =
        probe < (long long)begin + len && sorted_rows[probe] < c;
    const int t = __popc(__ballot_sync(group, below));
    const int probes = min(L, len / step);
    begin += step * t;
    len = t < probes ? step - 1 : len - step * t;
  }

  const int chunks = D / VEC;
  for (int c0 = 0; c0 < chunks; c0 += L) {
    const int chunk = c0 + g;
    const bool has = chunk < chunks;
    const int d0 = chunk * VEC;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
    bool started = false;
    // The run's chunk of L positions at e0: each lane's row and flat index,
    // loaded one chunk ahead; a ballot counts the members.
    int e0 = begin;
    int row = -1;
    long long flat = 0;
    if (walk && e0 + g < n) {
      row = sorted_rows[e0 + g];
      flat = order[e0 + g];
    }
    while (true) {
      const bool member = row == c;
      // order < B * k < 2^31: the flat index and its id fit an int.
      const int b = member ? (int)flat / k : 0;
      const int count = __popc(__ballot_sync(group, member));
      row = -1;
      if (count == L && e0 + L + g < n) {
        row = sorted_rows[e0 + L + g];
        flat = order[e0 + L + g];
      }
      for (int j0 = 0; j0 < count; j0 += kInFlight) {
        float v[kInFlight][VEC];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const int bj = __shfl_sync(group, b, j0 + j, L);
          if (has && j0 + j < count)
            load_vec<T, VEC>(grad + (long long)bj * D + d0, v[j]);
        }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          if (!(has && j0 + j < count)) continue;
          if (started) {
            accumulate<T, VEC, ACC_TABLE>(acc, v[j]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = v[j][i];
            started = true;
          }
        }
      }
      if (count < L) break;
      e0 += L;
    }
    if (has) store_vec<T, VEC>(dtable + (long long)c * D + d0, acc);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// Lanes a table row takes in the backward: its chunks rounded up to a
// power of two, at least 8 (they search together), at most a warp.
int row_lanes(int chunks) {
  int lanes = 8;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  return lanes;
}

struct Scatter {
  template <typename T, int VEC, bool MASK, bool ACC_TABLE>
  static int run(const void* grad, const int* sorted_rows,
                 const long long* order, int n, void* dtable, int C, int k,
                 int D, cudaStream_t s) {
    const int lanes = row_lanes(D / VEC);
    const long long rows_per_block = (long long)(kThreads / 32) * (32 / lanes);
    scatter_rows_kernel<T, VEC, MASK, ACC_TABLE>
        <<<(unsigned)((C + rows_per_block - 1) / rows_per_block), kThreads,
           0, s>>>(static_cast<const T*>(grad), sorted_rows, order, n,
                   static_cast<T*>(dtable), C, k, D, lanes);
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
// (B, D): row c sums grad[b] over the flat indices b * k + j whose row is
// c, in ascending flat index.  sorted_rows (n,) int32 and order (n,) int64
// are one stable sort of the n = B * k flat rows (the sorted rows, and the
// flat index of each).  Returns a cudaError_t (0 on success).
int spotlight_scatter_rows(const void* grad, int grad_bf16,
                           const int* sorted_rows, const long long* order,
                           int n, void* dtable, int C, int k, int D, int mask,
                           int acc_table, void* stream) {
  if (n <= 0 || C <= 0 || k <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = grad_bf16 ? 8 : 4;
  const bool wide = D % vec == 0 && aligned16(grad) && aligned16(dtable);
  return dispatch<Scatter>(grad_bf16, wide, mask, acc_table, grad,
                           sorted_rows, order, n, dtable, C, k, D, s);
}

}  // extern "C"
