// Per-row dot products of two [P, n] arrays (K7) for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The reference's distributed solvers take
// each shard's jnp.vdot and psum it (src/repro/solvers/cg.py dist_dot,
// dist_norm), which XLA fuses. The port runs those solvers in two forms
// that must agree bit for bit: the stacked form holds every shard's row
// of a [P, n_pad] vector on one card, a rank of a process group holds
// its own [1, n_pad] row. A library reduction picks its order from the
// tensor's shape (torch's row reduction splits a row over fewer threads
// when there are more rows), so the same row sums to other bits in the
// two forms. This kernel sums a row in an order set by n alone:
//
//   pass 1, grid (chunks, P): block (c, p) sums the products of row p in
//     [c * kChunk, (c + 1) * kChunk), thread t over t, t + 256, ... in
//     order with fused multiply-adds, then the block's fixed shuffle tree;
//   pass 2, grid (P): block p sums row p's chunk partials the same way.
//
// So out[p] has the same bits whatever P is. Types: float32 or float64
// (a, b and out of one type).
//
// Bound on the H100: bytes. Each element of a and b is read once (the
// norm reads a once: the same array passed twice stays in L1 and L2),
// the partials are chunks * P values. At the solvers' size (P <= 4 rows
// of about 281,216) pass 1 has about 70 blocks a row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 4096;

__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// the block's sum, valid in thread 0: each warp's shuffle tree, then the
// first warp's over the warps' sums, in a fixed order
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : T(0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_dots_chunks(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ part, int64_t n, int64_t lda, int64_t ldb,
                int chunks) {
  const int c = blockIdx.x, p = blockIdx.y;
  const int64_t start = static_cast<int64_t>(c) * kChunk;
  const int64_t end = start + kChunk < n ? start + kChunk : n;
  const T* ra = a + p * lda;
  const T* rb = b + p * ldb;
  T acc = 0;
  for (int64_t i = start + threadIdx.x; i < end; i += kThreads)
    acc = madd(__ldg(ra + i), __ldg(rb + i), acc);
  acc = block_sum(acc);
  if (threadIdx.x == 0) part[static_cast<int64_t>(p) * chunks + c] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_dots_rows(const T* __restrict__ part, T* __restrict__ out, int chunks) {
  const int p = blockIdx.x;
  const T* row = part + static_cast<int64_t>(p) * chunks;
  T acc = 0;
  for (int c = threadIdx.x; c < chunks; c += kThreads) acc += row[c];
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[p] = acc;
}

template <typename T>
int launch(const void* a, const void* b, void* part, void* out, int P,
           int64_t n, int64_t lda, int64_t ldb, cudaStream_t stream) {
  const int chunks = static_cast<int>((n + kChunk - 1) / kChunk);
  row_dots_chunks<T><<<dim3(chunks, P), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(part), n, lda, ldb, chunks);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_dots_rows<T><<<P, kThreads, 0, stream>>>(
      static_cast<const T*>(part), static_cast<T*>(out), chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). kind: 0 float32, 1 float64. a and b
// are [P, n] with unit stride along a row and row strides lda, ldb; part
// holds P * row_dots_chunks_of(n) values of the kind; out is [P]. P >= 1 and
// n >= 1. Returns cudaGetLastError() after the launches.
extern "C" int64_t row_dots_chunks_of(int64_t n) {
  return (n + kChunk - 1) / kChunk;
}

extern "C" int row_dots(const void* a, const void* b, void* part, void* out,
                        int P, int64_t n, int64_t lda, int64_t ldb, int kind,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: return launch<float>(a, b, part, out, P, n, lda, ldb, s);
    case 1: return launch<double>(a, b, part, out, P, n, lda, ldb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
