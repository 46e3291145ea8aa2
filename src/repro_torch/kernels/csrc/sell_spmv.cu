// SELL-C-sigma baseline SpMV (K2) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/sell_spmv.py
// sell_spmv_bucket (_kernel): the paper's comparison point.
//
// What it computes, per width bucket:
//   y[s, c] = sum_j A(val[s,j,c]) * x[clamp(col[s,j,c], 0, m-1)]
// with val {f16, bf16, f32, f64}[S, w, C], col int32[S, w, C] (padding:
// val 0, col 0), and x, y and the sum in the accumulator type A: float32
// (x float32[m], y float32[S, C]), or float64 for the fp64 operator, the
// reference's sell_spmv_jnp(..., compute_dtype=float64), whose float64 sum
// keeps the outer residual of a mixed-precision solve below the float32
// floor. The reference kernel clamps to len(xp)-1 over x zero-padded to a
// multiple of 128; SELL columns are < m by construction, so the clamp to
// m-1 reads the same x.
//
// Bit-exactness: __fmul_rn / __fadd_rn (float64: __dmul_rn / __dadd_rn)
// from acc = 0 in j order, as the plain PyTorch version adds, so nvcc
// cannot contract them into an FMA.
//
// Bound on the H100: bytes. It reads (value bytes + 4) per bucketed entry
// once, x (gathered, L2-resident at the main path's size) and writes one
// A per stored row. One thread per (slice, lane): a warp covers 32
// consecutive lanes, so each j step reads contiguous values and columns.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

template <typename A> struct Acc;
template <> struct Acc<float> {
  static __device__ __forceinline__ float of(__half v) { return __half2float(v); }
  static __device__ __forceinline__ float of(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ float of(float v) { return v; }
  static __device__ __forceinline__ float of(double v) { return __double2float_rn(v); }
  static __device__ __forceinline__ float mul_add_rn(float acc, float v, float x) {
    return __fadd_rn(acc, __fmul_rn(v, x));
  }
};
template <> struct Acc<double> {  // every value type widens exactly
  static __device__ __forceinline__ double of(__half v) { return __half2float(v); }
  static __device__ __forceinline__ double of(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ double of(float v) { return v; }
  static __device__ __forceinline__ double of(double v) { return v; }
  static __device__ __forceinline__ double mul_add_rn(double acc, double v, double x) {
    return __dadd_rn(acc, __dmul_rn(v, x));
  }
};

template <typename T, typename A>
__global__ void sell_spmv_kernel(const T* __restrict__ val,
                                 const int32_t* __restrict__ col,
                                 const A* __restrict__ x, A* __restrict__ y,
                                 int64_t S, int w, int C, int64_t mlim) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= S * C) return;
  const int64_t s = t / C;
  const int c = static_cast<int>(t - s * C);
  const int64_t base = s * w * C + c;
  A acc = 0;
  for (int j = 0; j < w; ++j) {
    const int64_t k = base + static_cast<int64_t>(j) * C;
    int64_t cj = col[k];
    cj = cj < 0 ? 0 : (cj > mlim ? mlim : cj);
    // a multiply and an add, each rounded: no contraction into an FMA
    acc = Acc<A>::mul_add_rn(acc, Acc<A>::of(val[k]), __ldg(x + cj));
  }
  y[t] = acc;
}

constexpr int kThreads = 256;

template <typename T, typename A>
void launch(const void* val, const void* col, const void* x, void* y,
            int64_t S, int w, int C, int64_t m, cudaStream_t stream) {
  const int64_t n = S * C;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sell_spmv_kernel<T, A><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(val), static_cast<const int32_t*>(col),
      static_cast<const A*>(x), static_cast<A*>(y), S, w, C, m - 1);
}

template <typename A>
int launch_values(int value_kind, const void* val, const void* col,
                  const void* x, void* y, int64_t S, int w, int C, int64_t m,
                  cudaStream_t s) {
  switch (value_kind) {
    case 0: launch<__half, A>(val, col, x, y, S, w, C, m, s); break;
    case 1: launch<__nv_bfloat16, A>(val, col, x, y, S, w, C, m, s); break;
    case 2: launch<float, A>(val, col, x, y, S, w, C, m, s); break;
    case 3: launch<double, A>(val, col, x, y, S, w, C, m, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). value_kind: 0 f16, 1 bf16, 2 f32,
// 3 f64; acc_kind: 0 float32, 1 float64 (x and y of that type). Returns
// cudaGetLastError() after the launch. S * C must be > 0.
extern "C" int sell_spmv_bucket(const void* val, const void* col, const void* x,
                                void* y, int64_t S, int w, int C, int64_t m,
                                int value_kind, int acc_kind, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (acc_kind) {
    case 0: return launch_values<float>(value_kind, val, col, x, y, S, w, C, m, s);
    case 1: return launch_values<double>(value_kind, val, col, x, y, S, w, C, m, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
