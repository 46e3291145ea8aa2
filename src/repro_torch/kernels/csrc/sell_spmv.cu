// SELL-C-sigma baseline SpMV (K2) for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/sell_spmv.py
// sell_spmv_bucket (_kernel): the paper's comparison point.
//
// What it computes, per width bucket:
//   y[s, c] = sum_j f32(val[s,j,c]) * x[clamp(col[s,j,c], 0, m-1)]
// with val {f16, bf16, f32, f64}[S, w, C], col int32[S, w, C] (padding:
// val 0, col 0), x float32[m], y float32[S, C]. The reference kernel
// clamps to len(xp)-1 over x zero-padded to a multiple of 128; SELL
// columns are < m by construction, so the clamp to m-1 reads the same x.
//
// Bit-exactness: __fmul_rn / __fadd_rn from acc = 0 in j order, as the
// plain PyTorch version adds, so nvcc cannot contract them into an FMA.
//
// Bound on the H100: bytes. It reads (value bytes + 4) per bucketed entry
// once, x (gathered, L2-resident at the main path's size) and writes 4 B
// per stored row. One thread per (slice, lane): a warp covers 32
// consecutive lanes, so each j step reads contiguous values and columns.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }

template <typename T>
__global__ void sell_spmv_kernel(const T* __restrict__ val,
                                 const int32_t* __restrict__ col,
                                 const float* __restrict__ x,
                                 float* __restrict__ y, int64_t S, int w, int C,
                                 int64_t mlim) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= S * C) return;
  const int64_t s = t / C;
  const int c = static_cast<int>(t - s * C);
  const int64_t base = s * w * C + c;
  float acc = 0.0f;
  for (int j = 0; j < w; ++j) {
    const int64_t k = base + static_cast<int64_t>(j) * C;
    int64_t cj = col[k];
    cj = cj < 0 ? 0 : (cj > mlim ? mlim : cj);
    acc = __fadd_rn(acc, __fmul_rn(to_f32(val[k]), __ldg(x + cj)));
  }
  y[t] = acc;
}

constexpr int kThreads = 256;

template <typename T>
void launch(const void* val, const void* col, const void* x, void* y,
            int64_t S, int w, int C, int64_t m, cudaStream_t stream) {
  const int64_t n = S * C;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sell_spmv_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(val), static_cast<const int32_t*>(col),
      static_cast<const float*>(x), static_cast<float*>(y), S, w, C, m - 1);
}

}  // namespace

// C interface (loaded with ctypes). value_kind: 0 f16, 1 bf16, 2 f32,
// 3 f64. Returns cudaGetLastError() after the launch. S * C must be > 0.
extern "C" int sell_spmv_bucket(const void* val, const void* col, const void* x,
                                void* y, int64_t S, int w, int C, int64_t m,
                                int value_kind, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (value_kind) {
    case 0: launch<__half>(val, col, x, y, S, w, C, m, s); break;
    case 1: launch<__nv_bfloat16>(val, col, x, y, S, w, C, m, s); break;
    case 2: launch<float>(val, col, x, y, S, w, C, m, s); break;
    case 3: launch<double>(val, col, x, y, S, w, C, m, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
