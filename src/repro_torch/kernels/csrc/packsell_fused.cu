// Fused-stream PackSELL SpMV (K1) and SpMM (K3) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/packsell_spmv.py:
//   K1  packsell_spmv_fused (_kernel_fused, decode fused_decode_word)
//   K3  packsell_spmm_fused (_kernel_fused_mm)
//
// What they compute: group partials over the plan's fused word stream
//   part[g, c(, b)] = sum_j v(w[g,j,c]) * x[clamp(ckpt[g,c] + off(w[g,j,c]), 0, m-1)(, b)]
// with words uint32[G, wr, C] (lane axis minor), checkpoints int32[G, C],
// x float32[m] (K1) or [m, nb] row-major (K3), accumulated in float32.
// Every word's column offset is re-based to its group checkpoint at plan
// build time, so no cursor is carried: each (group, lane) is independent.
//
// The clamp is the jnp fused body's (plan.py, jnp.take mode="clip" over
// x of length m), not the Pallas kernel's len(xp)-1 over x zero-padded to
// a multiple of 128; the two differ only for columns >= m, which only the
// PAD words of sigma-padding rows reach. PAD words (0) decode to v = 0 and
// offset 0 and are NOT skipped: 0 * x[ckpt] keeps 0 * inf = NaN, as the
// reference does.
//
// The word decode and the clamp live in packsell_decode.cuh, shared with
// the per-bucket kernels (packsell_bucket.cu).
//
// Bit-exactness: products and sums are __fmul_rn / __fadd_rn in j order
// starting from the first product, so nvcc cannot contract them into an
// FMA and each kernel equals its plain PyTorch version bit for bit.
//
// Bound on the H100: bytes. Per call K1 reads the words once (4 B each),
// the checkpoints (4 B per group lane), x (gathered; at HPCG 104^3 x is
// 4.5 MB and stays in the 50 MB L2) and writes 4 B per group lane. At
// 104^3 (wr = 32, C = 32, G = 35,152) that is ~158 MB, a bound of ~47 us at
// 3.35 TB/s. The design streams the words coalesced: one thread per
// (group, lane), a warp covers 32 consecutive lanes of one group, so each
// j step reads 128 contiguous bytes per warp; x goes through __ldg (the
// read-only path into L2). K3 uses one thread per (group, lane, rhs), rhs
// minor, so a warp's x reads and output writes are contiguous over rhs
// and the word read is a broadcast.

#include <cstdint>
#include <cuda_runtime.h>

#include "packsell_decode.cuh"

namespace {

using namespace packsell;  // decode_word, clamp_col, the enumerators

template <int ENC, int CODEC>
__global__ void spmv_fused_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ ckpt,
                                  const float* __restrict__ x,
                                  float* __restrict__ part, int64_t G, int wr,
                                  int C, int64_t mlim, DecodeArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= G * C) return;
  const int64_t g = t / C;
  const int c = static_cast<int>(t - g * C);
  const int64_t ck = ckpt[t];
  const uint32_t* wp = words + g * wr * C + c;
  float acc = 0.0f;
  for (int j = 0; j < wr; ++j) {
    float v;
    uint32_t off;
    decode_word<ENC, CODEC>(wp[static_cast<int64_t>(j) * C], a, v, off);
    const float p = __fmul_rn(v, __ldg(x + clamp_col(ck + off, mlim)));
    acc = j == 0 ? p : __fadd_rn(acc, p);
  }
  part[t] = acc;
}

template <int ENC, int CODEC>
__global__ void spmm_fused_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ ckpt,
                                  const float* __restrict__ x,
                                  float* __restrict__ part, int64_t G, int wr,
                                  int C, int nb, int64_t mlim, DecodeArgs a) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= G * C * nb) return;
  const int64_t gc = t / nb;
  const int b = static_cast<int>(t - gc * nb);
  const int64_t g = gc / C;
  const int c = static_cast<int>(gc - g * C);
  const int64_t ck = ckpt[gc];
  const uint32_t* wp = words + g * wr * C + c;
  float acc = 0.0f;
  for (int j = 0; j < wr; ++j) {
    float v;
    uint32_t off;
    decode_word<ENC, CODEC>(wp[static_cast<int64_t>(j) * C], a, v, off);
    const float p = __fmul_rn(v, __ldg(x + clamp_col(ck + off, mlim) * nb + b));
    acc = j == 0 ? p : __fadd_rn(acc, p);
  }
  part[t] = acc;
}

constexpr int kThreads = 256;

struct LaunchArgs {
  const uint32_t* words;
  const int32_t* ckpt;
  const float* x;
  float* part;
  int64_t G;
  int wr;
  int C;
  int nb;  // 0: SpMV (K1); >= 1: SpMM (K3)
  int64_t mlim;
  DecodeArgs a;
  cudaStream_t stream;
};

template <int ENC, int CODEC>
void launch(const LaunchArgs& p) {
  const int64_t n = p.G * p.C * (p.nb ? p.nb : 1);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (p.nb == 0) {
    spmv_fused_kernel<ENC, CODEC><<<blocks, kThreads, 0, p.stream>>>(
        p.words, p.ckpt, p.x, p.part, p.G, p.wr, p.C, p.mlim, p.a);
  } else {
    spmm_fused_kernel<ENC, CODEC><<<blocks, kThreads, 0, p.stream>>>(
        p.words, p.ckpt, p.x, p.part, p.G, p.wr, p.C, p.nb, p.mlim, p.a);
  }
}

// Picks the template instance; the canonical codec matters only for
// ENC_WORDS (the 16/16 encodings carry their own value layout).
int dispatch(int encoding, int codec, const LaunchArgs& p) {
  switch (encoding) {
    case ENC_F16: launch<ENC_F16, CODEC_FP16>(p); break;
    case ENC_TOP16: launch<ENC_TOP16, CODEC_FP16>(p); break;
    case ENC_FIXED16: launch<ENC_FIXED16, CODEC_FP16>(p); break;
    case ENC_WORDS:
      switch (codec) {
        case CODEC_FP16: launch<ENC_WORDS, CODEC_FP16>(p); break;
        case CODEC_BF16: launch<ENC_WORDS, CODEC_BF16>(p); break;
        case CODEC_E8M: launch<ENC_WORDS, CODEC_E8M>(p); break;
        case CODEC_FIXED: launch<ENC_WORDS, CODEC_FIXED>(p); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). Each returns cudaGetLastError() after
// the launch: 0 when the launch was accepted. G * C (* nb) must be > 0.
extern "C" int packsell_spmv_fused(const void* words, const void* ckpt,
                                   const void* x, void* part, int64_t G, int wr,
                                   int C, int64_t m, int encoding, int codec,
                                   int D, float scale, void* stream) {
  const LaunchArgs p{static_cast<const uint32_t*>(words),
                     static_cast<const int32_t*>(ckpt),
                     static_cast<const float*>(x), static_cast<float*>(part),
                     G, wr, C, 0, m - 1, DecodeArgs{D, scale},
                     static_cast<cudaStream_t>(stream)};
  return dispatch(encoding, codec, p);
}

extern "C" int packsell_spmm_fused(const void* words, const void* ckpt,
                                   const void* x, void* part, int64_t G, int wr,
                                   int C, int nb, int64_t m, int encoding,
                                   int codec, int D, float scale, void* stream) {
  const LaunchArgs p{static_cast<const uint32_t*>(words),
                     static_cast<const int32_t*>(ckpt),
                     static_cast<const float*>(x), static_cast<float*>(part),
                     G, wr, C, nb, m - 1, DecodeArgs{D, scale},
                     static_cast<cudaStream_t>(stream)};
  return dispatch(encoding, codec, p);
}
