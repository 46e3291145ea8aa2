// Fused-stream PackSELL SpMV (K1) and SpMM (K3) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/packsell_spmv.py:
//   K1  packsell_spmv_fused (:567; _kernel_fused, decode fused_decode_word)
//   K3  packsell_spmm_fused (:620; _kernel_fused_mm)
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
// read-only path into L2).
//
// K3's bound is the same words and checkpoints, X [m, nb] once and the
// output [G, C, nb] once (at nb = 8: 144 + 4.5 + 36 + 36 MB, ~66 us). With
// one thread per (group, lane, rhs) each word is loaded and decoded nb
// times, and on the H100 the time grows in proportion to nb (0.075, 0.122,
// 0.221, 0.409 ms at nb = 1, 2, 4, 8; PERF.md). So K3 runs K1's threads,
// one per (group, lane), with K1's 128-byte word reads per warp step, and
// keeps the sums of up to 8 right-hand sides in registers (a second grid
// axis takes nb > 8 in chunks of 8; the chunk's width picks a body
// compiled for it, so the sums stay in registers and no load waits on a
// predicate). Each word is loaded once, evict-first in L2; a batch of
// kFusedBatch words is loaded, decoded and has all its X rows (nbc floats
// each) issued before the sums. X rows are read with 16-byte vector loads
// when the wrapper finds nb % 4 == 0 and X 16-byte aligned (else scalar
// loads), evict-last, so the 144 MB of words do not push the 36 MB of X
// out of the 50 MB L2; part[g, c, :] is written with 16-byte stores on the
// same condition.

#include <cstdint>
#include <cuda_runtime.h>

#include "packsell_decode.cuh"

namespace {

using namespace packsell;  // decode_word, clamp_col, load_row, the enumerators

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

constexpr int kMaxRhs = 8;      // K3: right-hand sides per thread
constexpr int kFusedBatch = 4;  // K3: word loads in flight per thread

// The next n words of one (group, lane), n = kFusedBatch when FULL: the
// word loads, the decode and every X row of the batch are issued before
// the sums, which add each rhs's products in j order from the first.
template <int ENC, int CODEC, int NB, bool VEC, bool FULL>
__device__ __forceinline__ void spmm_batch(const uint32_t* __restrict__ wp,
                                           int C, int n, bool first,
                                           int64_t ck, const float* xb, int nb,
                                           int64_t mlim, const DecodeArgs& a,
                                           uint64_t words_pol, uint64_t x_pol,
                                           float (&acc)[NB]) {
  uint32_t wv[kFusedBatch];
#pragma unroll
  for (int k = 0; k < kFusedBatch; ++k) {
    wv[k] = (FULL || k < n) ? ld_hint(wp + k * C, words_pol) : 0u;
  }
  float v[kFusedBatch];
  float xv[kFusedBatch][NB];
#pragma unroll
  for (int k = 0; k < kFusedBatch; ++k) {
    uint32_t off;
    decode_word<ENC, CODEC>(wv[k], a, v[k], off);
    if (FULL || k < n) {
      load_row<NB, VEC>(xb + clamp_col(ck + off, mlim) * nb, x_pol, xv[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kFusedBatch; ++k) {
    if (FULL || k < n) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float p = __fmul_rn(v[k], xv[k][b]);
        acc[b] = (first && k == 0) ? p : __fadd_rn(acc[b], p);
      }
    }
  }
}

// K3 for NB right-hand sides of one (group, lane): part[t, b0:b0+NB].
template <int ENC, int CODEC, int NB, bool VEC>
__device__ __forceinline__ void spmm_lane(const uint32_t* __restrict__ wp,
                                          int64_t ck, const float* xb,
                                          float* o, int wr, int C, int nb,
                                          int64_t mlim, const DecodeArgs& a) {
  const uint64_t words_pol = l2_evict_first();
  const uint64_t x_pol = l2_evict_last();
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.0f;   // wr = 0 writes +0
  int j = 0;
  for (; j + kFusedBatch <= wr; j += kFusedBatch) {
    spmm_batch<ENC, CODEC, NB, VEC, true>(
        wp + static_cast<int64_t>(j) * C, C, kFusedBatch, j == 0, ck, xb, nb,
        mlim, a, words_pol, x_pol, acc);
  }
  if (j < wr) {
    spmm_batch<ENC, CODEC, NB, VEC, false>(
        wp + static_cast<int64_t>(j) * C, C, wr - j, j == 0, ck, xb, nb,
        mlim, a, words_pol, x_pol, acc);
  }
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      reinterpret_cast<float4*>(o)[q] = make_float4(
          acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) o[b] = acc[b];
  }
}

// One thread per (group, lane); blockIdx.y picks the chunk of up to
// kMaxRhs right-hand sides, whose width selects the body at compile time
// (VEC: the wrapper found nb % 4 == 0, so the chunk is 4 or 8 wide).
template <int ENC, int CODEC, bool VEC>
__global__ void spmm_fused_kernel(const uint32_t* __restrict__ words,
                      const int32_t* __restrict__ ckpt,
                      const float* __restrict__ x, float* __restrict__ part,
                      int GC, int wr, int C, int nb, int64_t mlim,
                      DecodeArgs a) {
  const int t = static_cast<int>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= GC) return;
  const int g = t / C;
  const int c = t - g * C;
  const int b0 = static_cast<int>(blockIdx.y) * kMaxRhs;
  const int nbc = min(kMaxRhs, nb - b0);
  const uint32_t* __restrict__ wp =
      words + static_cast<int64_t>(g) * wr * C + c;
  const int64_t ck = ckpt[t];
  const float* xb = x + b0;
  float* o = part + static_cast<int64_t>(t) * nb + b0;
#define K3_LANE(NB, V) \
  spmm_lane<ENC, CODEC, NB, V>(wp, ck, xb, o, wr, C, nb, mlim, a)
  if constexpr (VEC) {
    if (nbc == 8) K3_LANE(8, true); else K3_LANE(4, true);
  } else {
    switch (nbc) {
      case 1: K3_LANE(1, false); break;
      case 2: K3_LANE(2, false); break;
      case 3: K3_LANE(3, false); break;
      case 4: K3_LANE(4, false); break;
      case 5: K3_LANE(5, false); break;
      case 6: K3_LANE(6, false); break;
      case 7: K3_LANE(7, false); break;
      default: K3_LANE(8, false); break;
    }
  }
#undef K3_LANE
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
  int nb;    // 0: SpMV (K1); >= 1: SpMM (K3)
  bool vec;  // K3: 16-byte X loads and part stores
  int64_t mlim;
  DecodeArgs a;
  cudaStream_t stream;
};

template <int ENC, int CODEC>
void launch(const LaunchArgs& p) {
  const int64_t n = p.G * p.C;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (p.nb == 0) {
    spmv_fused_kernel<ENC, CODEC><<<blocks, kThreads, 0, p.stream>>>(
        p.words, p.ckpt, p.x, p.part, p.G, p.wr, p.C, p.mlim, p.a);
    return;
  }
  const dim3 grid(blocks, static_cast<unsigned>((p.nb + kMaxRhs - 1) / kMaxRhs));
  const int gc = static_cast<int>(n);
  if (p.vec) {
    spmm_fused_kernel<ENC, CODEC, true><<<grid, kThreads, 0, p.stream>>>(
        p.words, p.ckpt, p.x, p.part, gc, p.wr, p.C, p.nb, p.mlim, p.a);
  } else {
    spmm_fused_kernel<ENC, CODEC, false><<<grid, kThreads, 0, p.stream>>>(
        p.words, p.ckpt, p.x, p.part, gc, p.wr, p.C, p.nb, p.mlim, p.a);
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
// the launch: 0 when the launch was accepted. G * C (* nb) must be > 0; for
// K3, G * C < 2^31, and vec != 0 only when nb % 4 == 0 and x and part are
// 16-byte aligned.
extern "C" int packsell_spmv_fused(const void* words, const void* ckpt,
                                   const void* x, void* part, int64_t G, int wr,
                                   int C, int64_t m, int encoding, int codec,
                                   int D, float scale, void* stream) {
  const LaunchArgs p{static_cast<const uint32_t*>(words),
                     static_cast<const int32_t*>(ckpt),
                     static_cast<const float*>(x), static_cast<float*>(part),
                     G, wr, C, 0, false, m - 1, DecodeArgs{D, scale},
                     static_cast<cudaStream_t>(stream)};
  return dispatch(encoding, codec, p);
}

extern "C" int packsell_spmm_fused(const void* words, const void* ckpt,
                                   const void* x, void* part, int64_t G, int wr,
                                   int C, int nb, int vec, int64_t m,
                                   int encoding, int codec, int D, float scale,
                                   void* stream) {
  const LaunchArgs p{static_cast<const uint32_t*>(words),
                     static_cast<const int32_t*>(ckpt),
                     static_cast<const float*>(x), static_cast<float*>(part),
                     G, wr, C, nb, vec != 0, m - 1, DecodeArgs{D, scale},
                     static_cast<cudaStream_t>(stream)};
  return dispatch(encoding, codec, p);
}
