// The PackSELL word decode shared by every PackSELL kernel of repro_torch:
// the fused-stream kernels (K1, K3 in packsell_fused.cu) and the
// per-bucket kernels (K4, K5, K6 in packsell_bucket.cu).
//
// It is the device twin of core/codecs.py unpack_words_torch (the paper's
// Fig. 3b branch-free unpack, reference repro/core/codecs.py
// unpack_words_jnp) and of kernels/packsell_spmv.py fused_decode_word for
// the 16/16 split encodings of the fused stream.
#pragma once

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace packsell {

// Encodings of the fused stream (plan.FusedLayout.encoding). The
// per-bucket kernels read canonical words: ENC_WORDS.
enum Encoding { ENC_F16 = 0, ENC_TOP16 = 1, ENC_FIXED16 = 2, ENC_WORDS = 3 };
// Codecs of the canonical word (core/codecs.py), used by ENC_WORDS.
enum Codec { CODEC_FP16 = 0, CODEC_BF16 = 1, CODEC_E8M = 2, CODEC_FIXED = 3 };

struct DecodeArgs {
  int D;        // delta width of the canonical words
  float scale;  // fixed16: dequant scale; ENC_WORDS + fixed: 2^-frac
};

// (value, column field) of one word. For a fused-stream word the field is
// the run-local column offset from the group checkpoint; for a canonical
// bucket word it is the delta to add to the row's column cursor.
template <int ENC, int CODEC>
__device__ __forceinline__ void decode_word(uint32_t w, const DecodeArgs& a,
                                            float& v, uint32_t& off) {
  if (ENC == ENC_F16) {
    v = __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
    off = w & 0xFFFFu;
  } else if (ENC == ENC_TOP16) {
    v = __uint_as_float(w & 0xFFFF0000u);
    off = w & 0xFFFFu;
  } else if (ENC == ENC_FIXED16) {
    v = __fmul_rn(__int2float_rn(static_cast<int32_t>(w) >> 16), a.scale);
    off = w & 0xFFFFu;
  } else {
    // canonical branch-free unpack (paper Fig. 3b); shift <= 30, so no
    // shift reaches the word width
    const uint32_t flag = w & 1u;
    const uint32_t shift = static_cast<uint32_t>(31 - a.D) * flag;
    off = (w << shift) >> (shift + 1u);
    const uint32_t vbits = flag ? (w & ~((2u << a.D) - 1u)) : 0u;
    if (CODEC == CODEC_FP16) {
      v = __half2float(__ushort_as_half(static_cast<unsigned short>(vbits >> 16)));
    } else if (CODEC == CODEC_BF16) {
      v = __uint_as_float(vbits & 0xFFFF0000u);
    } else if (CODEC == CODEC_E8M) {
      v = __uint_as_float(vbits);
    } else {
      v = __fmul_rn(__int2float_rn(static_cast<int32_t>(vbits) >> (a.D + 1)),
                    a.scale);
    }
  }
}

__device__ __forceinline__ int64_t clamp_col(int64_t col, int64_t mlim) {
  return col < 0 ? 0 : (col > mlim ? mlim : col);
}

// L2 eviction policies (PTX createpolicy) for K3 to K6: the streamed
// words are read once and leave L2 first; x (K4, K6) and X (K3, K5) are
// gathered again and again and stay. The loads are read-only (.nc)
// and plain asm (not volatile), so the compiler may schedule them.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint32_t ld_hint(const uint32_t* p, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ float ld_hint(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

// four floats from a 16-byte aligned address
__device__ __forceinline__ float4 ld_hint4(const float* p, uint64_t pol) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol));
  return v;
}

// One X row's NB floats for the multi-RHS kernels (K3, K5), with the
// policy pol (VEC: NB / 4 16-byte loads from a 16-byte aligned row).
template <int NB, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ xr,
                                         uint64_t pol, float (&xv)[NB]) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      const float4 f = ld_hint4(xr + 4 * q, pol);
      xv[4 * q] = f.x; xv[4 * q + 1] = f.y;
      xv[4 * q + 2] = f.z; xv[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) xv[b] = ld_hint(xr + b, pol);
  }
}

}  // namespace packsell
