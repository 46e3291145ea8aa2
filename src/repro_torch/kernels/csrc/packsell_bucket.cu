// Per-bucket PackSELL SpMV (K4), band-windowed SpMV (K6) and multi-RHS
// SpMM (K5) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/packsell_spmv.py:
//   K4  packsell_spmv_bucket      (_kernel_full, _kernel_full_ckpt)
//   K6  packsell_spmv_band_bucket (_kernel_band, _kernel_band_ckpt)
//   K5  packsell_spmm_bucket      (_kernel_spmm, _kernel_spmm_ckpt)
//
// What they compute, over one width bucket of canonical PackSELL words
// uint32[S, w, C] (lane axis minor): each stored row (s, c) walks its words
// with a column cursor, cur += delta(word), and adds v(word) * x[col(cur)].
//   Carry body (no checkpoints): the cursor starts at d0[s] and walks all w
//     words; the output is y float32[S, C] (K5: [S, C, nb]).
//   Checkpoint body: the cursor of width block wi starts at ckpt[s, wi, c],
//     the exact cursor before word wi * wb, and walks that block's wb
//     words; the output is partials float32[nw, S, C] (K5: [nw, S, C, nb]),
//     which the caller adds in wi order with one torch function shared with
//     the plain versions.
// col(cur):
//   K4, K5: clamp(cur, 0, m-1), the jnp scan body's rule. The Pallas kernel
//     clamps to len(xp)-1 over x zero-padded to a multiple of 128 and so
//     reads 0 for a column past m.
//   K6: base = win[s / sb] * hw, local = clamp(cur - base, 0, 2hw-1), and
//     x[base + local] reads 0 at and past m: the reference's window over x
//     zero-padded by (-m) % hw + hw, without the padded copy.
// So K4 and K6 differ only where a PAD word's cursor lies past m - 1 and
// x[m-1] is not finite. PAD words decode to v = 0 and delta 0 and are not
// skipped: 0 * inf = NaN survives, as in K1.
//
// Bit-exactness: __fmul_rn / __fadd_rn in j order from acc = 0, the order
// of the plain PyTorch versions, so nvcc cannot contract them into an FMA.
//
// Bound on the H100: bytes. A call reads every word once (4 B), d0 or the
// checkpoints (4 B per slice, or per (slice, block, lane)), x (gathered
// through L2; 4.5 MB at HPCG 104^3) and writes 4 B per output. One thread
// per (slice, width block, lane), lanes minor: a warp covers the 32 lanes
// of one (slice, block), so each j step reads 128 contiguous bytes of
// words. K5 keeps the sums of up to 8 right-hand sides in registers and
// reads each word once for them (a second grid axis takes nb > 8 in
// groups of 8). K6 reads x straight through L2 with the clip: staging its
// 2*hw window in shared memory would move more bytes than the words at
// HPCG 104^3 (ROADMAP.md, open questions).

#include <cstdint>
#include <cuda_runtime.h>

#include "packsell_decode.cuh"

namespace {

using namespace packsell;  // decode_word, clamp_col, the enumerators

constexpr int kThreads = 256;
constexpr int kMaxRhs = 8;  // K5: right-hand sides per thread

enum Kind { KIND_FULL = 0, KIND_BAND = 1, KIND_SPMM = 2 };

struct BucketArgs {
  const uint32_t* words;  // [S, w, C]
  const int32_t* d0;      // [S]: carry body seeds
  const int32_t* ckpt;    // [S, nw, C], or null for the carry body
  const int32_t* win;     // [ceil(S / sb)]: K6 window ids (half-windows)
  const float* x;         // [m], or [m, nb] row-major for K5
  float* out;             // [nw, S, C(, nb)]; nw = 1 for the carry body
  int64_t S;
  int w, C;
  int wb, nw;             // carry body: wb = w, nw = 1
  int nb;                 // K5: right-hand sides
  int64_t m;
  int sb;                 // K6: slices per window
  int64_t hw;             // K6: half-window (elements)
  DecodeArgs a;
};

// One thread's stored row: (slice s, width block wi, lane c), its first
// cursor and its word range [j0, j1). Thread t is row t of [S, nw, C], so
// t also indexes the checkpoints.
struct Row {
  int64_t s;
  int wi, c, j0, j1;
  int64_t cur;
};

__device__ __forceinline__ bool locate(const BucketArgs& p, Row& r) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t per_slice = static_cast<int64_t>(p.nw) * p.C;
  if (t >= p.S * per_slice) return false;
  r.s = t / per_slice;
  const int rem = static_cast<int>(t - r.s * per_slice);
  r.wi = rem / p.C;
  r.c = rem - r.wi * p.C;
  r.j0 = r.wi * p.wb;
  r.j1 = min(r.j0 + p.wb, p.w);
  r.cur = p.ckpt ? p.ckpt[t] : p.d0[r.s];
  return true;
}

// Offset of a row's output in [nw, S, C].
__device__ __forceinline__ int64_t out_row(const BucketArgs& p, const Row& r) {
  return (static_cast<int64_t>(r.wi) * p.S + r.s) * p.C + r.c;
}

template <int CODEC, bool BAND>
__global__ void bucket_spmv_kernel(BucketArgs p) {
  Row r;
  if (!locate(p, r)) return;
  const uint32_t* wp = p.words + r.s * p.w * p.C + r.c;
  const int64_t base = BAND ? static_cast<int64_t>(p.win[r.s / p.sb]) * p.hw : 0;
  const int64_t lim = BAND ? 2 * p.hw - 1 : p.m - 1;
  int64_t cur = r.cur;
  float acc = 0.0f;
  for (int j = r.j0; j < r.j1; ++j) {
    float v;
    uint32_t d;
    decode_word<ENC_WORDS, CODEC>(wp[static_cast<int64_t>(j) * p.C], p.a, v, d);
    cur += d;
    float xv;
    if (BAND) {
      const int64_t g = base + clamp_col(cur - base, lim);
      xv = g < p.m ? __ldg(p.x + g) : 0.0f;
    } else {
      xv = __ldg(p.x + clamp_col(cur, lim));
    }
    acc = __fadd_rn(acc, __fmul_rn(v, xv));
  }
  p.out[out_row(p, r)] = acc;
}

template <int CODEC>
__global__ void bucket_spmm_kernel(BucketArgs p) {
  Row r;
  if (!locate(p, r)) return;
  const int b0 = static_cast<int>(blockIdx.y) * kMaxRhs;
  const int nbc = min(kMaxRhs, p.nb - b0);
  const uint32_t* wp = p.words + r.s * p.w * p.C + r.c;
  const int64_t mlim = p.m - 1;
  int64_t cur = r.cur;
  float acc[kMaxRhs];
#pragma unroll
  for (int b = 0; b < kMaxRhs; ++b) acc[b] = 0.0f;
  for (int j = r.j0; j < r.j1; ++j) {
    float v;
    uint32_t d;
    decode_word<ENC_WORDS, CODEC>(wp[static_cast<int64_t>(j) * p.C], p.a, v, d);
    cur += d;
    const float* xr = p.x + clamp_col(cur, mlim) * p.nb + b0;
#pragma unroll
    for (int b = 0; b < kMaxRhs; ++b) {
      if (b < nbc) acc[b] = __fadd_rn(acc[b], __fmul_rn(v, __ldg(xr + b)));
    }
  }
  float* o = p.out + out_row(p, r) * p.nb + b0;
#pragma unroll
  for (int b = 0; b < kMaxRhs; ++b) {
    if (b < nbc) o[b] = acc[b];
  }
}

template <int CODEC>
void launch(int kind, const BucketArgs& p, cudaStream_t stream) {
  const int64_t n = p.S * p.nw * p.C;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (kind == KIND_FULL) {
    bucket_spmv_kernel<CODEC, false><<<blocks, kThreads, 0, stream>>>(p);
  } else if (kind == KIND_BAND) {
    bucket_spmv_kernel<CODEC, true><<<blocks, kThreads, 0, stream>>>(p);
  } else {
    const dim3 grid(blocks, static_cast<unsigned>((p.nb + kMaxRhs - 1) / kMaxRhs));
    bucket_spmm_kernel<CODEC><<<grid, kThreads, 0, stream>>>(p);
  }
}

}  // namespace

// C interface (loaded with ctypes). kind: 0 K4, 1 K6, 2 K5; codec as in
// packsell_decode.cuh; ckpt null selects the carry body (then wb = w and
// nw = 1). Returns cudaGetLastError() after the launch: 0 when the launch
// was accepted. S * nw * C (and nb for K5) must be > 0 and m >= 1.
extern "C" int packsell_bucket(int kind, const void* words, const void* d0,
                               const void* ckpt, const void* win,
                               const void* x, void* out, int64_t S, int w,
                               int C, int wb, int nw, int nb, int64_t m,
                               int sb, int64_t hw, int codec, int D,
                               float scale, void* stream) {
  if (kind < KIND_FULL || kind > KIND_SPMM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BucketArgs p{static_cast<const uint32_t*>(words),
                     static_cast<const int32_t*>(d0),
                     static_cast<const int32_t*>(ckpt),
                     static_cast<const int32_t*>(win),
                     static_cast<const float*>(x),
                     static_cast<float*>(out),
                     S, w, C, wb, nw, nb, m, sb, hw, DecodeArgs{D, scale}};
  auto s = static_cast<cudaStream_t>(stream);
  switch (codec) {
    case CODEC_FP16: launch<CODEC_FP16>(kind, p, s); break;
    case CODEC_BF16: launch<CODEC_BF16>(kind, p, s); break;
    case CODEC_E8M: launch<CODEC_E8M>(kind, p, s); break;
    case CODEC_FIXED: launch<CODEC_FIXED>(kind, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
