// Per-bucket PackSELL SpMV (K4), band-windowed SpMV (K6) and multi-RHS
// SpMM (K5) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of src/repro/kernels/packsell_spmv.py:
//   K4  packsell_spmv_bucket      (:133; _kernel_full, _kernel_full_ckpt)
//   K6  packsell_spmv_band_bucket (:271; _kernel_band, _kernel_band_ckpt)
//   K5  packsell_spmm_bucket      (:412; _kernel_spmm, _kernel_spmm_ckpt)
//
// What they compute, over width buckets of canonical PackSELL words
// uint32[S, w, C] (lane axis minor): each stored row (s, c) walks its words
// with a column cursor, cur += delta(word), and adds v(word) * x[col(cur)].
// A row's words fall in width blocks of wb (the carry body: one block of
// all w words). Each block's sum starts at +0 and adds its products in j
// order; the row's total is block 0, then + block wi for wi = 1, 2, ...
// (packsell_spmv.sum_width_partials).
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
// Bit-exactness: __fmul_rn / __fadd_rn in the order above, the order of
// the plain PyTorch versions, so nvcc cannot contract them into an FMA.
//
// K4: one launch per SpMV over all buckets of a `full` plan. A device
// table (packsell_spmv.bucket_table, built once with the plan) gives per
// bucket its word and d0 addresses, S, w, wb, nw, its first output row in
// the concatenated stored order and its first thread block; the kernel
// writes y float32[total_stored] with the width sum done in registers.
// Bound on the H100: bytes -- every word once (4 B), d0 (4 B per slice), x
// (4.5 MB at HPCG 104^3, gathered through L2) and one float per stored row;
// no partials and no checkpoints. One launch per bucket with one thread
// per (slice, width block, lane), checkpoint seeds, a 64-bit index split
// and one word in flight ran 1.6x K1's time on the same fp16 words on the
// H100, and the same ~2x its bound at e8m/D1 (two width blocks per row,
// twice the threads) as at e8m/D8 (one block): the parallel blocks bought
// nothing (PERF.md). So:
//   * one thread per stored row walks all of its row's width blocks; the
//     cursor it carries equals kckpt[s, wi, c] at each block start, so
//     the checkpoints are not read (3 % of the bytes) and no partials are
//     written and read back by a width-sum launch;
//   * the bucket comes from a search of the table by blockIdx, the row from
//     one 32-bit division by C; no 64-bit division;
//   * words are read kBatch j steps at a time into registers before the
//     decode and the gathers of that batch, so a thread has kBatch word
//     loads in flight, then kBatch gathers;
//   * the cursor is 32-bit (every cursor of a valid pack lies in
//     [0, max(d0, m-1)]; the wrapper raises for m >= 2^31);
//   * words are loaded read-only with an L2 evict-first policy and x with
//     evict-last, so the 144 MB of streamed words do not push x out.
//
// K5 and K6: one thread per (slice, width block, lane), lanes minor: a
// warp covers the 32 lanes of one (slice, block), so each j step reads 128
// contiguous bytes of words. The checkpoint body seeds block wi from
// ckpt[s, wi, c] and writes partials float32[nw, S, C(, nb)] that the
// caller adds with sum_width_partials; the carry body walks all w words
// from d0[s]. K5 keeps the sums of up to 8 right-hand sides in registers
// and reads each word once for them (a second grid axis takes nb > 8 in
// groups of 8). K6 reads x straight through L2 with the clip: staging its
// 2*hw window in shared memory would move more bytes than the words at
// HPCG 104^3 (ROADMAP.md, open questions).

#include <cstdint>
#include <cuda_runtime.h>

#include "packsell_decode.cuh"

namespace {

using namespace packsell;  // decode_word, clamp_col, the load helpers

constexpr int kThreads = 256;
constexpr int kMaxRhs = 8;  // K5: right-hand sides per thread
constexpr int kBatch = 8;   // K4: word loads in flight per thread

enum Kind { KIND_BAND = 0, KIND_SPMM = 1 };

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

template <int CODEC>
__global__ void band_spmv_kernel(BucketArgs p) {
  Row r;
  if (!locate(p, r)) return;
  const uint32_t* wp = p.words + r.s * p.w * p.C + r.c;
  const int64_t base = static_cast<int64_t>(p.win[r.s / p.sb]) * p.hw;
  const int64_t lim = 2 * p.hw - 1;
  int64_t cur = r.cur;
  float acc = 0.0f;
  for (int j = r.j0; j < r.j1; ++j) {
    float v;
    uint32_t d;
    decode_word<ENC_WORDS, CODEC>(wp[static_cast<int64_t>(j) * p.C], p.a, v, d);
    cur += d;
    const int64_t g = base + clamp_col(cur - base, lim);
    const float xv = g < p.m ? __ldg(p.x + g) : 0.0f;
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
  if (kind == KIND_BAND) {
    band_spmv_kernel<CODEC><<<blocks, kThreads, 0, stream>>>(p);
  } else {
    const dim3 grid(blocks, static_cast<unsigned>((p.nb + kMaxRhs - 1) / kMaxRhs));
    bucket_spmm_kernel<CODEC><<<grid, kThreads, 0, stream>>>(p);
  }
}

// ---------------------------------------------------------------------------
// K4: all buckets of a plan in one launch
// ---------------------------------------------------------------------------

// Columns of one bucket's row of the device table (int64, kTableCols per
// bucket; packsell_spmv.bucket_table writes it).
enum TableCol {
  TAB_WORDS = 0,  // address of the words [S, w, C]
  TAB_D0 = 1,     // address of d0 [S]
  TAB_S = 2,
  TAB_W = 3,
  TAB_WB = 4,     // width block (w for the carry body)
  TAB_NW = 5,     // width blocks (1 for the carry body)
  TAB_OUT = 6,    // first output row: rows of the buckets before it
  TAB_BLK = 7,    // first thread block
  kTableCols = 8
};

// The next n words of one row from wp (stride C), n = kBatch when FULL:
// the loads first, then the decode and the cursor, then the gathers, then
// the sum in j order. Words past n are not read and never added.
// A row's walk state between batches: its cursor and its block's sum.
// (Passed and returned by value: taken by reference, with a launch bound
// on the kernel, ptxas kept 32 registers and spilled 4-8 bytes.)
struct Walk {
  int cur;
  float acc;
};

template <int CODEC, bool FULL>
__device__ __forceinline__ Walk walk_batch(const uint32_t* __restrict__ wp,
                                           int C, int n, Walk st,
                                           const float* __restrict__ x,
                                           int mlim, DecodeArgs a,
                                           uint64_t words_pol,
                                           uint64_t x_pol) {
  int cur = st.cur;
  float acc = st.acc;
  uint32_t wv[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    wv[k] = (FULL || k < n) ? ld_hint(wp + k * C, words_pol) : 0u;
  }
  int col[kBatch];
  float v[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    uint32_t d;
    decode_word<ENC_WORDS, CODEC>(wv[k], a, v[k], d);
    cur = static_cast<int>(static_cast<uint32_t>(cur) + d);
    col[k] = max(0, min(cur, mlim));
  }
  float xv[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    xv[k] = (FULL || k < n) ? ld_hint(x + col[k], x_pol) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    if (FULL || k < n) acc = __fadd_rn(acc, __fmul_rn(v[k], xv[k]));
  }
  return Walk{cur, acc};
}

template <int CODEC>
__global__ void
    spmv_buckets_kernel(const int64_t* __restrict__ tab, int nbk, int C,
                        const float* __restrict__ x, float* __restrict__ y,
                        int mlim, DecodeArgs a) {
  int b = 0;
  while (b + 1 < nbk &&
         static_cast<int64_t>(blockIdx.x) >=
             __ldg(tab + (b + 1) * kTableCols + TAB_BLK)) {
    ++b;
  }
  const int64_t* e = tab + b * kTableCols;
  const int S = static_cast<int>(__ldg(e + TAB_S));
  const int t = static_cast<int>(blockIdx.x - __ldg(e + TAB_BLK)) * kThreads +
                static_cast<int>(threadIdx.x);
  if (t >= S * C) return;
  const int s = t / C;
  const int c = t - s * C;
  const int w = static_cast<int>(__ldg(e + TAB_W));
  const int wb = static_cast<int>(__ldg(e + TAB_WB));
  const int nw = static_cast<int>(__ldg(e + TAB_NW));
  const uint32_t* __restrict__ wp =
      reinterpret_cast<const uint32_t*>(__ldg(e + TAB_WORDS)) +
      static_cast<int64_t>(s) * w * C + c;
  const int32_t* d0 = reinterpret_cast<const int32_t*>(__ldg(e + TAB_D0));
  const uint64_t words_pol = l2_evict_first();
  const uint64_t x_pol = l2_evict_last();
  int cur = __ldg(d0 + s);
  float total = 0.0f;
  for (int wi = 0; wi < nw; ++wi) {
    const int j1 = min((wi + 1) * wb, w);
    Walk st{cur, 0.0f};
    int j = wi * wb;
    for (; j + kBatch <= j1; j += kBatch) {
      st = walk_batch<CODEC, true>(wp + static_cast<int64_t>(j) * C, C,
                                   kBatch, st, x, mlim, a, words_pol, x_pol);
    }
    if (j < j1) {
      st = walk_batch<CODEC, false>(wp + static_cast<int64_t>(j) * C, C,
                                    j1 - j, st, x, mlim, a, words_pol, x_pol);
    }
    cur = st.cur;
    total = wi == 0 ? st.acc : __fadd_rn(total, st.acc);
  }
  y[__ldg(e + TAB_OUT) + t] = total;
}

struct BucketsLaunch {
  const int64_t* tab;
  int nbk, blocks, C;
  const float* x;
  float* y;
  int mlim;
  DecodeArgs a;
  cudaStream_t stream;
};

template <int CODEC>
void launch_buckets(const BucketsLaunch& p) {
  spmv_buckets_kernel<CODEC><<<p.blocks, kThreads, 0, p.stream>>>(
      p.tab, p.nbk, p.C, p.x, p.y, p.mlim, p.a);
}

}  // namespace

// C interface (loaded with ctypes). kind: 0 K6, 1 K5; codec as in
// packsell_decode.cuh; ckpt null selects the carry body (then wb = w and
// nw = 1). Returns cudaGetLastError() after the launch: 0 when the launch
// was accepted. S * nw * C (and nb for K5) must be > 0 and m >= 1.
extern "C" int packsell_bucket(int kind, const void* words, const void* d0,
                               const void* ckpt, const void* win,
                               const void* x, void* out, int64_t S, int w,
                               int C, int wb, int nw, int nb, int64_t m,
                               int sb, int64_t hw, int codec, int D,
                               float scale, void* stream) {
  if (kind < KIND_BAND || kind > KIND_SPMM) {
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

// K4 over all buckets of a plan: tab is the device table (nbk rows of
// kTableCols int64, buckets with rows only), blocks the sum of their thread
// blocks, y float32[total_stored]. Needs nbk >= 1, blocks >= 1, m >= 1 and
// m - 1 < 2^31. Returns cudaGetLastError() after the launch.
extern "C" int packsell_spmv_buckets(const void* tab, int nbk, int blocks,
                                     int C, const void* x, void* y,
                                     int64_t m, int codec, int D, float scale,
                                     void* stream) {
  const BucketsLaunch p{static_cast<const int64_t*>(tab), nbk, blocks, C,
                        static_cast<const float*>(x), static_cast<float*>(y),
                        static_cast<int>(m - 1), DecodeArgs{D, scale},
                        static_cast<cudaStream_t>(stream)};
  switch (codec) {
    case CODEC_FP16: launch_buckets<CODEC_FP16>(p); break;
    case CODEC_BF16: launch_buckets<CODEC_BF16>(p); break;
    case CODEC_E8M: launch_buckets<CODEC_E8M>(p); break;
    case CODEC_FIXED: launch_buckets<CODEC_FIXED>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
