// Per-bucket PackSELL SpMV (K4), band-windowed SpMV (K6) and multi-RHS
// SpMM (K5) for Hopper (sm_90a), each one launch over all buckets of a
// plan.
//
// Replaces the Pallas kernels of src/repro/kernels/packsell_spmv.py:
//   K4  packsell_spmv_bucket      (:133; _kernel_full, _kernel_full_ckpt)
//   K6  packsell_spmv_band_bucket (:271; _kernel_band, _kernel_band_ckpt)
//   K5  packsell_spmm_bucket      (:412; _kernel_spmm, _kernel_spmm_ckpt)
//
// What they compute, over width buckets of canonical PackSELL words
// uint32[S, w, C] (lane axis minor): each stored row (s, c) walks its words
// with a column cursor from d0[s], cur += delta(word), and adds
// v(word) * x[col(cur)]. A row's words fall in width blocks of wb (the
// carry body: one block of all w words). Each block's sum starts at +0 and
// adds its products in j order; the row's total is block 0, then + block
// wi for wi = 1, 2, ... (packsell_spmv.sum_width_partials). K5 does this
// per right-hand side of X float32[m, nb] (row-major).
// col(cur):
//   K4, K5: clamp(cur, 0, m-1), the jnp scan body's rule. The Pallas kernel
//     clamps to len(xp)-1 over x zero-padded to a multiple of 128 and so
//     reads 0 for a column past m.
//   K6: base = win[s / sb] * hw, g = base + clamp(cur - base, 0, 2hw-1),
//     and x[g] reads 0 at and past m: the reference's window over x
//     zero-padded by (-m) % hw + hw, without the padded copy.
// So K4 and K6 differ only where a PAD word's cursor lies past m - 1 and
// x[m-1] is not finite. PAD words decode to v = 0 and delta 0 and are not
// skipped: 0 * inf = NaN survives, as in K1.
//
// Bit-exactness: __fmul_rn / __fadd_rn in the order above, the order of
// the plain PyTorch versions, so nvcc cannot contract them into an FMA.
// (K3 starts each sum from its first product; these kernels start from +0,
// which differs from it on a -0 product.)
//
// One launch per SpMV or SpMM over all buckets: a device table
// (packsell_spmv.bucket_table, built once with the plan) gives per bucket
// its word, d0 and window addresses, S, w, wb, nw, sb, its first output row
// in the concatenated stored order and its first thread block; the kernels
// write y float32[total_stored] (K5: [total_stored, nb]) with the width sum
// done in registers.
// Bound on the H100: bytes -- every word once (4 B), d0 (4 B per slice),
// x or X (gathered through L2; 4.5 MB at HPCG 104^3, 36 MB for X at
// nb = 8), K6's windows (4 B per sb slices) and the output once; no
// partials and no checkpoints. One launch per bucket with one thread per
// (slice, width block, lane), checkpoint seeds, a 64-bit index split and
// one word in flight ran 1.6x K1's time on the same fp16 words, and the
// same ~2x its bound at e8m/D1 (two width blocks per row, twice the
// threads) as at e8m/D8 (one block): the parallel blocks bought nothing
// (PERF.md). So:
//   * one thread per stored row walks all of its row's width blocks; the
//     cursor it carries equals kckpt[s, wi, c] at each block start, so
//     the checkpoints are not read (3 % of the bytes) and no partials are
//     written and read back by a width-sum launch;
//   * the bucket comes from a search of the table by blockIdx.x, the row
//     from one 32-bit division by C; no 64-bit division;
//   * words are read a batch of j steps at a time into registers before
//     the decode and the gathers of that batch, so a thread has a batch of
//     word loads in flight, then a batch of gathers (K5: every X row of the
//     batch is issued before the sums);
//   * the cursor is 32-bit (every cursor of a valid pack lies in
//     [0, max(d0, m-1)]; the wrappers raise where that, or K6's window
//     end, could reach 2^31);
//   * words are loaded read-only with an L2 evict-first policy and x (X)
//     with evict-last, so the 144 MB of streamed words do not push x out.
// K6 is K4's walk with its column rule (a template flag): it reads x
// straight through L2, since staging its 2*hw window in shared memory
// would move more bytes than the words at HPCG 104^3 (PERF.md, open
// questions). K5 keeps the sums of a chunk of up to 8 right-hand sides in
// registers and reads each word once for them; blockIdx.y picks the chunk.
// Each chunk width has its own body, so no load waits on a predicate, and
// for nb <= 8 (one chunk) its own kernel, whose registers are that body's
// alone: one kernel holding all eight bodies took the nb = 8 body's 88
// registers and ran nb = 1 at 1.6x its bound (1.29x as its own kernel). X
// rows are read (and output rows written) with 16-byte vector accesses
// when the wrapper finds nb % 4 == 0 and X 16-byte aligned. Both kernels
// carry launch bounds that trade registers for resident threads (below).

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "packsell_decode.cuh"

namespace {

using namespace packsell;  // decode_word, load_row, the load helpers

constexpr int kThreads = 256;
constexpr int kBatch = 8;   // K4, K6: word loads in flight per thread
constexpr int kMaxRhs = 8;  // K5: right-hand sides per thread

// K5's word loads in flight per thread for an NB-wide body: its batch holds
// NB X floats per word in registers. With spmm_min_blocks these are the
// fastest of the settings measured on the H100 that spill nothing
// (PERF.md): 8 words a batch up to NB = 2, 6 up to 4, then 4.
template <int NB>
__host__ __device__ constexpr int spmm_batch() {
  return NB <= 2 ? 8 : (NB <= 4 ? 6 : 4);
}

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
  TAB_WIN = 8,    // K6: address of win [ceil(S / sb)] (0 for a full plan)
  TAB_SB = 9,     // K6: slices per window
  kTableCols = 10
};

// One thread's stored row: its bucket's table row e, its index t in the
// bucket's [S, C] rows, slice s and lane c. False past the bucket's rows.
struct RowOf {
  const int64_t* e;
  int t, s, c;
};

__device__ __forceinline__ bool find_row(const int64_t* __restrict__ tab,
                                         int nbk, int C, RowOf& r) {
  int b = 0;
  while (b + 1 < nbk &&
         static_cast<int64_t>(blockIdx.x) >=
             __ldg(tab + (b + 1) * kTableCols + TAB_BLK)) {
    ++b;
  }
  r.e = tab + b * kTableCols;
  const int S = static_cast<int>(__ldg(r.e + TAB_S));
  r.t = static_cast<int>(blockIdx.x - __ldg(r.e + TAB_BLK)) * kThreads +
        static_cast<int>(threadIdx.x);
  if (r.t >= S * C) return false;
  r.s = r.t / C;
  r.c = r.t - r.s * C;
  return true;
}

// ---------------------------------------------------------------------------
// K4 and K6: the SpMV
// ---------------------------------------------------------------------------

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

// The window of a K6 row: x[base + clamp(cur - base, 0, lim2)], 0 past
// mlim. K4 ignores it.
struct Window {
  int base, lim2;
};

template <int CODEC, bool FULL, bool BAND>
__device__ __forceinline__ Walk walk_batch(const uint32_t* __restrict__ wp,
                                           int C, int n, Walk st,
                                           const float* __restrict__ x,
                                           int mlim, Window win, DecodeArgs a,
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
    if constexpr (BAND) {
      col[k] = win.base + max(0, min(cur - win.base, win.lim2));
    } else {
      col[k] = max(0, min(cur, mlim));
    }
  }
  float xv[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const bool live = (FULL || k < n) && (!BAND || col[k] <= mlim);
    xv[k] = live ? ld_hint(x + col[k], x_pol) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    if (FULL || k < n) acc = __fadd_rn(acc, __fmul_rn(v[k], xv[k]));
  }
  return Walk{cur, acc};
}

// One thread's stored row of K4 (BAND false) or K6.
template <int CODEC, bool BAND>
__device__ __forceinline__ void spmv_row(const int64_t* __restrict__ tab,
                                         int nbk, int C,
                                         const float* __restrict__ x,
                                         float* __restrict__ y, int mlim,
                                         int hw, DecodeArgs a) {
  RowOf r;
  if (!find_row(tab, nbk, C, r)) return;
  const int64_t* e = r.e;
  const int w = static_cast<int>(__ldg(e + TAB_W));
  const int wb = static_cast<int>(__ldg(e + TAB_WB));
  const int nw = static_cast<int>(__ldg(e + TAB_NW));
  const uint32_t* __restrict__ wp =
      reinterpret_cast<const uint32_t*>(__ldg(e + TAB_WORDS)) +
      static_cast<int64_t>(r.s) * w * C + r.c;
  const int32_t* d0 = reinterpret_cast<const int32_t*>(__ldg(e + TAB_D0));
  Window win{0, 0};
  if constexpr (BAND) {
    const int32_t* wins =
        reinterpret_cast<const int32_t*>(__ldg(e + TAB_WIN));
    const int sb = static_cast<int>(__ldg(e + TAB_SB));
    win = Window{__ldg(wins + r.s / sb) * hw, 2 * hw - 1};
  }
  const uint64_t words_pol = l2_evict_first();
  const uint64_t x_pol = l2_evict_last();
  int cur = __ldg(d0 + r.s);
  float total = 0.0f;
  for (int wi = 0; wi < nw; ++wi) {
    const int j1 = min((wi + 1) * wb, w);
    Walk st{cur, 0.0f};
    int j = wi * wb;
    for (; j + kBatch <= j1; j += kBatch) {
      st = walk_batch<CODEC, true, BAND>(wp + static_cast<int64_t>(j) * C, C,
                                         kBatch, st, x, mlim, win, a,
                                         words_pol, x_pol);
    }
    if (j < j1) {
      st = walk_batch<CODEC, false, BAND>(wp + static_cast<int64_t>(j) * C,
                                          C, j1 - j, st, x, mlim, win, a,
                                          words_pol, x_pol);
    }
    cur = st.cur;
    total = wi == 0 ? st.acc : __fadd_rn(total, st.acc);
  }
  y[__ldg(e + TAB_OUT) + r.t] = total;
}

template <int CODEC>
__global__ void
    spmv_buckets_kernel(const int64_t* __restrict__ tab, int nbk, int C,
                        const float* __restrict__ x, float* __restrict__ y,
                        int mlim, DecodeArgs a) {
  spmv_row<CODEC, false>(tab, nbk, C, x, y, mlim, 0, a);
}

// K6's resident blocks per SM that ptxas must leave room for: 6 (at most
// 40 registers a thread). With a minimum of 1 it took 48-64 registers
// (44-48 with no bound) and ran 7-10 % slower. K4 keeps no bound (34-38
// registers).
constexpr int kBandMinBlocks = 6;

template <int CODEC>
__global__ void __launch_bounds__(kThreads, kBandMinBlocks)
    band_buckets_kernel(const int64_t* __restrict__ tab, int nbk, int C,
                        const float* __restrict__ x, float* __restrict__ y,
                        int mlim, int hw, DecodeArgs a) {
  spmv_row<CODEC, true>(tab, nbk, C, x, y, mlim, hw, a);
}

// ---------------------------------------------------------------------------
// K5: the SpMM
// ---------------------------------------------------------------------------

// The next n words of one row (n = spmm_batch<NB>() when FULL): the word
// loads, the decode and every X row of the batch are issued before the
// sums, which add each rhs's products in j order to the block sums acc.
template <int CODEC, int NB, bool VEC, bool FULL>
__device__ __forceinline__ void spmm_walk(const uint32_t* __restrict__ wp,
                                          int C, int n, int& cur,
                                          const float* __restrict__ xb,
                                          int nb, int mlim,
                                          const DecodeArgs& a,
                                          uint64_t words_pol, uint64_t x_pol,
                                          float (&acc)[NB]) {
  constexpr int B = spmm_batch<NB>();
  uint32_t wv[B];
#pragma unroll
  for (int k = 0; k < B; ++k) {
    wv[k] = (FULL || k < n) ? ld_hint(wp + k * C, words_pol) : 0u;
  }
  float v[B];
  float xv[B][NB];
#pragma unroll
  for (int k = 0; k < B; ++k) {
    uint32_t d;
    decode_word<ENC_WORDS, CODEC>(wv[k], a, v[k], d);
    cur = static_cast<int>(static_cast<uint32_t>(cur) + d);
    if (FULL || k < n) {
      const int col = max(0, min(cur, mlim));
      load_row<NB, VEC>(xb + static_cast<int64_t>(col) * nb, x_pol, xv[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < B; ++k) {
    if (FULL || k < n) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        acc[b] = __fadd_rn(acc[b], __fmul_rn(v[k], xv[k][b]));
      }
    }
  }
}

// K5 for NB right-hand sides of one stored row: o[0:NB].
template <int CODEC, int NB, bool VEC>
__device__ __forceinline__ void spmm_row(const uint32_t* __restrict__ wp,
                                         int cur, int w, int wb, int nw,
                                         int C, const float* xb, float* o,
                                         int nb, int mlim,
                                         const DecodeArgs& a) {
  constexpr int B = spmm_batch<NB>();
  const uint64_t words_pol = l2_evict_first();
  const uint64_t x_pol = l2_evict_last();
  float total[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) total[b] = 0.0f;   // nw = 0 writes +0
  for (int wi = 0; wi < nw; ++wi) {
    const int j1 = min((wi + 1) * wb, w);
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.0f;
    int j = wi * wb;
    for (; j + B <= j1; j += B) {
      spmm_walk<CODEC, NB, VEC, true>(wp + static_cast<int64_t>(j) * C, C, B,
                                      cur, xb, nb, mlim, a, words_pol, x_pol,
                                      acc);
    }
    if (j < j1) {
      spmm_walk<CODEC, NB, VEC, false>(wp + static_cast<int64_t>(j) * C, C,
                                       j1 - j, cur, xb, nb, mlim, a,
                                       words_pol, x_pol, acc);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      total[b] = wi == 0 ? acc[b] : __fadd_rn(total[b], acc[b]);
    }
  }
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < NB / 4; ++q) {
      reinterpret_cast<float4*>(o)[q] = make_float4(
          total[4 * q], total[4 * q + 1], total[4 * q + 2], total[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) o[b] = total[b];
  }
}

// K5's resident blocks per SM that ptxas must leave room for: 3 (at most
// 80 registers a thread, 768 threads an SM) for a fixed-width body. Left
// free, the nb = 8 body took 90 registers, 2 blocks an SM, and ran 1.26x
// slower. The body that picks its width at run time (NB = 0, nb > 8) gets
// 2: at 3 it spilled.
template <int NB>
__host__ __device__ constexpr int spmm_min_blocks() {
  return NB == 0 ? 2 : 3;
}

// One thread per stored row; blockIdx.y picks the chunk of up to kMaxRhs
// right-hand sides. NB > 0: every chunk is NB wide (nb <= kMaxRhs, one
// chunk), so the kernel holds that body alone and its registers; NB = 0
// (nb > kMaxRhs): the chunk's width selects the body at run time. VEC: the
// wrapper found nb % 4 == 0, so each chunk is 4 or 8 wide.
template <int CODEC, bool VEC, int NB>
__global__ void __launch_bounds__(kThreads, spmm_min_blocks<NB>())
    spmm_buckets_kernel(const int64_t* __restrict__ tab, int nbk, int C,
                        const float* __restrict__ x, float* __restrict__ y,
                        int nb, int mlim, DecodeArgs a) {
  RowOf r;
  if (!find_row(tab, nbk, C, r)) return;
  const int64_t* e = r.e;
  const int w = static_cast<int>(__ldg(e + TAB_W));
  const int wb = static_cast<int>(__ldg(e + TAB_WB));
  const int nw = static_cast<int>(__ldg(e + TAB_NW));
  const uint32_t* __restrict__ wp =
      reinterpret_cast<const uint32_t*>(__ldg(e + TAB_WORDS)) +
      static_cast<int64_t>(r.s) * w * C + r.c;
  const int cur =
      __ldg(reinterpret_cast<const int32_t*>(__ldg(e + TAB_D0)) + r.s);
  const int b0 = static_cast<int>(blockIdx.y) * kMaxRhs;
  const float* xb = x + b0;
  float* o = y + (__ldg(e + TAB_OUT) + r.t) * nb + b0;
#define K5_ROW(W, V) \
  spmm_row<CODEC, W, V>(wp, cur, w, wb, nw, C, xb, o, nb, mlim, a)
  if constexpr (NB > 0) {
    K5_ROW(NB, VEC);
  } else if constexpr (VEC) {
    if (nb - b0 >= 8) K5_ROW(8, true); else K5_ROW(4, true);
  } else {
    switch (min(kMaxRhs, nb - b0)) {
      case 1: K5_ROW(1, false); break;
      case 2: K5_ROW(2, false); break;
      case 3: K5_ROW(3, false); break;
      case 4: K5_ROW(4, false); break;
      case 5: K5_ROW(5, false); break;
      case 6: K5_ROW(6, false); break;
      case 7: K5_ROW(7, false); break;
      default: K5_ROW(8, false); break;
    }
  }
#undef K5_ROW
}

struct SpmmLaunch {
  dim3 grid;
  cudaStream_t stream;
  const int64_t* tab;
  int nbk, C;
  const float* x;
  float* y;
  int nb, mlim;
  DecodeArgs a;
};

template <int CODEC, bool VEC, int NB>
void launch_spmm(const SpmmLaunch& p) {
  spmm_buckets_kernel<CODEC, VEC, NB><<<p.grid, kThreads, 0, p.stream>>>(
      p.tab, p.nbk, p.C, p.x, p.y, p.nb, p.mlim, p.a);
}

// The kernel for nb right-hand sides: a fixed-width body for one chunk,
// the run-time choice for several.
template <int CODEC>
void launch_spmm_nb(const SpmmLaunch& p, bool vec) {
  if (p.nb > kMaxRhs) {
    vec ? launch_spmm<CODEC, true, 0>(p) : launch_spmm<CODEC, false, 0>(p);
  } else if (vec) {
    p.nb == 8 ? launch_spmm<CODEC, true, 8>(p)
              : launch_spmm<CODEC, true, 4>(p);
  } else {
    switch (p.nb) {
      case 1: launch_spmm<CODEC, false, 1>(p); break;
      case 2: launch_spmm<CODEC, false, 2>(p); break;
      case 3: launch_spmm<CODEC, false, 3>(p); break;
      case 4: launch_spmm<CODEC, false, 4>(p); break;
      case 5: launch_spmm<CODEC, false, 5>(p); break;
      case 6: launch_spmm<CODEC, false, 6>(p); break;
      case 7: launch_spmm<CODEC, false, 7>(p); break;
      default: launch_spmm<CODEC, false, 8>(p); break;
    }
  }
}

// Calls f(std::integral_constant<int, CODEC>) for a codec id, then returns
// cudaGetLastError() (an unknown id: cudaErrorInvalidValue, no launch).
template <typename F>
int by_codec(int codec, F&& f) {
  switch (codec) {
    case CODEC_FP16: f(std::integral_constant<int, CODEC_FP16>{}); break;
    case CODEC_BF16: f(std::integral_constant<int, CODEC_BF16>{}); break;
    case CODEC_E8M: f(std::integral_constant<int, CODEC_E8M>{}); break;
    case CODEC_FIXED: f(std::integral_constant<int, CODEC_FIXED>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes). tab is the device table (nbk rows of
// kTableCols int64, buckets with rows only) and blocks the sum of their
// thread blocks; each needs nbk >= 1, blocks >= 1 and m >= 1, and returns
// cudaGetLastError() after the launch: 0 when the launch was accepted.

// K4: y float32[total_stored]; m - 1 < 2^31.
extern "C" int packsell_spmv_buckets(const void* tab, int nbk, int blocks,
                                     int C, const void* x, void* y,
                                     int64_t m, int codec, int D, float scale,
                                     void* stream) {
  return by_codec(codec, [&](auto cc) {
    spmv_buckets_kernel<decltype(cc)::value>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int64_t*>(tab), nbk, C,
            static_cast<const float*>(x), static_cast<float*>(y),
            static_cast<int>(m - 1), DecodeArgs{D, scale});
  });
}

// K6: y float32[total_stored] through each bucket's windows (TAB_WIN,
// TAB_SB) of half-width hw; every window end win * hw + 2 hw - 1 < 2^31.
extern "C" int packsell_spmv_band_buckets(const void* tab, int nbk,
                                          int blocks, int C, const void* x,
                                          void* y, int64_t m, int hw,
                                          int codec, int D, float scale,
                                          void* stream) {
  return by_codec(codec, [&](auto cc) {
    band_buckets_kernel<decltype(cc)::value>
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int64_t*>(tab), nbk, C,
            static_cast<const float*>(x), static_cast<float*>(y),
            static_cast<int>(m - 1), hw, DecodeArgs{D, scale});
  });
}

// K5: y float32[total_stored, nb] for x float32[m, nb] (nb >= 1); vec != 0
// only when nb % 4 == 0 and x and y are 16-byte aligned.
extern "C" int packsell_spmm_buckets(const void* tab, int nbk, int blocks,
                                     int C, const void* x, void* y, int nb,
                                     int vec, int64_t m, int codec, int D,
                                     float scale, void* stream) {
  const SpmmLaunch p{
      dim3(static_cast<unsigned>(blocks),
           static_cast<unsigned>((nb + kMaxRhs - 1) / kMaxRhs)),
      static_cast<cudaStream_t>(stream), static_cast<const int64_t*>(tab),
      nbk, C, static_cast<const float*>(x), static_cast<float*>(y), nb,
      static_cast<int>(m - 1), DecodeArgs{D, scale}};
  return by_codec(codec, [&](auto cc) {
    launch_spmm_nb<decltype(cc)::value>(p, vec != 0);
  });
}
