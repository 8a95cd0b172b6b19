// The SIMT 64 x 64 int8 tile accumulation (sm_90a) and what every tile
// kernel shares: tile-id inversion, the scale product and the epilogue.
//
// Who runs the 64 x 64 block: the int8 select of pcc_topk.cu.  The float32
// tiles and the float32 select run the 128 x 128 cp.async mainloop of
// pcc_sgemm.cuh, bf16 / fp8 / int8 tiles and the bf16 select the tensor
// cores (pcc_mma.cuh).  int8 sums are exact, so their values agree in any
// block and on the tensor cores; every float32 output is one sequential
// fmaf chain (pcc_sgemm.cuh), then the EpilogueSpec (multiply by the
// host-rounded float32 reciprocal, then clip) in registers, the same
// routine in every kernel.
//
// Tile ids: the triangle (grid_cols == 0) numbers the upper triangle of the
// m x m tile grid row-major (paper Eq. 9) and is inverted with exact integer
// math (a float64 sqrt estimate, then the int64 repair of core/mapping.py
// job_coord_batch); the rectangular grid (grid_cols > 0) numbers the
// m x grid_cols grid row-major, y = jt / grid_cols, x = jt % grid_cols.
//
// The int8 block: operands packed 4 samples to a 32-bit word (BK words = 64
// samples per chunk), staged through shared memory k-major (As[k][row]) so
// each thread reads its 4 rows and 4 columns as two int4 loads per word;
// the next chunk's global loads are issued into registers before the
// current chunk's __dp4a (register double buffering).  Sums are int32,
// converted to float once at the end.  Integer sums are exact in any order
// (the wrapper keeps l_pad * 128^2 below 2^31), and the conversion equals
// the reference's per-block float32 sums whenever |partial sums| < 2^24
// (always, for Kendall pair signs).  Rows past the tile's edge (t not a
// multiple of 64) and samples past l_pad read as zero.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace pcc {

constexpr int BM = 64;          // output rows per CTA (== output columns)
constexpr int BK = 16;          // sample chunk staged in shared memory
constexpr int TM = 4;           // outputs per thread along each axis
constexpr int THREADS = (BM / TM) * (BM / TM);   // 256
constexpr int LOADS = BM * BK / THREADS;         // 4 elements per operand
constexpr int PAD = 4;          // keeps rows 16-byte aligned, cuts conflicts
constexpr int KPW = 4;          // int8 samples packed into one 32-bit word

// One chunk of both operands, k-major, as packed int8 words.
struct Stage {
  struct Plane {
    int i[BK][BM + PAD];
  } a, b;
};

__device__ __forceinline__ long long tri_before(long long m, long long y) {
  return y * (2 * m - y + 1) / 2;  // F_m(y); y(2m-y+1) is always even
}

// Exact inverse of the upper-triangle numbering (paper Eq. 14/15).
__device__ __forceinline__ void tri_coord(long long m, long long j, int* yo,
                                          int* xo) {
  const long long disc = 4 * m * m + 4 * m + 1 - 8 * (j + 1);  // >= 1
  long long s = (long long)floor(sqrt((double)disc));
  while (s * s > disc) --s;
  while ((s + 1) * (s + 1) <= disc) ++s;
  long long y = ((2 * m - 1) - s + 1) / 2;  // numerator >= 0: floor == trunc
  if (y < 0) y = 0;
  if (y > m - 1) y = m - 1;
  while (tri_before(m, y + 1) <= j) ++y;
  while (tri_before(m, y) > j) --y;
  *yo = (int)y;
  *xo = (int)(j + y - tri_before(m, y));
}

__device__ __forceinline__ long long tile_total(int m, int grid_cols) {
  return grid_cols > 0 ? (long long)m * grid_cols
                       : (long long)m * (m + 1) / 2;
}

// Tile coordinate of (already clamped) tile id jt.
__device__ __forceinline__ void tile_coord(int m, int grid_cols, long long jt,
                                           int* yt, int* xt) {
  if (grid_cols > 0) {
    *yt = (int)(jt / grid_cols);
    *xt = (int)(jt % grid_cols);
  } else {
    tri_coord(m, jt, yt, xt);
  }
}

// Samples k .. k+3 of an int8 row as one word, byte j = sample k + j (the
// order __dp4a pairs bytes in); samples past l_pad read as zero.  `vec`:
// the row and l_pad are 4-byte aligned, so k < l_pad implies the whole word
// is inside the row and one 32-bit load reads it.
__device__ __forceinline__ int load_word(const int8_t* __restrict__ row,
                                         int k, int l_pad, bool vec) {
  if (vec) return k < l_pad ? *reinterpret_cast<const int*>(row + k) : 0;
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < KPW; ++j)
    if (k + j < l_pad) w |= (unsigned)(uint8_t)row[k + j] << (8 * j);
  return (int)w;
}

// acc = the (64, 64) block a_base[0:64] . b_base[0:64]^T over l_pad int8
// samples, rows a_rows.. and b_rows.. of the block reading as zero, in
// chunks of BK words (BK * KPW = 64 samples), one __dp4a per (row, column,
// word) into int32, converted to float once.  Thread (ty, tx) holds rows
// ty*4 .. ty*4+3 and columns tx*4 .. tx*4+3.
__device__ __forceinline__ void accumulate_block(
    const int8_t* __restrict__ a_base, const int8_t* __restrict__ b_base,
    int a_rows, int b_rows, int l_pad, Stage& st, float (&acc)[TM][TM]) {
  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM);
  const int ty = tid / (BM / TM);
  const bool vec = ((reinterpret_cast<uintptr_t>(a_base) |
                     reinterpret_cast<uintptr_t>(b_base) |
                     (uintptr_t)l_pad) & 3) == 0;

  // element e of this thread is row idx / BK, word idx % BK of the chunk:
  // 16 neighbouring threads read 64 contiguous bytes of one row
  int a_ld[LOADS], b_ld[LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      const int idx = tid + e * THREADS;
      const int row = idx / BK;
      const int k = k0 + (idx % BK) * KPW;
      a_ld[e] = row < a_rows
                    ? load_word(a_base + (size_t)row * l_pad, k, l_pad, vec)
                    : 0;
      b_ld[e] = row < b_rows
                    ? load_word(b_base + (size_t)row * l_pad, k, l_pad, vec)
                    : 0;
    }
  };

  int iacc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) iacc[i][j] = 0;

  fetch(0);
  for (int k0 = 0; k0 < l_pad; k0 += BK * KPW) {
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      const int idx = tid + e * THREADS;
      st.a.i[idx % BK][idx / BK] = a_ld[e];
      st.b.i[idx % BK][idx / BK] = b_ld[e];
    }
    __syncthreads();
    if (k0 + BK * KPW < l_pad) fetch(k0 + BK * KPW);
#pragma unroll
    for (int w = 0; w < BK; ++w) {
      const int4 av = *reinterpret_cast<const int4*>(&st.a.i[w][ty * TM]);
      const int4 bv = *reinterpret_cast<const int4*>(&st.b.i[w][tx * TM]);
      const int a[TM] = {av.x, av.y, av.z, av.w};
      const int b[TM] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) iacc[i][j] = __dp4a(a[i], b[j], iacc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = __int2float_rn(iacc[i][j]);
}

// EpilogueSpec.apply: v * recip, then clip; the clip keeps NaN like
// torch.clamp.
__device__ __forceinline__ float epilogue(float v, int has_div, float recip,
                                          int has_clip, float lo, float hi) {
  if (has_div) v = __fmul_rn(v, recip);
  if (has_clip) v = v < lo ? lo : (v > hi ? hi : v);
  return v;
}

// The finished value of an output: the scale product of quantized operands
// (srow of its row, scol of its column, the product first), then the
// epilogue.  One routine for every operand type and kernel, so the order is
// the same in all of them; unscaled launches compile without the scales.
template <bool SCALED>
__device__ __forceinline__ float finalize(float v, float srow, float scol,
                                          int has_div, float recip,
                                          int has_clip, float lo, float hi) {
  if (SCALED) v = __fmul_rn(v, __fmul_rn(srow, scol));
  return epilogue(v, has_div, recip, has_clip, lo, hi);
}

}  // namespace pcc
