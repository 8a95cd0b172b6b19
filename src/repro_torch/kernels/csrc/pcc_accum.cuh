// What every pcc tile kernel shares (sm_90a): tile-id inversion, the scale
// product and the epilogue.
//
// Who includes it: pcc_tile.cu (float32 tiles), pcc_mma.cuh (the
// tensor-core mainloop of the bf16 / fp8 / int8 tiles and of the bf16 and
// int8 selects) and pcc_topk.cu.  The products themselves live in the two
// mainloops: pcc_sgemm.cuh (float32, one sequential fmaf chain an output)
// and pcc_mma.cuh (wgmma; int8 as one exact int32 sum, converted once).
// Every finished value then takes the same routine in every kernel: the
// scale product of quantized operands, then the EpilogueSpec (multiply by
// the host-rounded float32 reciprocal, then clip), in registers.
//
// Tile ids: the triangle (grid_cols == 0) numbers the upper triangle of the
// m x m tile grid row-major (paper Eq. 9) and is inverted with exact integer
// math (a float64 sqrt estimate, then the int64 repair of core/mapping.py
// job_coord_batch); the rectangular grid (grid_cols > 0) numbers the
// m x grid_cols grid row-major, y = jt / grid_cols, x = jt % grid_cols.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace pcc {

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
