// Triangular all-pairs correlation tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pcc_tile.py::pcc_tiles (body
// _kernel, index maps _row_map/_col_map) in its triangular, float32,
// unscaled mode with the fused EpilogueSpec.  Output slot i of a launch holds
// the (t, t) tile jt = min(j_start + i, total - 1) of U U^T, where jt numbers
// the upper triangle of the m x m tile grid row-major (paper Eq. 9) and
// U = u_pad is (n_pad, l_pad) row-major float32.
//
// What bounds it: the work is IEEE float32 FMA.  Hopper's tensor cores have
// no IEEE-f32 mode (TF32 keeps 10 mantissa bits), so the kernel runs on the
// SIMT FP32 pipes, 67 TFLOP/s on an H100 SXM at 700 W.  At the paper's
// Table II shape (n = 17,555, l = 5,072, t = 256: 2,415 tiles) one pass is
// 2 * 5,072 * 256^2 * 2,415 = 1.61e12 FLOP, so >= 24 ms, against ~1 GB of
// operand plus tile bytes (~0.3 ms at 3.35 TB/s): compute-bound by ~80x.
//
// Design: a register-blocked SIMT SGEMM.  Each CTA of 256 threads computes a
// BM x BN = 64 x 64 block of one tile, 4 x 4 outputs per thread, so a
// 256 x 256 tile takes 16 CTAs and the grid is (pass_tiles, ceil(t/64)^2).
// The CTA inverts its own tile id with exact integer math (a float64 sqrt
// estimate, then the int64 repair of core/mapping.py job_coord_batch), so
// any m works, unlike the f32-only job_coord_f32 of the TPU kernel.
// Operands are staged through shared memory in BK = 16-wide sample chunks,
// stored k-major (As[k][row]) so each thread reads its 4 rows and 4 columns
// as two float4 loads per k; the next chunk's global loads are issued into
// registers before the current chunk's FMAs (register double buffering).
// Every output accumulates over k = 0 .. l_pad-1 in one sequential fmaf
// chain, so a tile's bits do not depend on the pass it was launched in.  The
// epilogue (multiply by the host-rounded float32 reciprocal, then clip) runs
// in registers before the single store.  Rows past t (t not a multiple of 64)
// and samples past l_pad are masked, so any t >= 1 is accepted.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;          // output rows per CTA (== output columns)
constexpr int BK = 16;          // sample chunk staged in shared memory
constexpr int TM = 4;           // outputs per thread along each axis
constexpr int THREADS = (BM / TM) * (BM / TM);   // 256
constexpr int LOADS = BM * BK / THREADS;         // 4 elements per operand
constexpr int PAD = 4;          // keeps rows 16-byte aligned, cuts conflicts

__device__ __forceinline__ long long tri_before(long long m, long long y) {
  return y * (2 * m - y + 1) / 2;  // F_m(y); y(2m-y+1) is always even
}

// Exact inverse of the upper-triangle numbering (paper Eq. 14/15).
__device__ __forceinline__ void tile_coord(long long m, long long j, int* yo,
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

__global__ void __launch_bounds__(THREADS)
pcc_tiles_f32_tri_kernel(const float* __restrict__ u, float* __restrict__ out,
                         long long j_start, int m, int t, int l_pad, int nb,
                         int has_div, float recip, int has_clip, float lo,
                         float hi) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BM + PAD];

  const long long total = (long long)m * (m + 1) / 2;
  long long jt = j_start + (long long)blockIdx.x;
  if (jt > total - 1) jt = total - 1;
  int yt, xt;
  tile_coord(m, jt, &yt, &xt);

  const int r_in = (blockIdx.y / nb) * BM;  // CTA's first row inside the tile
  const int c_in = (blockIdx.y % nb) * BM;  // CTA's first column
  const float* a_base = u + ((size_t)yt * t + r_in) * l_pad;
  const float* b_base = u + ((size_t)xt * t + c_in) * l_pad;

  const int tid = threadIdx.x;
  const int tx = tid % (BM / TM);
  const int ty = tid / (BM / TM);

  // Global -> register staging: element e of this thread is row idx / BK,
  // sample idx % BK of the chunk, so 16 neighbouring threads read 64
  // contiguous bytes of one row.
  float a_ld[LOADS], b_ld[LOADS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      const int idx = tid + e * THREADS;
      const int row = idx / BK;
      const int k = k0 + idx % BK;
      const bool kin = k < l_pad;
      a_ld[e] = (kin && r_in + row < t) ? a_base[(size_t)row * l_pad + k] : 0.f;
      b_ld[e] = (kin && c_in + row < t) ? b_base[(size_t)row * l_pad + k] : 0.f;
    }
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < l_pad; k0 += BK) {
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      const int idx = tid + e * THREADS;
      As[idx % BK][idx / BK] = a_ld[e];
      Bs[idx % BK][idx / BK] = b_ld[e];
    }
    __syncthreads();
    if (k0 + BK < l_pad) fetch(k0 + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * TM]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float b[TM] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Fused epilogue (EpilogueSpec.apply): v * recip, then clip; the clip
  // keeps NaN like torch.clamp.  One store per output.
  float* tile = out + (size_t)blockIdx.x * t * t;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rr = r_in + ty * TM + i;
    if (rr >= t) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int cc = c_in + tx * TM + j;
      if (cc >= t) continue;
      float v = acc[i][j];
      if (has_div) v = __fmul_rn(v, recip);
      if (has_clip) v = v < lo ? lo : (v > hi ? hi : v);
      tile[(size_t)rr * t + cc] = v;
    }
  }
}

}  // namespace

extern "C" int pcc_tiles_f32_tri(const float* u, float* out,
                                 long long j_start, int pass_tiles, int m,
                                 int t, int l_pad, int has_div, float recip,
                                 int has_clip, float lo, float hi,
                                 void* stream) {
  if (pass_tiles <= 0 || m <= 0 || t <= 0 || l_pad <= 0 || j_start < 0)
    return (int)cudaErrorInvalidValue;
  const int nb = (t + BM - 1) / BM;
  if ((long long)nb * nb > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)pass_tiles, (unsigned)(nb * nb));
  pcc_tiles_f32_tri_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      u, out, j_start, m, t, l_pad, nb, has_div, recip, has_clip, lo, hi);
  return (int)cudaGetLastError();
}

extern "C" const char* pcc_tile_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
