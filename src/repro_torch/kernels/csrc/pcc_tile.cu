// All-pairs correlation tiles for NVIDIA Hopper (sm_90a), float32 operands
// on the SIMT pipes.
//
// Replaces the Pallas TPU kernel repro/kernels/pcc_tile.py::pcc_tiles (body
// _kernel) in every mode, with the fused EpilogueSpec, for float32 operands
// (entry point pcc_tiles_f32); bfloat16, fp8 and int8 operands (the other
// operand modes of _kernel, pcc_tile.py:136-149) take the tensor-core
// kernel of pcc_tile_sm90.cu.  Both tile-id families:
//   * the triangle (index maps _row_map/_col_map, grid_cols == 0): tiles of
//     U V^T over the upper triangle of the m x m tile grid (paper Eq. 9),
//     where V is U itself or a second operand of U's exact shape (the
//     masked measures' cross components, pcc_tile.py:360-365);
//   * the rectangular grid (_grid_row_map/_grid_col_map, grid_cols > 0):
//     tiles of U V^T over the m x grid_cols grid, row-major, rows from U and
//     columns from the second operand V (the X-vs-Y workload).
// Output slot i of a launch holds tile jt = min(j_start + i, total - 1);
// U = u_pad (n_pad, l_pad) and V = v_pad (grid_cols * t or n_pad rows,
// l_pad) are row-major float32; so is the output.
// Per-row scales (row_scale/col_scale, pcc_tile.py:152-165), srow (U's
// rows) and scol (V's rows): the finished value is multiplied by
// srow[y] * scol[x], the product first, before the epilogue; both are null
// for unscaled launches.
// The replica axis (significance runs, _kernel's `replica` branches and the
// _rep_* index maps, pcc_tile.py:230-291): replicas > 0 makes V a stack of
// R column operands, replica r at v + r * v_rstride with its scales at
// scol + r * s_rstride (s_rstride may be 0: one scale vector for every
// replica), and the output (R, pass_tiles, t, t).  The grid gains a z
// dimension over replicas; each CTA offsets its pointers by blockIdx.z and
// then runs the 2-D code unchanged, so replica r's tiles are bitwise those
// of a 2-D launch with V = stack[r].  The row operand is read once per
// replica (L2 serves the repeats).  Their bound is the float32 work of all R
// replicas: at the significance headline (1,639 TF rows, l = 5,072, 28
// tiles, 64 replicas) 1.19e12 FLOP, >= 17.8 ms at 67 TFLOP/s, against
// 2.9 GB of stack, operand and output (0.85 ms at 3.35 TB/s).
//
// What bounds it: the float32 work is IEEE float32 FMA.  Hopper's tensor
// cores have no IEEE-f32 mode (TF32 keeps 10 mantissa bits), so the kernel
// runs on the SIMT FP32 pipes, 67 TFLOP/s on an H100 SXM at 700 W.  At the
// paper's Table II shape (n = 17,555, l = 5,072, t = 256: 2,415 tiles) one
// pass is 2 * 5,072 * 256^2 * 2,415 = 1.61e12 FLOP, so >= 24 ms, against
// ~1 GB of operand plus tile bytes (~0.3 ms at 3.35 TB/s): compute-bound by
// ~80x.  The scale product is one multiply per output, after the
// accumulation.
//
// Design (pcc_sgemm.cuh): 128 x 128 outputs per CTA of 256 threads, 8 x 8
// per thread as two float4 strips 64 apart on each axis, operands copied by
// 4-byte cp.async straight into a 4-stage k-major ring of 16-sample chunks
// (rows padded to 132 floats, so copies and reads are free of bank
// conflicts), one barrier per chunk; a 256 x 256 tile takes 4 CTAs, and a
// CTA reads 32 FLOP per byte from L2.  Two CTAs an SM.  The grid is
// (pass_tiles, blocks per tile, replicas).  The CTA inverts its own tile id
// (exact integer math on the triangle, one division on the grid), so any m
// works, unlike the f32-only job_coord_f32 of the TPU kernel.  Every
// output accumulates over k = 0 .. l_pad-1 in one sequential fmaf chain
// from +0 (the float32 top-k select runs the same mainloop), so a tile's
// bits do not depend on the pass it was launched in or on the kernel that
// made it, and the scale product and the epilogue run in registers before
// the single store.

#include "pcc_accum.cuh"
#include "pcc_sgemm.cuh"

namespace {

using namespace pcc;

// The CTA's tile coordinate: slot blockIdx.x holds tile min(j_start +
// blockIdx.x, total - 1).
__device__ __forceinline__ void locate(long long j_start, int m,
                                       int grid_cols, int* yt, int* xt) {
  long long jt = j_start + (long long)blockIdx.x;
  const long long total = tile_total(m, grid_cols);
  if (jt > total - 1) jt = total - 1;
  tile_coord(m, grid_cols, jt, yt, xt);
}

// REPLICA instantiations offset v, scol and out by the replica blockIdx.z;
// the others compile without it.  The 128 x 128 cp.async block of
// pcc_sgemm.cuh: a thread's 8 x 8 outputs are two strips of 4 rows by two
// strips of 4 columns; each strip of a row is one float4 store when
// t % 4 == 0 (16-byte aligned rows) and lies inside the tile, else up to 4
// scalar stores.
template <bool SCALED, bool REPLICA>
__global__ void __launch_bounds__(sgemm::THREADS, 2)
pcc_tiles_f32_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ srow,
                     const float* __restrict__ scol, float* __restrict__ out,
                     long long j_start, int m, int grid_cols, int t,
                     int l_pad, int nb, long long v_rstride,
                     long long s_rstride, int has_div, float recip,
                     int has_clip, float lo, float hi) {
  extern __shared__ __align__(16) float smem[];

  if (REPLICA) {
    const size_t r = blockIdx.z;
    v += r * (size_t)v_rstride;
    if (SCALED) scol += r * (size_t)s_rstride;
    out += r * gridDim.x * (size_t)t * t;
  }
  int yt, xt;
  locate(j_start, m, grid_cols, &yt, &xt);

  const int r_in = (blockIdx.y / nb) * sgemm::BLOCK;
  const int c_in = (blockIdx.y % nb) * sgemm::BLOCK;
  float acc[sgemm::TM][sgemm::TM];
  sgemm::accumulate_block(u + ((size_t)yt * t + r_in) * l_pad,
                          v + ((size_t)xt * t + c_in) * l_pad, t - r_in,
                          t - c_in, l_pad, smem, acc);

  const int ty = sgemm::ty_of(threadIdx.x), tx = sgemm::tx_of(threadIdx.x);
  const bool vec = t % 4 == 0;
  float* tile = out + (size_t)blockIdx.x * t * t;
#pragma unroll
  for (int i = 0; i < sgemm::TM; ++i) {
    const int rr = r_in + sgemm::strip(ty, i);
    if (rr >= t) continue;
    const float sr = SCALED ? srow[(size_t)yt * t + rr] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = c_in + sgemm::strip(tx, 4 * h);
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = finalize<SCALED>(
            acc[i][4 * h + e], sr,
            SCALED && c0 + e < t ? scol[(size_t)xt * t + c0 + e] : 0.f,
            has_div, recip, has_clip, lo, hi);
      float* dst = tile + (size_t)rr * t + c0;
      if (vec && c0 + 3 < t) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + e < t) dst[e] = o[e];
      }
    }
  }
}

int launch(const float* u, const float* v, const float* srow,
           const float* scol, float* out, long long j_start, int pass_tiles,
           int m, int grid_cols, int t, int l_pad, int replicas,
           long long v_rstride, long long s_rstride, int has_div,
           float recip, int has_clip, float lo, float hi, void* stream) {
  if (pass_tiles <= 0 || m <= 0 || grid_cols < 0 || t <= 0 || l_pad <= 0 ||
      j_start < 0 || (srow == nullptr) != (scol == nullptr) ||
      replicas < 0 || replicas > 65535 || v_rstride < 0 || s_rstride < 0)
    return (int)cudaErrorInvalidValue;
  const int nb = (t + sgemm::BLOCK - 1) / sgemm::BLOCK;
  if ((long long)nb * nb > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)pass_tiles, (unsigned)(nb * nb),
                  (unsigned)(replicas > 0 ? replicas : 1));
  const bool scaled = srow != nullptr;
  const auto kernel =
      scaled ? (replicas > 0 ? pcc_tiles_f32_kernel<true, true>
                             : pcc_tiles_f32_kernel<true, false>)
             : (replicas > 0 ? pcc_tiles_f32_kernel<false, true>
                             : pcc_tiles_f32_kernel<false, false>);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      sgemm::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, sgemm::THREADS, sgemm::SMEM_BYTES, (cudaStream_t)stream>>>(
      u, v, srow, scol, out, j_start, m, grid_cols, t, l_pad, nb, v_rstride,
      s_rstride, has_div, recip, has_clip, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace

// u, v: float32 operands.  grid_cols == 0 selects the triangle (v is u,
// or a second operand of u's shape); srow and scol are both null
// (unscaled) or both given; replicas == 0 is a 2-D launch, replicas > 0 a
// replica stack (strides in elements).  Returns the launch's cudaError_t.
extern "C" int pcc_tiles_f32(const float* u, const float* v,
                             const float* srow, const float* scol,
                             float* out, long long j_start, int pass_tiles,
                             int m, int grid_cols, int t, int l_pad,
                             int replicas, long long v_rstride,
                             long long s_rstride, int has_div, float recip,
                             int has_clip, float lo, float hi,
                             void* stream) {
  return launch(u, v, srow, scol, out, j_start, pass_tiles, m, grid_cols, t,
                l_pad, replicas, v_rstride, s_rstride, has_div, recip,
                has_clip, lo, hi, stream);
}

extern "C" const char* pcc_tile_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
