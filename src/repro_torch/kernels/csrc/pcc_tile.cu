// All-pairs correlation tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pcc_tile.py::pcc_tiles (body
// _kernel) in every mode, with the fused EpilogueSpec, for float32 and int8
// operands (entry points pcc_tiles_f32 / _i8; the operand modes of _kernel,
// pcc_tile.py:136-149); bfloat16 and fp8 operands take the tensor-core
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
// l_pad) are row-major, both of one operand type; the output is float32.
// Quantized operands (row_scale/col_scale, pcc_tile.py:152-165) bring
// per-row float32 scales srow (U's rows) and scol (V's rows): the finished
// value is multiplied by srow[y] * scol[x], the product first, before the
// epilogue; both are null for unscaled launches.
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
// ~80x.  int8 operands take __dp4a (4 products per instruction) into int32;
// their bound is the int8 tensor-core peak (1,979 TOP/s), which this SIMT
// kernel does not reach.  The scale product is one multiply per output,
// after the accumulation.
//
// Design: a register-blocked SIMT SGEMM (pcc_accum.cuh, shared with the
// top-k kernel).  Each CTA of 256 threads computes a 64 x 64 block of one
// tile, 4 x 4 outputs per thread, so a 256 x 256 tile takes 16 CTAs and the
// grid is (pass_tiles, ceil(t/64)^2).  The CTA inverts its own tile id
// (exact integer math on the triangle, one division on the grid), so any m
// works, unlike the f32-only job_coord_f32 of the TPU kernel.  Every output
// accumulates over k = 0 .. l_pad-1 in one sequential fmaf chain, so a
// tile's bits do not depend on the pass it was launched in, and the scale
// product and the epilogue run in registers before the single store.

#include "pcc_accum.cuh"

namespace {

using namespace pcc;

// REPLICA instantiations offset v, scol and out by the replica blockIdx.z;
// the others compile without it.
template <typename T, bool SCALED, bool REPLICA>
__global__ void __launch_bounds__(THREADS)
pcc_tiles_kernel(const T* __restrict__ u, const T* __restrict__ v,
                 const float* __restrict__ srow,
                 const float* __restrict__ scol, float* __restrict__ out,
                 long long j_start, int m, int grid_cols, int t, int l_pad,
                 int nb, long long v_rstride, long long s_rstride,
                 int has_div, float recip, int has_clip, float lo,
                 float hi) {
  __shared__ __align__(16) Stage st;

  if (REPLICA) {
    const size_t r = blockIdx.z;
    v += r * (size_t)v_rstride;
    if (SCALED) scol += r * (size_t)s_rstride;
    out += r * gridDim.x * (size_t)t * t;
  }

  long long jt = j_start + (long long)blockIdx.x;
  const long long total = tile_total(m, grid_cols);
  if (jt > total - 1) jt = total - 1;
  int yt, xt;
  tile_coord(m, grid_cols, jt, &yt, &xt);

  const int r_in = (blockIdx.y / nb) * BM;  // CTA's first row inside the tile
  const int c_in = (blockIdx.y % nb) * BM;  // CTA's first column
  float acc[TM][TM];
  accumulate_block(u + ((size_t)yt * t + r_in) * l_pad,
                   v + ((size_t)xt * t + c_in) * l_pad, t - r_in, t - c_in,
                   l_pad, st, acc);

  const int tx = threadIdx.x % (BM / TM);
  const int ty = threadIdx.x / (BM / TM);
  float* tile = out + (size_t)blockIdx.x * t * t;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rr = r_in + ty * TM + i;
    if (rr >= t) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int cc = c_in + tx * TM + j;
      if (cc >= t) continue;
      tile[(size_t)rr * t + cc] = finalize<SCALED>(
          acc[i][j], SCALED ? srow[(size_t)yt * t + rr] : 0.f,
          SCALED ? scol[(size_t)xt * t + cc] : 0.f, has_div, recip, has_clip,
          lo, hi);
    }
  }
}

template <typename T, bool SCALED, bool REPLICA>
void enqueue(dim3 grid, cudaStream_t stream, const T* u, const T* v,
             const float* srow, const float* scol, float* out,
             long long j_start, int m, int grid_cols, int t, int l_pad,
             int nb, long long v_rstride, long long s_rstride, int has_div,
             float recip, int has_clip, float lo, float hi) {
  pcc_tiles_kernel<T, SCALED, REPLICA><<<grid, THREADS, 0, stream>>>(
      u, v, srow, scol, out, j_start, m, grid_cols, t, l_pad, nb, v_rstride,
      s_rstride, has_div, recip, has_clip, lo, hi);
}

template <typename T>
int launch(const T* u, const T* v, const float* srow, const float* scol,
           float* out, long long j_start, int pass_tiles, int m,
           int grid_cols, int t, int l_pad, int replicas,
           long long v_rstride, long long s_rstride, int has_div,
           float recip, int has_clip, float lo, float hi, void* stream) {
  if (pass_tiles <= 0 || m <= 0 || grid_cols < 0 || t <= 0 || l_pad <= 0 ||
      j_start < 0 || (srow == nullptr) != (scol == nullptr) ||
      replicas < 0 || replicas > 65535 || v_rstride < 0 || s_rstride < 0)
    return (int)cudaErrorInvalidValue;
  const int nb = (t + BM - 1) / BM;
  if ((long long)nb * nb > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)pass_tiles, (unsigned)(nb * nb),
                  (unsigned)(replicas > 0 ? replicas : 1));
  const cudaStream_t s = (cudaStream_t)stream;
  const bool scaled = srow != nullptr;
  if (scaled && replicas > 0)
    enqueue<T, true, true>(grid, s, u, v, srow, scol, out, j_start, m,
                           grid_cols, t, l_pad, nb, v_rstride, s_rstride,
                           has_div, recip, has_clip, lo, hi);
  else if (scaled)
    enqueue<T, true, false>(grid, s, u, v, srow, scol, out, j_start, m,
                            grid_cols, t, l_pad, nb, v_rstride, s_rstride,
                            has_div, recip, has_clip, lo, hi);
  else if (replicas > 0)
    enqueue<T, false, true>(grid, s, u, v, srow, scol, out, j_start, m,
                            grid_cols, t, l_pad, nb, v_rstride, s_rstride,
                            has_div, recip, has_clip, lo, hi);
  else
    enqueue<T, false, false>(grid, s, u, v, srow, scol, out, j_start, m,
                             grid_cols, t, l_pad, nb, v_rstride, s_rstride,
                             has_div, recip, has_clip, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace

// grid_cols == 0 selects the triangle (v is u, or a second operand of u's
// shape); srow and scol are both null (unscaled) or both given; replicas == 0
// is a 2-D launch, replicas > 0 a replica stack (strides in elements).
#define PCC_TILES_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* u, const T* v, const float* srow,              \
                      const float* scol, float* out, long long j_start,       \
                      int pass_tiles, int m, int grid_cols, int t, int l_pad, \
                      int replicas, long long v_rstride, long long s_rstride, \
                      int has_div, float recip, int has_clip, float lo,       \
                      float hi, void* stream) {                               \
    return launch<T>(u, v, srow, scol, out, j_start, pass_tiles, m,           \
                     grid_cols, t, l_pad, replicas, v_rstride, s_rstride,     \
                     has_div, recip, has_clip, lo, hi, stream);               \
  }

PCC_TILES_ENTRY(pcc_tiles_f32, float)
PCC_TILES_ENTRY(pcc_tiles_i8, int8_t)

extern "C" const char* pcc_tile_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
