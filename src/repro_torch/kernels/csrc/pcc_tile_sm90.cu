// All-pairs correlation tiles on Hopper's tensor cores (sm_90a): bfloat16,
// float16, float8_e4m3fn, float8_e5m2 and int8 operands, float32 tiles.
//
// Replaces the Pallas TPU kernel src/repro/kernels/pcc_tile.py:299
// pcc_tiles (body _kernel, :103) for its bf16, fp16, fp8 and int8 operands in
// every mode; float32 stays on the SIMT kernel of pcc_tile.cu.  The
// modes and the launch contract are those of pcc_tile.cu:
//   * the triangle (grid_cols == 0): tile ids invert to upper-triangle
//     coordinates with tile_coord's exact integer math (pcc_accum.cuh),
//     columns from U itself or from a second operand of U's exact shape;
//   * the rectangular grid (grid_cols > 0), columns from V;
//   * the replica axis (replicas > 0): V is a stack of R column operands,
//     replica r at v + r * v_rstride, its scales at scol + r * s_rstride,
//     the output (R, pass_tiles, t, t);
//   * per-row scales srow / scol (quantized operands), multiplied into each
//     finished value before the EpilogueSpec, in the order of finalize
//     (pcc_accum.cuh): v * (srow * scol), then * recip, then the clip.
// Output slot i holds tile min(j_start + i, total - 1).
//
// What bounds it: 2 l t^2 operations a tile at the tensor-core peak of the
// operand type (989 TFLOP/s bf16, 1,979 fp8 and int8, H100 SXM at 700 W).
// At the paper's Table II shape (n = 17,555, l = 5,072, t = 256, 2,415
// tiles) a pass is 1.61e12 operations, >= 1.62 ms in bf16 and >= 0.81 ms in
// fp8 or int8, against 633 MB of float32 tiles written (0.19 ms at
// 3.35 TB/s): bound by operations.  The SIMT kernels this replaces widened
// bf16 and fp8 to float32 and reached 3 % (bf16) and 1.4 % (fp8) of these
// bounds, and int8 5 % (4-way integer dot products on the SIMT pipes).
//
// Design (the mainloop is pcc_mma.cuh, shared with the bf16 top-k select):
//  * Work: a work item is one 128 x 128 block of one tile of one replica;
//    a (t, t) tile has ceil(t / 128)^2 of them (4 at t = 256).  The grid is
//    persistent, one CTA an SM, and CTA c takes items c, c + G, c + 2 G ...
//    in the order (replica, tile slot, block), so the items in flight at
//    once share their tiles' operand rows in L2.
//  * Operands by TMA from 3-D maps over (1, n_pad, l_pad) for U and
//    (R or 1, rows, l_pad) for V: the replica is the map's third
//    coordinate.  The producer warpgroup keeps the ring of STAGES stages
//    full across items, so the next item's loads run under this item's
//    last products and its epilogue; it gives its registers to the
//    consumers (setmaxnreg 40 / 232).
//  * Products: two consumer warpgroups, 64 rows each, wgmma m64n128 (k16
//    bf16 and fp16, k32 fp8 and int8) from shared memory; fp8 promotes its partial
//    sums into float32 registers every 128 samples, int8 keeps one exact
//    int32 sum over the whole sample axis, converted to float32 once, so
//    its tiles are bitwise the plain version's (pcc_mma.cuh).
//  * Epilogue: the scale product and the EpilogueSpec in registers, then
//    the float32 values straight from the accumulator layout to the tile,
//    8 bytes a thread (4 threads fill a 32-byte sector of a row), rows and
//    columns past t masked.  The stores are not waited on, so they overlap
//    the next item's products.
// TMA needs 16-byte row strides and bases: l_pad a multiple of 8 (bf16, fp16) or
// 16 (fp8, int8) and v_rstride likewise; the wrapper zero-pads the sample
// axis otherwise (zero samples add exactly zero).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

#include "pcc_mma.cuh"

namespace {

using namespace pcc;
using mma::ACC;
using mma::BLOCK;

constexpr int STAGES = 5;           // 160 KB of ring
constexpr int SMEM = STAGES * mma::STAGE_BYTES + 1024;   // + alignment
// setmaxnreg: the producer keeps 40 registers a thread, the consumers take
// 232 (per scheduler: 32 x 40 + 2 x 32 x 232 <= 16,384)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// error codes beside cudaError_t: a tensor map cuTensorMapEncodeTiled refused
constexpr int ERR_MAP = -1000;

struct Item {
  int rep, slot, yt, xt, r_in, c_in;
};

// Work item `w`: (replica, tile slot, block) with the block fastest.
__device__ __forceinline__ Item item_of(long long w, int nb, int pass_tiles,
                                        long long j_start, int m,
                                        int grid_cols) {
  Item it;
  const int nb2 = nb * nb;
  const int b = (int)(w % nb2);
  const long long rest = w / nb2;
  it.slot = (int)(rest % pass_tiles);
  it.rep = (int)(rest / pass_tiles);
  long long jt = j_start + it.slot;
  const long long total = tile_total(m, grid_cols);
  if (jt > total - 1) jt = total - 1;
  tile_coord(m, grid_cols, jt, &it.yt, &it.xt);
  it.r_in = (b / nb) * BLOCK;
  it.c_in = (b % nb) * BLOCK;
  return it;
}

template <typename T, bool SCALED>
__global__ void __launch_bounds__(mma::THREADS, 1)
pcc_tiles_sm90(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb,
               const float* __restrict__ srow,
               const float* __restrict__ scol, float* __restrict__ out,
               long long j_start, int pass_tiles, int m, int grid_cols, int t,
               int nk, int nb, long long items, long long s_rstride,
               int has_div, float recip, int has_clip, float lo, float hi) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  const sm90::Ring<STAGES> ring{bars, bars + STAGES};
  // stages start on the swizzle's 1024-byte period
  uint8_t* slots = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&ring.full[s], 1);
      sm90::mbar_init(&ring.empty[s], mma::CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= mma::CONSUMERS / 32) {
    sm90::regs_release<PRODUCER_REGS>();
    if (threadIdx.x == mma::CONSUMERS) {
      sm90::prefetch_map(&ta);
      sm90::prefetch_map(&tb);
      int it = 0;
      for (long long w = blockIdx.x; w < items; w += gridDim.x) {
        const Item i = item_of(w, nb, pass_tiles, j_start, m, grid_cols);
        mma::load_block<T, STAGES>(&ta, &tb, ring, slots, it, nk,
                                   i.yt * t + i.r_in, i.xt * t + i.c_in,
                                   i.rep);
      }
    }
    return;
  }
  sm90::regs_claim<CONSUMER_REGS>();

  const int wg = warp / 4;
  const int lane = threadIdx.x % 128;
  // this thread's accumulator rows (+ 8) and first column in the block
  const int row0 = 64 * wg + 16 * (lane / 32) + (lane % 32) / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t slot_addr = sm90::smem_u32(slots);
  const bool pairs = t % 2 == 0;   // 8-byte aligned column pairs
  typename mma::Operand<T>::Acc acc[ACC];
  int it = 0;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const Item i = item_of(w, nb, pass_tiles, j_start, m, grid_cols);
    mma::mma_block<T, STAGES>(acc, ring, slot_addr, it, nk, wg);

    float* tile = out + ((size_t)i.rep * pass_tiles + i.slot) * t * t;
    const float* sc = SCALED ? scol + i.rep * s_rstride + (size_t)i.xt * t
                             : nullptr;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = i.r_in + row0 + 8 * h;
      if (rr >= t) continue;
      const float sr = SCALED ? srow[(size_t)i.yt * t + rr] : 0.f;
      float* orow = tile + (size_t)rr * t;
#pragma unroll
      for (int j = 0; j < BLOCK / 8; ++j) {
        const int cc = i.c_in + 8 * j + col0;
        if (cc >= t) break;
        const float v0 = finalize<SCALED>(
            mma::acc_value(acc[4 * j + 2 * h]), sr, SCALED ? sc[cc] : 0.f,
            has_div, recip, has_clip, lo, hi);
        if (cc + 1 < t) {
          const float v1 = finalize<SCALED>(
              mma::acc_value(acc[4 * j + 2 * h + 1]), sr,
              SCALED ? sc[cc + 1] : 0.f, has_div, recip, has_clip, lo, hi);
          if (pairs) {
            *reinterpret_cast<float2*>(orow + cc) = make_float2(v0, v1);
          } else {
            orow[cc] = v0;
            orow[cc + 1] = v1;
          }
        } else {
          orow[cc] = v0;
        }
      }
    }
  }
}

template <typename T, bool SCALED>
int enqueue(const CUtensorMap& ta, const CUtensorMap& tb, const float* srow,
            const float* scol, float* out, long long j_start, int pass_tiles,
            int m, int grid_cols, int t, int nk, int nb, long long items,
            long long s_rstride, int has_div, float recip, int has_clip,
            float lo, float hi, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      pcc_tiles_sm90<T, SCALED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // persistent: one CTA an SM (its shared memory allows one)
  const int ctas = (int)std::min<long long>(items, sms);
  pcc_tiles_sm90<T, SCALED><<<ctas, mma::THREADS, SMEM, stream>>>(
      ta, tb, srow, scol, out, j_start, pass_tiles, m, grid_cols, t, nk, nb,
      items, s_rstride, has_div, recip, has_clip, lo, hi);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* u, const T* v, const float* srow, const float* scol,
           float* out, long long j_start, int pass_tiles, int m,
           int grid_cols, int t, int l_pad, int replicas,
           long long v_rstride, long long s_rstride, int has_div,
           float recip, int has_clip, float lo, float hi, void* stream) {
  if (pass_tiles <= 0 || m <= 0 || grid_cols < 0 || t <= 0 || l_pad <= 0 ||
      j_start < 0 || (srow == nullptr) != (scol == nullptr) ||
      replicas < 0 || v_rstride < 0 || s_rstride < 0)
    return (int)cudaErrorInvalidValue;
  constexpr int elem = (int)sizeof(T);
  const long long u_rows = (long long)m * t;
  const long long v_rows = grid_cols > 0 ? (long long)grid_cols * t : u_rows;
  const long long planes = replicas > 0 ? replicas : 1;
  const long long plane_stride = replicas > 0 ? v_rstride : v_rows * l_pad;
  if ((l_pad * elem) % 16 || (plane_stride * elem) % 16 ||
      u_rows > INT32_MAX || v_rows > INT32_MAX ||
      ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(v)) %
       16))
    return (int)cudaErrorMisalignedAddress;
  const int nb = (t + BLOCK - 1) / BLOCK;
  const long long items = planes * pass_tiles * nb * nb;
  CUtensorMap ta, tb;
  const CUtensorMapDataType type = sm90::MapType<T>::value;
  CUresult r = sm90::encode_3d(&ta, type, elem, u, l_pad, u_rows, 1,
                               u_rows * l_pad, BLOCK);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_3d(&tb, type, elem, v, l_pad, v_rows, planes,
                        plane_stride, BLOCK);
  if (r != CUDA_SUCCESS) return ERR_MAP - (int)r;
  const int nk = mma::stages<T>(l_pad);
  const cudaStream_t s = (cudaStream_t)stream;
  if (srow != nullptr)
    return enqueue<T, true>(ta, tb, srow, scol, out, j_start, pass_tiles, m,
                            grid_cols, t, nk, nb, items, s_rstride, has_div,
                            recip, has_clip, lo, hi, s);
  return enqueue<T, false>(ta, tb, srow, scol, out, j_start, pass_tiles, m,
                           grid_cols, t, nk, nb, items, s_rstride, has_div,
                           recip, has_clip, lo, hi, s);
}

}  // namespace

// The arguments of pcc_tile.cu's entry points: grid_cols == 0 selects the
// triangle (v is u, or a second operand of u's shape); srow and scol are
// both null (unscaled) or both given; replicas == 0 is a 2-D launch,
// replicas > 0 a replica stack (strides in elements).  Returns the launch's
// cudaError_t, or a code below ERR_MAP for a refused tensor map.
#define PCC_TILES_SM90_ENTRY(NAME, T)                                         \
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

PCC_TILES_SM90_ENTRY(pcc_tiles_sm90_bf16, __nv_bfloat16)
PCC_TILES_SM90_ENTRY(pcc_tiles_sm90_f16, __half)
PCC_TILES_SM90_ENTRY(pcc_tiles_sm90_e4m3, __nv_fp8_e4m3)
PCC_TILES_SM90_ENTRY(pcc_tiles_sm90_e5m2, __nv_fp8_e5m2)
PCC_TILES_SM90_ENTRY(pcc_tiles_sm90_i8, int8_t)

extern "C" const char* pcc_tile_sm90_error_string(int err) {
  static thread_local char buf[96];
  if (err <= ERR_MAP) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             ERR_MAP - err);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}
