// The float32 tile mainloop of pcc_tile.cu (sm_90a): a 128 x 128 block of
// U V^T in IEEE float32 FMA on the SIMT pipes.
//
// Hopper's tensor cores have no IEEE-f32 mode (TF32 keeps 10 mantissa
// bits), so float32 tiles stay an SGEMM on the FP32 pipes (67 TFLOP/s on an
// H100 SXM at 700 W).  What sets its pace there is the shared-memory and L2
// traffic per FMA and the latency between a chunk's load and its use:
//  * 128 x 128 outputs per CTA of 256 threads, 8 x 8 per thread read as two
//    float4 strips 64 apart on each axis: per sample a warp issues 4
//    shared-memory loads (one wavefront each) for 64 FMAs a thread, and a
//    CTA reads 1 KB from L2 per 32 KFLOP (32 FLOP/B, twice a 64 x 64
//    block's).
//  * A ring of STAGES chunks of BK samples, filled straight from global
//    memory by 4-byte cp.async (no register staging), with one barrier per
//    chunk: the loads of chunk c + STAGES - 1 are issued right after the
//    barrier that frees its slot, then chunk c's FMAs run.
//  * Shared memory is k-major (plane[k][row], row stride LD = 132 floats),
//    so the transposition happens at the copy: a warp's 4-byte copies
//    cover 4 rows x 8 samples, and the stride's 4-bank shift per sample
//    puts them in 32 distinct banks, while a sample's rows stay contiguous
//    and 16-byte aligned for the float4 reads, at a constant offset per k.
//  * A full block's chunks take plain copies.  Rows past the block's
//    operand rows and samples past l_pad are zero-filled by the copy
//    itself (src-size 0): no masks in the FMAs.
//
// The invariant every bitwise check of the repository rests on: each
// output is one sequential fmaf chain over k = 0 .. l_pad-1 from +0, and
// the float32 tiles (pcc_tile.cu) and the float32 top-k select
// (pcc_topk.cu) both run this routine, so tiles do not depend on the pass,
// the launch or the kernel that made them.  Zero-filled samples past l_pad add +0 to a sum that is
// never -0, so they change no bit.  No split-K and no reordered sums.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace pcc {
namespace sgemm {

constexpr int BLOCK = 128;               // output rows (== columns) a CTA
constexpr int HALF = BLOCK / 2;          // distance of a thread's strips
constexpr int BK = 16;                   // samples per chunk
constexpr int STAGES = 4;                // chunks in the ring
constexpr int THREADS = 256;
constexpr int TM = 8;                    // outputs a thread on each axis
constexpr int LD = BLOCK + 4;            // row stride of a k-major plane
constexpr int PLANE = BK * LD;           // floats of one operand's chunk
constexpr int SMEM_BYTES = STAGES * 2 * PLANE * (int)sizeof(float);
// the copy: a warp moves 4 rows x 8 samples of an operand per cp.async, so
// a thread moves ROWS rows x GROUPS groups of 8 samples a chunk
constexpr int ROWS = 4;
constexpr int GROUPS = BK / 8;
static_assert(BLOCK == 128 && THREADS == 256 && BK % 8 == 0 &&
                  ROWS * GROUPS * THREADS == BLOCK * BK,
              "the copy and read maps below assume this shape");

// Thread tid's output rows (i) and columns (j) inside the block, i, j in
// 0 .. TM-1: warps tile the block 4 (rows) x 2 (columns), lanes 4 x 8.
__device__ __forceinline__ int ty_of(int tid) {
  return (tid / 64) * 4 + (tid % 32) / 8;
}
__device__ __forceinline__ int tx_of(int tid) {
  return ((tid / 32) % 2) * 8 + tid % 8;
}
__device__ __forceinline__ int strip(int base, int i) {
  return (i / 4) * HALF + base * 4 + i % 4;
}

// acc = the (128, 128) block a_base[0:128] . b_base[0:128]^T over l_pad
// samples, rows a_rows.. and b_rows.. of the block reading as zero; acc[i][j]
// is row strip(ty_of(tid), i), column strip(tx_of(tid), j).  smem: SMEM_BYTES
// of dynamic shared memory, 16-byte aligned.
__device__ __forceinline__ void accumulate_block(
    const float* __restrict__ a_base, const float* __restrict__ b_base,
    int a_rows, int b_rows, int l_pad, float* smem,
    float (&acc)[TM][TM]) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // The copy: this thread moves rows (warp + 8 j) * 4 + lane / 8, j <
  // ROWS, at samples 8 h + lane % 8, h < GROUPS, of each operand; both
  // operands share the offsets (same l_pad), not the row validity.  A
  // chunk of a full block (every row inside the operand, every sample
  // below l_pad) takes unpredicated copies; the others zero-fill.
  const int lx = lane % 8;
  int goff[ROWS], soff[ROWS];
  unsigned a_ok = 0, b_ok = 0;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int row = (warp + 8 * j) * 4 + lane / 8;
    goff[j] = row * l_pad + lx;
    soff[j] = (lx * LD + row) * 4;
    a_ok |= (unsigned)(row < a_rows) << j;
    b_ok |= (unsigned)(row < b_rows) << j;
  }
  const bool full = a_rows >= BLOCK && b_rows >= BLOCK;   // uniform
  const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(smem);
  auto load = [&](int chunk) {
    const int k0 = chunk * BK;
    const uint32_t sa = s_base + (chunk % STAGES) * 2 * PLANE * 4;
    if (full && k0 + BK <= l_pad) {   // uniform
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const float* pa = a_base + goff[j] + k0;
        const float* pb = b_base + goff[j] + k0;
#pragma unroll
        for (int h = 0; h < GROUPS; ++h) {
          const uint32_t s = sa + soff[j] + 8 * h * LD * 4;
          cp_async4(s, pa + 8 * h);
          cp_async4(s + PLANE * 4, pb + 8 * h);
        }
      }
      return;
    }
#pragma unroll
    for (int h = 0; h < GROUPS; ++h) {
      const bool kin = k0 + 8 * h + lx < l_pad;
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        const int g = goff[j] + k0 + 8 * h;
        const uint32_t s = sa + soff[j] + 8 * h * LD * 4;
        const bool ai = kin && ((a_ok >> j) & 1u);
        const bool bi = kin && ((b_ok >> j) & 1u);
        cp_async4(s, ai ? a_base + g : a_base, ai);
        cp_async4(s + PLANE * 4, bi ? b_base + g : b_base, bi);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;

  const int ty4 = ty_of(tid) * 4, tx4 = tx_of(tid) * 4;
  const int nk = (l_pad + BK - 1) / BK;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nk) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of chunk c landed
    __syncthreads();               // everyone's, and chunk c - 1 is read
    if (c + STAGES - 1 < nk) load(c + STAGES - 1);
    cp_async_commit();
    const float* pa = smem + (c % STAGES) * 2 * PLANE;
    const float* pb = pa + PLANE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(pa + k * LD + ty4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(pa + k * LD + ty4 + HALF);
      const float4 b0 = *reinterpret_cast<const float4*>(pb + k * LD + tx4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(pb + k * LD + tx4 + HALF);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TM] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
}

}  // namespace sgemm
}  // namespace pcc
