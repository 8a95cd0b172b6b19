// The tensor-core tile accumulation shared by pcc_tile_sm90.cu (bf16, fp16,
// fp8 and int8 tiles) and the bf16, fp16 and int8 select kernels of
// pcc_topk.cu (sm_90a).
//
// A work item is a 128 x 128 block of one (t, t) tile of U V^T: rows
// a_row .. a_row + 127 of U against rows b_row .. b_row + 127 of V (of
// replica plane `rep`), over the whole sample axis.  Both operands are
// row-major (rows, l_pad) arrays, so both are K-major, as fp8 wgmma
// requires.  A CTA holds a producer warpgroup, one thread of which issues
// every TMA load, and two consumer warpgroups, each owning 64 rows of the
// block against all 128 columns (wgmma m64n128).
//
// Staging: each stage of the ring holds one 128-byte swizzle row per block
// row of A and of B (64 bf16 / fp16 or 128 fp8 / int8 samples: 16 KB each),
// loaded by TMA from 3-D tensor maps over (planes, rows, l_pad); rows past the
// array and samples past l_pad read as zero, so ragged tiles and sample
// axes need no masks here (rows past the tile's edge are computed and never
// stored).
// A stage is four wgmma steps of 32 bytes of depth: k16 for bf16 and fp16,
// k32 for fp8 and int8.
//
// Accumulation.  Every output (i, j) of a block is the same sequence of
// instructions whatever the kernel, the tile's place in the pass, the
// replica or the block's neighbours: stage by stage, four wgmma steps in
// depth order; so a select kernel that runs this code gives pcc_tiles'
// bits.
//   * fp8 (PROMOTE): Hopper's fp8 tensor-core sums keep about 14 bits
//     (DeepSeek-V3 report, section 3.3.2), so each stage's four steps start
//     from zero in a partial accumulator and the partial is added into a
//     float32 register accumulator with IEEE adds: one promotion every 128
//     samples, as CUTLASS's sm90 fp8 mainloop does without "fast
//     accumulation", and as the reference adds one block product at a time
//     (src/repro/kernels/pcc_tile.py:129-146).
//   * bf16 and fp16: one accumulator over the whole axis, the next stage's
//     steps issued before the last ones finish (its sums keep float32's bits,
//     so it needs no promotion).
//   * int8: the same single accumulator, in int32 (wgmma s32.s8.s8).
//     Integer sums are exact in any order while they stay inside int32
//     (the wrapper keeps l_pad <= INT8_MAX_L_PAD, so l_pad * 128^2 < 2^31),
//     so there is nothing to promote: the finished sum is converted to
//     float once (acc_value), in the tiles and in the int8 select alike,
//     so the tiles are bitwise the plain version's and the select's
//     values.
// Against the plain version (float32 block products) bf16, fp16 and fp8
// results move by the tensor cores' own rounding; the gate that holds them is
// kernels/narrow_gate.py.

#pragma once

#include <type_traits>

#include "pcc_accum.cuh"
#include "sm90.cuh"

namespace pcc {
namespace mma {

constexpr int BLOCK = 128;                  // block rows and columns
constexpr int ROW_BYTES = 128;              // one swizzle row of samples
constexpr int BOX_BYTES = BLOCK * ROW_BYTES;        // one operand's stage
constexpr int STAGE_BYTES = 2 * BOX_BYTES;          // A, then B
constexpr int CONSUMERS = 256;              // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 128;    // and the producer warpgroup
constexpr int ACC = BLOCK / 2;              // m64n128 float32 registers
constexpr int STEPS = 4;                    // wgmma steps per stage

template <typename T>
struct Operand {
  static constexpr int SAMPLES = ROW_BYTES / (int)sizeof(T);  // per stage
  static constexpr bool INT = std::is_same<T, int8_t>::value;
  static constexpr bool PROMOTE = sizeof(T) == 1 && !INT;      // fp8
  using Acc = typename std::conditional<INT, int, float>::type;
};

// A finished accumulator as float32: int32 sums rounded once.
__device__ __forceinline__ float acc_value(float x) { return x; }
__device__ __forceinline__ float acc_value(int x) { return __int2float_rn(x); }

// Stages over a sample axis of l_pad.
template <typename T>
__host__ __device__ __forceinline__ int stages(int l_pad) {
  return (l_pad + Operand<T>::SAMPLES - 1) / Operand<T>::SAMPLES;
}

// Producer (one thread): the nk stages of one block into the ring, from
// ring index `it` on.
template <typename T, int STAGES>
__device__ __forceinline__ void load_block(const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           const sm90::Ring<STAGES>& ring,
                                           uint8_t* slots, int& it, int nk,
                                           int a_row, int b_row, int rep) {
  for (int kb = 0; kb < nk; ++kb, ++it) {
    uint8_t* slot = slots + (it % STAGES) * STAGE_BYTES;
    uint64_t* bar = &ring.full[it % STAGES];
    ring.wait_empty(it);
    sm90::mbar_arrive_expect_tx(bar, STAGE_BYTES);
    sm90::tma_load_3d(slot, ta, bar, kb * Operand<T>::SAMPLES, a_row, 0);
    sm90::tma_load_3d(slot + BOX_BYTES, tb, bar, kb * Operand<T>::SAMPLES,
                      b_row, rep);
  }
}

// The four wgmma steps of ring slot `it` for warpgroup wg into d; step 0
// overwrites d when `first`.
template <typename T, int STAGES, typename A>
__device__ __forceinline__ void issue_stage(A (&d)[ACC], uint32_t slots,
                                            int it, int wg, bool first) {
  const uint32_t a = slots + (it % STAGES) * STAGE_BYTES + wg * 64 * ROW_BYTES;
  const uint32_t b = slots + (it % STAGES) * STAGE_BYTES + BOX_BYTES;
#pragma unroll
  for (int s = 0; s < STEPS; ++s)
    sm90::Wgmma<BLOCK, T>::ss(d, sm90::desc_sw128(a + 32 * s, 16, 1024),
                              sm90::desc_sw128(b + 32 * s, 16, 1024),
                              !(first && s == 0));
  sm90::wgmma_commit();
}

// Consumer warpgroup wg: acc = its 64 rows of the block, over nk stages
// from ring index `it` on (advanced past them).  Thread layout of acc: the
// m64n128 accumulator (sm90.cuh).
template <typename T, int STAGES>
__device__ __forceinline__ void mma_block(
    typename Operand<T>::Acc (&acc)[ACC], const sm90::Ring<STAGES>& ring,
    uint32_t slots, int& it, int nk, int wg) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;
  if constexpr (Operand<T>::PROMOTE) {
    float part[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) part[i] = 0.0f;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      ring.wait_full(it);
      sm90::fence_regs(part);
      sm90::wgmma_fence();
      issue_stage<T, STAGES>(part, slots, it, wg, true);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(part);
      ring.release(it);
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
    }
  } else {
    for (int kb = 0; kb < nk; ++kb) {
      ring.wait_full(it + kb);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
      issue_stage<T, STAGES>(acc, slots, it + kb, wg, kb == 0);
      if (kb > 0) {
        sm90::wgmma_wait<1>();   // stage kb - 1 has been read
        ring.release(it + kb - 1);
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    ring.release(it + nk - 1);
    it += nk;
  }
}

}  // namespace mma
}  // namespace pcc
