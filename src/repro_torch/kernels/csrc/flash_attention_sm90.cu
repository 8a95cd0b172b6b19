// Causal and sliding-window GQA flash attention, forward, on Hopper's tensor
// cores (sm_90a): bf16 and fp16 operands, float32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:118
// flash_attention (body _attn_kernel, :58) for its 16-bit inputs; float32
// stays on the SIMT kernel of flash_attention.cu.  For q (B, H, S, D) and
// k, v (B, Hkv, S, D), row-major and contiguous, each (b, h) gets
// out = softmax(q k^T / sqrt(D), masked) v with KV head h / (H / Hkv).
// Query row i sees key j iff j <= i and j < S and, with a window,
// j > i - window; the window mask applies whenever a window is given (the
// reference drops it where its band covers the whole triangle,
// flash_attention.py:153-155; the port follows its oracle mha_ref).
//
// What bounds it: 4 D FLOP per visible (query, key) pair, two products of
// length D, at the bf16 / fp16 tensor-core peak (989 TFLOP/s on an H100 SXM
// at 700 W).  Llama-3.2-3B's heads (H 24, Hkv 8, D 128) at S = 32,768,
// causal, are 6.6e12 FLOP, >= 6.67 ms, against 6.4 GB of q, k, v and out
// (1.9 ms at 3.35 TB/s): bound by operations at every model case.  The
// SIMT kernel it replaces widened the operands to float32 and ran both
// products as fmaf chains, 2.7 % of this bound.
//
// Design.
//  * Work split: a tile is (b, h, 128-row query block); tiles are ordered
//    longest query rows first, across every head (GQA heads that share K
//    and V run close together in L2).  The grid is persistent, one CTA an
//    SM, and CTA c takes tiles c, 2G - 1 - c, 2G + c, ... of the G CTAs (a
//    snake, so the CTAs' causal work comes out even); the producer loads
//    the next tile's Q and first blocks under the current tile's last
//    blocks and epilogue.  Two consumer warpgroups own 64 query rows of a
//    tile each; a producer warpgroup, one thread of which issues every TMA
//    load, gives its registers to them (setmaxnreg: 40 and 232 a thread).
//    A tile loops over its own key blocks, from the band's first (the block
//    that holds key q0 - window + 1, else block 0) to the one that holds its
//    last row; nothing carries over between tiles.
//  * Staging: Q is loaded once a tile; K and V blocks of BKV keys (128, or
//    64 at a head tile of 256, for registers) pass through two rings of 2
//    slots with a full and an empty mbarrier each, in 128-byte swizzled
//    panels of 64 columns (sm90.cuh).  K and V have rings of their own, so block
//    kb + 1's K loads as soon as block kb - 1's Q K^T has read its slot.
//    The tensor maps are 3-D, (D, S, B H) for q and (D, S, B Hkv) for k and
//    v, so TMA fills rows past S and columns past D with zeros inside each
//    box; the head tile is 64, 128 or 256 columns.
//  * Q K^T: wgmma m64nBKVk16, A = the warpgroup's 64 Q rows and B = the K
//    block, both K-major from shared memory, into float32 registers.
//  * Softmax on the accumulator fragments: the row max of the unscaled
//    logits, then one FFMA and one ex2.approx a weight, log2(e) / sqrt(D)
//    folded into the scale; a row's max and sum are quad shuffles, and the
//    output accumulator shrinks once a block.  The element mask runs only on
//    blocks that cross the diagonal, the window's edge or S.
//  * P V: P (float32) is rounded to the operand type in registers and fed as
//    wgmma's register A operand; V is the MN-major B operand (the transpose
//    bit), m64nDPk16 over the block's keys.
//  * Overlap: a warpgroup issues block kb's Q K^T and block kb - 1's P V
//    together and runs kb's softmax while that P V is in flight; the two
//    warpgroups take turns to issue (named barriers, "ping-pong"), so one's
//    softmax runs under the other's products.  Without the turns the two
//    warpgroups wait on the same barriers, run in lockstep, and leave the
//    tensor cores idle during both softmaxes.
//  * Epilogue: acc / max(l, 1e-30), rounded once to the output type, stored
//    for rows < S and columns < D as 32-bit pairs.
// Left for later: 3 consumer warpgroups at a head tile of 64, where the
// exponentials bound the loop.
//
// Numerics, against the plain version (float32 P, q scaled before the dot):
//  * both products accumulate in float32 over 16-bit operands;
//  * the scale multiplies the float32 logits after the product (log2(e)
//    folded in for ex2, which has 2 ulp of error and flushes weights below
//    2^-126 to 0): on 16-bit inputs this moves only the last float32 bits
//    of a logit;
//  * the running max starts at the reference's finite NEG_INF = -1e30; a
//    masked logit is -inf, so its weight is exactly 0 and a row whose keys
//    in a block are all masked keeps l = 0, acc = 0, with no inf - inf;
//  * l sums the float32 weights; P V uses them rounded to bf16 (unit
//    roundoff 2^-8) or fp16 (2^-11).  Each weight moves by at most that
//    share of itself, so an output moves by ~2^-8 / sqrt(3) (bf16) of its
//    row's rms, and the final rounding adds up to half an ulp of |out|.
//    chip_smoke.py and the gpu tests hold the result against the plain
//    version (float32 P) per element within 2^-7 |out| + 2^-5 rms(row) in
//    bf16, 2^-10 |out| + 2^-8 rms(row) in fp16, and never above the
//    reference's bf16 bound 3e-2 (1 + |out|) (tests/test_kernels.py).
// D must be a multiple of 8 (TMA's 16-byte row stride); the wrapper pads
// other widths with zero columns, which change no logit and no output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;             // query rows per CTA
constexpr int CONSUMERS = 256;      // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 128;   // and a producer warpgroup
// setmaxnreg: the producer keeps 40 registers a thread, the consumers take
// 232 (per scheduler: 32 x 40 + 2 x 32 x 232 <= 16,384)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
// error codes beside cudaError_t: a tensor map the driver refused
constexpr int ERR_MAP = -1000;

template <int DP>
struct Tile {
  static constexpr int BKV = DP <= 128 ? 128 : 64;   // keys per block
  static constexpr int STAGES = 2;                   // of K and of V each
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_BYTES = BQ * DP * 2;
  static constexpr int KV_BYTES = BKV * DP * 2;      // K or V of one block
  static constexpr int SMEM =
      Q_BYTES + STAGES * 2 * KV_BYTES + 1024;        // + alignment slack
};

// 2^x on the special-function unit (2 ulp; 2^-inf = 0, subnormal results
// flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Mask a block's logits (MASK) and fold them into the rows' running max m
// (of the unscaled logits) and sum l; on return s holds the weights
// 2^(s scale_log2 - m scale_log2) and alpha the factor by which the rows'
// accumulator must shrink.  Rows: r0 (s[4 j], s[4 j + 1]) and r0 + 8;
// columns kc + 8 j (+ 1).
template <int BKV, bool MASK>
__device__ __forceinline__ void softmax_block(
    float (&s)[BKV / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
    float scale_log2, int r0, int kc, int S, int has_window, int window) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int row = r0 + ((e >> 1) << 3);
        const int col = kc + 8 * j + (e & 1);
        const bool vis = col <= row && col < S &&
                         (!has_window || col > row - window);
        if (!vis) s[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float mn = fmaxf(m[h], mx[h]);
    alpha[h] = ex2((m[h] - mn) * scale_log2);
    m[h] = mn;
    ms[h] = mn * scale_log2;
  }
  float ps[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], scale_log2, -ms[e >> 1]));
      s[4 * j + e] = p;
      ps[e >> 1] += p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + ps[h];
}

// One CTA's share of the work: tile u = (b h, 128-row query block), the
// tiles ordered longest rows first, across every head; the CTA's key
// blocks kb0 .. kb_last of that tile.
struct Work {
  int bh, bkv, q0, kb0, kb_last;
};

template <int BKV>
__device__ __forceinline__ Work work_of(int u, int H, int rep, int S, int BH,
                                        int nqb, int has_window,
                                        int window) {
  Work w;
  w.bh = u % BH;
  w.bkv = (w.bh / H) * (H / rep) + (w.bh % H) / rep;
  w.q0 = (nqb - 1 - u / BH) * BQ;
  w.kb_last = (min(w.q0 + BQ, S) - 1) / BKV;
  w.kb0 = 0;
  if (has_window) {
    const long long first = (long long)w.q0 - window + 1;
    if (first > 0) w.kb0 = (int)(first / BKV);
  }
  return w;
}

// The n-th tile of this CTA, in a snake over the tile list (round n even:
// n G + c, odd: (n + 1) G - 1 - c for G CTAs), so the CTAs' sums of causal
// row lengths come out even; increasing in n.
__device__ __forceinline__ int tile_of(int n) {
  const int g = (int)gridDim.x;
  const int c = (int)blockIdx.x;
  return n % 2 == 0 ? n * g + c : (n + 1) * g - 1 - c;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, T* __restrict__ out,
               int H, int rep, int S, int D, int BH, int nqb, int has_window,
               int window, float scale_log2) {
  using Cfg = Tile<DP>;
  constexpr int BKV = Cfg::BKV;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t q_empty;
  __shared__ __align__(8) uint64_t bars[4 * STAGES];
  const sm90::Ring<STAGES> kring{bars, bars + STAGES};
  const sm90::Ring<STAGES> vring{bars + 2 * STAGES, bars + 3 * STAGES};

  // panels must start on the swizzle's 1024-byte period
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;
  uint8_t* ks = base + Cfg::Q_BYTES;           // K slots, then V slots
  uint8_t* vs = ks + STAGES * Cfg::KV_BYTES;
  const int ntiles = nqb * BH;

  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    sm90::mbar_init(&q_full, 1);
    sm90::mbar_init(&q_empty, CONSUMERS);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&kring.full[s], 1);
      sm90::mbar_init(&kring.empty[s], CONSUMERS);
      sm90::mbar_init(&vring.full[s], 1);
      sm90::mbar_init(&vring.empty[s], CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // producer: per tile, Q once the consumers are done with the last one,
    // then K and V block by block through their rings (ring index it runs
    // on across tiles)
    sm90::regs_release<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      sm90::prefetch_map(&tq);
      sm90::prefetch_map(&tk);
      sm90::prefetch_map(&tv);
      for (int n = 0, it = 0, u = tile_of(0); u < ntiles; u = tile_of(++n)) {
        const Work w = work_of<BKV>(u, H, rep, S, BH, nqb, has_window,
                                    window);
        sm90::mbar_wait(&q_empty, (n & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&q_full, Cfg::Q_BYTES);
#pragma unroll
        for (int p = 0; p < Cfg::PANELS; ++p)
          sm90::tma_load_3d(qs + p * BQ * 128, &tq, &q_full, 64 * p, w.q0,
                            w.bh);
        for (int kb = w.kb0; kb <= w.kb_last; ++kb, ++it) {
          const int slot = (it % STAGES) * Cfg::KV_BYTES;
          kring.wait_empty(it);
          sm90::mbar_arrive_expect_tx(&kring.full[it % STAGES],
                                      Cfg::KV_BYTES);
#pragma unroll
          for (int p = 0; p < Cfg::PANELS; ++p)
            sm90::tma_load_3d(ks + slot + p * BKV * 128, &tk,
                              &kring.full[it % STAGES], 64 * p, kb * BKV,
                              w.bkv);
          vring.wait_empty(it);
          sm90::mbar_arrive_expect_tx(&vring.full[it % STAGES],
                                      Cfg::KV_BYTES);
#pragma unroll
          for (int p = 0; p < Cfg::PANELS; ++p)
            sm90::tma_load_3d(vs + slot + p * BKV * 128, &tv,
                              &vring.full[it % STAGES], 64 * p, kb * BKV,
                              w.bkv);
        }
      }
    }
    return;
  }
  sm90::regs_claim<CONSUMER_REGS>();

  // consumers: warpgroup wg owns rows q0 + 64 wg .. q0 + 64 wg + 63 of each
  // tile and computes every block of it, masking what its rows cannot see
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int c = t % 4;
  int r_lo, r_hi, r0;   // this tile's rows; this thread's are r0, r0 + 8

  float o[DP / 2];
  float m[2], l[2], alpha[2];
  float sacc[BKV / 2];
  uint32_t pa[BKV / 4];

  const uint32_t q_addr = sm90::smem_u32(qs) + 64 * wg * 128;
  const uint32_t k_addr = sm90::smem_u32(ks);
  const uint32_t v_addr = sm90::smem_u32(vs);
  // S = Q K^T of the block in ring slot i, issued and committed
  auto issue_qk = [&](int i) {
    const uint32_t kslot = k_addr + (i % STAGES) * Cfg::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      sm90::Wgmma<BKV, T>::ss(
          sacc,
          sm90::desc_sw128(q_addr + (kk / 4) * BQ * 128 + off, 16, 1024),
          sm90::desc_sw128(kslot + (kk / 4) * BKV * 128 + off, 16, 1024),
          kk > 0);
    }
    sm90::wgmma_commit();
  };
  // O += P V of the block in ring slot i, issued and committed
  auto issue_pv = [&](int i) {
    const uint32_t vslot = v_addr + (i % STAGES) * Cfg::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      sm90::Wgmma<DP, T>::rs(
          o, pa + 4 * kk,
          sm90::desc_sw128(vslot + kk * 16 * 128, BKV * 128, 1024), 1);
    sm90::wgmma_commit();
  };
  auto softmax = [&](int kb) {
    const int k0 = kb * BKV;
    if (k0 + BKV - 1 > r_lo || k0 + BKV > S ||
        (has_window && k0 <= r_hi - window))
      softmax_block<BKV, true>(sacc, m, l, alpha, scale_log2, r0,
                               k0 + 2 * c, S, has_window, window);
    else
      softmax_block<BKV, false>(sacc, m, l, alpha, scale_log2, r0,
                                k0 + 2 * c, S, has_window, window);
  };
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < BKV / 4; ++i)
      pa[i] = sm90::pack2(sacc[2 * i], sacc[2 * i + 1], T());
  };
  // Ping-pong: the warpgroups take turns to issue their products (named
  // barrier 1 + wg is "wg's turn"), so one's softmax runs while the
  // other's products keep the tensor cores busy.  Both take the same
  // number of turns: every block of every tile.
  auto turn_wait = [&]() { sm90::bar_sync(1 + wg, CONSUMERS); };
  auto turn_pass = [&]() { sm90::bar_arrive(2 - wg, CONSUMERS); };
  if (wg == 0) sm90::bar_arrive(1, CONSUMERS);   // warpgroup 0 starts

  for (int n = 0, it = 0, u = tile_of(0); u < ntiles; u = tile_of(++n)) {
    const Work w = work_of<BKV>(u, H, rep, S, BH, nqb, has_window, window);
    r_lo = w.q0 + 64 * wg;
    r_hi = r_lo + 63;
    r0 = r_lo + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.0f;
    // ring index of block kb; Q is released after the tile's last Q K^T
    const int i0 = it - w.kb0;
    auto qk_done = [&](int kb) {
      kring.release(i0 + kb);
      if (kb == w.kb_last) sm90::mbar_arrive(&q_empty);
    };

    sm90::mbar_wait(&q_full, n & 1);
    kring.wait_full(i0 + w.kb0);
    turn_wait();
    sm90::wgmma_fence();
    issue_qk(i0 + w.kb0);
    turn_pass();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sacc);
    qk_done(w.kb0);
    softmax(w.kb0);
    pack();
    // block kb's Q K^T and softmax run while block kb - 1's P V is in
    // flight; the accumulator shrinks by alpha once that P V is done
    for (int kb = w.kb0 + 1; kb <= w.kb_last; ++kb) {
      kring.wait_full(i0 + kb);
      vring.wait_full(i0 + kb - 1);
      sm90::fence_regs(o);
      turn_wait();
      sm90::wgmma_fence();
      issue_qk(i0 + kb);
      issue_pv(i0 + kb - 1);
      turn_pass();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sacc);
      qk_done(kb);
      softmax(kb);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      vring.release(i0 + kb - 1);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      pack();
    }
    vring.wait_full(i0 + w.kb_last);
    sm90::fence_regs(o);
    turn_wait();
    sm90::wgmma_fence();
    issue_pv(i0 + w.kb_last);
    turn_pass();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    vring.release(i0 + w.kb_last);
    it = i0 + w.kb_last + 1;

    // epilogue: this tile's rows < S, while the producer loads the next
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      if (row >= S) continue;
      const float den = fmaxf(l[h], 1e-30f);
      T* orow = out + ((size_t)w.bh * S + row) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * c;
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) = sm90::pack2(
              o[4 * j + 2 * h] / den, o[4 * j + 2 * h + 1] / den, T());
      }
    }
  }
  if (wg == 0) turn_wait();   // take warpgroup 1's last turn: barrier drained
}

template <typename T, int DP>
int enqueue(const T* q, const T* k, const T* v, T* out, int B, int H,
            int Hkv, int S, int D, int has_window, int window, float scale,
            cudaStream_t stream) {
  using Cfg = Tile<DP>;
  CUtensorMap tq, tk, tv;
  const CUtensorMapDataType type = sm90::MapType<T>::value;
  CUresult r = sm90::encode_3d_sw128(&tq, type, q, D, S, (uint64_t)B * H, BQ);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_3d_sw128(&tk, type, k, D, S, (uint64_t)B * Hkv,
                              Cfg::BKV);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_3d_sw128(&tv, type, v, D, S, (uint64_t)B * Hkv,
                              Cfg::BKV);
  if (r != CUDA_SUCCESS) return ERR_MAP - (int)r;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int bh = B * H;
  const int nqb = (S + BQ - 1) / BQ;
  // persistent: one CTA an SM (its shared memory and registers allow one)
  const int ctas = (int)std::min<long long>((long long)nqb * bh, sms);
  flash_fwd_sm90<T, DP><<<ctas, THREADS, Cfg::SMEM, stream>>>(tq, tk, tv, out, H, H / Hkv, S, D, bh, nqb, has_window, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int B, int H,
           int Hkv, int S, int D, int has_window, int window, float scale,
           void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || D <= 0 ||
      D > 256 || D % 8)
    return (int)cudaErrorInvalidValue;
  const long long bh = (long long)B * H;
  const long long nqb = (S + BQ - 1) / BQ;
  if (bh > 0x7fffffffLL || nqb * bh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64)
    return enqueue<T, 64>(q, k, v, out, B, H, Hkv, S, D, has_window, window,
                          scale, s);
  if (D <= 128)
    return enqueue<T, 128>(q, k, v, out, B, H, Hkv, S, D, has_window,
                           window, scale, s);
  return enqueue<T, 256>(q, k, v, out, B, H, Hkv, S, D, has_window, window,
                         scale, s);
}

}  // namespace

// q, out (B, H, S, D); k, v (B, Hkv, S, D); all row-major, contiguous,
// 16-byte aligned, of one type; D a multiple of 8, at most 256.
// has_window == 0 runs plain causal attention; scale is the float32 logit
// scale (1 / sqrt of the unpadded head width).  Returns the launch's
// cudaError_t, or a code below ERR_MAP for a refused tensor map.
#define FLASH_SM90_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const T* q, const T* k, const T* v, T* out, int B,     \
                      int H, int Hkv, int S, int D, int has_window,          \
                      int window, float scale, void* stream) {               \
    return launch<T>(q, k, v, out, B, H, Hkv, S, D, has_window, window,      \
                     scale, stream);                                         \
  }

FLASH_SM90_ENTRY(flash_attention_sm90_bf16, __nv_bfloat16)
FLASH_SM90_ENTRY(flash_attention_sm90_f16, __half)

extern "C" const char* flash_attention_sm90_error_string(int err) {
  static thread_local char buf[96];
  if (err <= ERR_MAP) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             ERR_MAP - err);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}
