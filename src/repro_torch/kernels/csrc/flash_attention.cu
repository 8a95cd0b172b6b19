// Causal and sliding-window GQA flash attention, forward, for NVIDIA Hopper
// (sm_90a), float32 operands on the SIMT pipes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:118
// flash_attention (body _attn_kernel, :58) for float32 inputs; bf16 and
// fp16 run on the tensor cores (flash_attention_sm90.cu).  For q (B, H, S,
// D) and k, v (B, Hkv, S, D), row-major and contiguous, each (b, h) gets
// out = softmax(q k^T / sqrt(D), masked) v with KV head h / (H / Hkv).
// Query row i sees key j iff j <= i and j < S and, with a window,
// j > i - window.  The window mask applies whenever a window is given; the
// reference drops it once its band of key blocks covers the whole triangle
// (flash_attention.py:153-155), and the port follows the oracle mha_ref.
//
// What bounds it: 4 D FLOP per visible (query, key) pair (two dot products
// of length D), on the SIMT FP32 pipes (67 TFLOP/s on an H100 SXM at 700 W):
// IEEE float32 has no tensor-core path (TF32 keeps 10 mantissa bits).
// Llama-3.2-3B's heads (H 24, Hkv 8, D 128) at S = 4,096, causal, are
// 1.03e11 FLOP, >= 1.54 ms, against 134 MB of q, k, v and out (0.04 ms at
// 3.35 TB/s): bound by operations.  At that bound every SMSP issues an FFMA
// each cycle, so what the design spends besides FFMAs (shared-memory reads,
// barriers, the softmax) is what it loses.
//
// Design.  The TPU kernel walks a 1-D grid of (query block, key block) jobs
// in row-major lower-triangle (or band) order and carries the online-softmax
// state (m, l, acc) in VMEM from one sequential grid step to the next.  CUDA
// blocks run in parallel and in no order, so here one CTA owns one
// (b, h, BQ-row query block) and loops over its own 64-key blocks, from the
// band's first (the block that holds key q0 - window + 1, else block 0) to
// the block that holds the diagonal; nothing carries over between CTAs.
// CTAs are numbered so that the longest query rows (the last blocks of the
// triangle) start first, across every head.
//  * Threads: 128 (four warps) as 8 row groups x 16 lanes; a row group is a
//    half warp, so row maxima and sums are shuffles.  Thread (ty, tx) owns
//    SR query rows ty, ty + 8, .. ty + 8 (SR - 1) in both products (rows 8
//    apart, so the two row groups of a warp read Q rows in distinct banks;
//    P keeps them at positions ty SR .. ty SR + SR - 1): their logits
//    against keys tx, tx + 16, tx + 32, tx + 48, and their outputs in D / 16
//    columns (float4 strips 64 apart).  SR = 8 (BQ = 64) up to D = 128; at
//    D = 256, whose 8 x 16 accumulators would not fit beside the logits,
//    SR = 4 (BQ = 32).  Per step a thread holds 32 (16) logits and up to 64
//    accumulators.
//  * Shared-memory reads: Q (scaled, row stride D + 4) stays resident; a
//    K depth step of 4 reads 4 float4 of K (one per key) and SR float4 of
//    Q for 16 SR FMAs; a P V key step reads SR / 4 float4 of P and D / 64
//    float4 of V for SR D / 16 FMAs (64 at D = 128): twice the FMAs per
//    read of the 4 x 4 block this replaces.  The 16 lanes of a row group
//    read 16 distinct K rows (stride KC + 4: four banks apart) or one V row
//    (contiguous), a half warp's two row groups the same P and Q words.
//  * Staging: one ring of STAGES slots, filled by cp.async straight from
//    global memory (16-byte copies when D % 4 == 0 and the bases are
//    aligned, else 4-byte ones), carries the CTA's whole stream of chunks:
//    per key block, the K block in depth chunks of KC (<= 32) values, then
//    the V block in chunks of VC keys (VC D <= 2,048 floats).  Chunk c +
//    STAGES - 1 is issued right after the barrier of chunk c, so the next
//    chunks, across block boundaries, load while this one is computed.
//    Keys past S and columns past D are zero-filled by the copy; chunks
//    with every row below S of a head with D = DP take plain copies, at
//    offsets fixed per thread.
//  * Barriers: one per chunk (the ring's), 8 per key block at D = 128.  P
//    goes through its own buffer, written transposed (key-major, float4 of
//    four rows) right before the first V chunk's barrier, which publishes
//    it; the next block's K chunk barriers order its reads before the next
//    write.
//  * Masks: a key block is checked once, uniformly, for whether it crosses
//    the diagonal, the window's edge or S; only such blocks evaluate the
//    per-element mask (32-bit compares).
//
// Numerics:
//  * q is multiplied by the float32 scale 1 / sqrt(D) before the dot, as in
//    _attn_kernel (:71);
//  * each logit is one fmaf chain over d = 0 .. D - 1 from +0, IEEE float32
//    (no TF32); zero-filled columns add exact zeros;
//  * the running max starts at the reference's finite NEG_INF = -1e30 and a
//    masked entry's weight is exactly 0, so a row whose keys in one block
//    are all masked (the far block of a band) keeps l = 0 and acc = 0, and
//    no inf - inf arises;
//  * a weight is ex2.approx(fmaf(s, log2 e, -m log2 e)) with m log2 e
//    rounded once per row and block (the block's correction alpha uses the
//    same rounded products); against expf(s - m) this moves a weight by
//    ~2^-22 of itself and saved 1-4 % of the time (hymba's D = 64 most);
//    the scale of q stays 1 / sqrt(D), as the plain version's;
//  * the final acc / max(l, 1e-30) is an IEEE division; each output is one
//    fmaf chain over the keys in order, rescaled by the running max's
//    correction between blocks.
// S need not be a multiple of any block: keys j >= S load as zero and are
// masked, query rows i >= S compute on zeros and are never stored.  Element
// offsets are 64-bit: B H S D passes 2^31 at S = 32,768 once B H D >=
// 65,536.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using pcc::cp_async16;
using pcc::cp_async4;
using pcc::cp_async_commit;
using pcc::cp_async_wait;

constexpr int THREADS = 128;               // four warps
constexpr int LANES = 16;                  // threads of one row group
constexpr int GROUPS = THREADS / LANES;    // row groups (8)
constexpr int BKV = 64;                    // keys per block
constexpr int SC = BKV / LANES;            // keys per thread (4)
constexpr int STAGES = 4;                  // slots of the chunk ring
constexpr int RING_FLOATS = 2048;          // a V chunk's floats, at most
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.44269504088896341f;

// 2^x on the SFU (ex2.approx, relative error ~2^-22; results below 2^-126
// flush to zero, weights too small to move any output).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The blocking at head tile DP (D rounded up to 16, 32, 64, 128 or 256).
template <int DP>
struct Cfg {
  static constexpr int SR = DP >= 256 ? 4 : 8;   // query rows per thread
  static constexpr int BQ = SR * GROUPS;         // query rows per CTA
  static constexpr int OC = DP / LANES;          // output columns per thread
  static constexpr int QSTR = DP + 4;            // Q row stride
  static constexpr int KC = DP < 32 ? DP : 32;   // depth of a K chunk
  static constexpr int KSTR = KC + 4;            // K chunk row stride
  static constexpr int NKC = DP / KC;            // K chunks per block
  static constexpr int VC =                      // keys of a V chunk
      RING_FLOATS / DP < BKV ? RING_FLOATS / DP : BKV;
  static constexpr int NVC = BKV / VC;           // V chunks per block
  static constexpr int NCH = NKC + NVC;          // chunks per block
  static constexpr int PSTR = BQ + 4;            // P^T row (key) stride
  static constexpr int SLOT =
      BKV * KSTR > VC * DP ? BKV * KSTR : VC * DP;
  static constexpr int K4 = BKV * KC / 4 / THREADS;   // float4 a thread
  static constexpr int V4 = VC * DP / 4 / THREADS;    // copies per chunk
  static constexpr int Q4 = BQ * DP / 4 / THREADS;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BQ * QSTR + (size_t)BKV * PSTR +
                       (size_t)STAGES * SLOT);
  static_assert(K4 * 4 * THREADS == BKV * KC &&
                    V4 * 4 * THREADS == VC * DP &&
                    Q4 * 4 * THREADS == BQ * DP && SR % 4 == 0 &&
                    THREADS % (KC / 4) == 0 && THREADS % (DP / 4) == 0,
                "the copy and read maps assume these shapes");
};

// Four floats of a head's (S, D) row-major operand into shared memory at
// dst (16-byte aligned): columns d .. d + 3 of row `row`, zero where the
// row is >= S or a column >= D.  `vec`: D % 4 == 0 and the base is 16-byte
// aligned, so the four are one 16-byte copy (all in or all out).  Copies
// that read nothing still name the head's base, a valid address.
__device__ __forceinline__ void copy4(uint32_t dst, const float* base,
                                      int row, int S, int d, int D,
                                      bool vec) {
  const bool row_in = row < S;
  const float* src = base + (size_t)row * D + d;
  if (vec) {
    const bool in = row_in && d < D;
    cp_async16(dst, in ? src : base, in);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in = row_in && d + e < D;
    cp_async4(dst + 4 * e, in ? src + e : base, in);
  }
}

// Output column of a thread's c-th accumulator: float4 strips 64 apart when
// DP >= 64, else DP / 16 adjacent columns.
template <int DP>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (DP >= 64) return (c / 4) * 64 + tx * 4 + (c % 4);
  return tx * (DP / LANES) + c;
}

// One block's online-softmax update for a thread's SR rows: s holds the
// logits and leaves holding the weights; EDGE blocks (crossing the
// diagonal, the window's edge or S) mask per element.
template <int SR, bool EDGE>
__device__ __forceinline__ void softmax_step(float (&s)[SR][SC],
                                             float (&m)[SR], float (&l)[SR],
                                             float (&alpha)[SR], int qi0,
                                             int kj0, int S, int has_window,
                                             int window) {
  // row i of the thread is qi0 + GROUPS i, key j kj0 + LANES j
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    bool vis[SC];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      vis[j] = true;
      if (EDGE) {
        const int qi = qi0 + GROUPS * i, kj = kj0 + LANES * j;
        vis[j] = kj <= qi && kj < S && (!has_window || qi - kj < window);
      }
      if (vis[j]) mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, LANES));
    const float mn = fmaxf(m[i], mx);
    // exp(s - mn) as 2^(s log2(e) - mn log2(e)): one FFMA and one ex2 a
    // weight; mn log2(e) is rounded once, and alpha uses the same rounded
    // products, so the running max's rounding cancels between blocks
    const float mnl = __fmul_rn(mn, LOG2E);
    alpha[i] = ex2(__fmul_rn(m[i], LOG2E) - mnl);
    m[i] = mn;
    float ps = 0.0f;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const float p = vis[j] ? ex2(fmaf(s[i][j], LOG2E, -mnl)) : 0.0f;
      s[i][j] = p;
      ps += p;
    }
    l[i] = l[i] * alpha[i] + ps;
  }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out, int H,
          int rep, int S, int D, int BH, int nqb, int has_window,
          int window, float scale, int vec) {
  using C = Cfg<DP>;
  constexpr int SR = C::SR;
  constexpr int OC = C::OC;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                         // (BQ, QSTR), scaled
  float* Pt = Qs + C::BQ * C::QSTR;         // (BKV, PSTR), key-major
  float* ring = Pt + BKV * C::PSTR;         // STAGES x SLOT
  const uint32_t s_q = (uint32_t)__cvta_generic_to_shared(Qs);
  const uint32_t s_ring = (uint32_t)__cvta_generic_to_shared(ring);

  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int qb = nqb - 1 - (int)(blockIdx.x / (unsigned)BH);
  const int b = bh / H;
  const int hk = (bh % H) / rep;
  const int q0 = qb * C::BQ;
  const float* kbase = k + ((size_t)b * (H / rep) + hk) * S * (size_t)D;
  const float* vbase = v + ((size_t)b * (H / rep) + hk) * S * (size_t)D;
  const int tid = threadIdx.x;
  const int tx = tid % LANES;
  const int ty = tid / LANES;
  const bool v4 = vec != 0;

  // Q: one group of copies, scaled in place by the thread that copied it.
  const float* qbase = q + (size_t)bh * S * D;
#pragma unroll
  for (int e = 0; e < C::Q4; ++e) {
    const int f = tid + THREADS * e;
    const int row = f / (DP / 4), d = 4 * (f % (DP / 4));
    copy4(s_q + 4 * (row * C::QSTR + d), qbase, q0 + row, S, d, D, v4);
  }
  cp_async_commit();

  int kb0 = 0;
  if (has_window) {
    const long long first = (long long)q0 - window + 1;
    if (first > 0) kb0 = (int)(first / BKV);
  }
  const int q_last = min(q0 + C::BQ, S) - 1;
  const int nchunks = (q_last / BKV - kb0 + 1) * C::NCH;

  // Chunk c of the stream: block kb0 + c / NCH; within it, K depth chunks
  // first, then V key chunks.  This thread copies rows kr + KR e of a K
  // chunk at columns kc .. kc + 3 and rows vr + VR e of a V chunk at
  // columns vc .. vc + 3.  A chunk whose rows all lie below S, of a head
  // whose D is DP and whose copies are 16 bytes, takes them unpredicated.
  constexpr int KG = C::KC / 4, KR = THREADS / KG;
  constexpr int VG = DP / 4, VR = THREADS / VG;
  const int kr = tid / KG, kc = 4 * (tid % KG);
  const int vr = tid / VG, vc = 4 * (tid % VG);
  const bool dense = v4 && D == DP;
  auto load = [&](int c) {
    if (c >= nchunks) return;
    const int k0 = (kb0 + c / C::NCH) * BKV;
    const int r = c % C::NCH;
    const uint32_t slot = s_ring + 4 * (c % STAGES) * C::SLOT;
    if (r < C::NKC) {
      const uint32_t dst = slot + 4 * (kr * C::KSTR + kc);
      const int d = r * C::KC + kc;
      if (dense && k0 + BKV <= S) {
        const float* src = kbase + (size_t)(k0 + kr) * D + d;
#pragma unroll
        for (int e = 0; e < C::K4; ++e)
          cp_async16(dst + 4 * KR * e * C::KSTR, src + (size_t)KR * e * D);
      } else {
#pragma unroll
        for (int e = 0; e < C::K4; ++e)
          copy4(dst + 4 * KR * e * C::KSTR, kbase, k0 + kr + KR * e, S, d,
                D, v4);
      }
    } else {
      const int j0 = k0 + (r - C::NKC) * C::VC;
      const uint32_t dst = slot + 4 * (vr * DP + vc);
      if (dense && j0 + C::VC <= S) {
        const float* src = vbase + (size_t)(j0 + vr) * D + vc;
#pragma unroll
        for (int e = 0; e < C::V4; ++e)
          cp_async16(dst + 4 * VR * e * DP, src + (size_t)VR * e * D);
      } else {
#pragma unroll
        for (int e = 0; e < C::V4; ++e)
          copy4(dst + 4 * VR * e * DP, vbase, j0 + vr + VR * e, S, vc, D,
                v4);
      }
    }
  };

  cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < C::Q4; ++e) {
    const int f = tid + THREADS * e;
    float* x = Qs + (f / (DP / 4)) * C::QSTR + 4 * (f % (DP / 4));
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = __fmul_rn(x[u], scale);
  }
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    load(c);
    cp_async_commit();
  }

  float m[SR], l[SR], acc[SR][OC];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }

  // Chunk c is in shared memory for every thread, and slot (c - 1) %
  // STAGES is free: issue chunk c + STAGES - 1 into it.
  auto next = [&](int c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(c + STAGES - 1);
    cp_async_commit();
    return ring + (c % STAGES) * C::SLOT;
  };

  const float* qrow = Qs + ty * C::QSTR;
  int c = 0;
  for (int k0 = kb0 * BKV; c < nchunks; k0 += BKV) {
    // s = Q K^T over the block's K depth chunks
    float s[SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.0f;
#pragma unroll 1
    for (int r = 0; r < C::NKC; ++r, ++c) {
      const float* ks = next(c) + tx * C::KSTR;
      const float* qs = qrow + r * C::KC;
#pragma unroll
      for (int dd = 0; dd < C::KC; dd += 4) {
        float4 kk[SC];
#pragma unroll
        for (int j = 0; j < SC; ++j)
          kk[j] = *reinterpret_cast<const float4*>(
              ks + LANES * j * C::KSTR + dd);
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          const float4 qq =
              *reinterpret_cast<const float4*>(qs + GROUPS * i * C::QSTR +
                                               dd);
#pragma unroll
          for (int j = 0; j < SC; ++j) {
            float a = s[i][j];
            a = fmaf(qq.x, kk[j].x, a);
            a = fmaf(qq.y, kk[j].y, a);
            a = fmaf(qq.z, kk[j].z, a);
            a = fmaf(qq.w, kk[j].w, a);
            s[i][j] = a;
          }
        }
      }
    }

    // softmax, the accumulators' correction, P^T into its buffer
    const bool edge = k0 + BKV - 1 > q0 || k0 + BKV > S ||
                      (has_window && q0 + C::BQ - 1 - k0 >= window);
    float alpha[SR];
    if (edge)
      softmax_step<SR, true>(s, m, l, alpha, q0 + ty, k0 + tx, S,
                             has_window, window);
    else
      softmax_step<SR, false>(s, m, l, alpha, q0 + ty, k0 + tx, S,
                              has_window, window);
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int cc = 0; cc < OC; ++cc) acc[i][cc] *= alpha[i];
#pragma unroll
    for (int j = 0; j < SC; ++j)
#pragma unroll
      for (int i = 0; i < SR; i += 4)
        *reinterpret_cast<float4*>(Pt + (tx + LANES * j) * C::PSTR +
                                   ty * SR + i) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);

    // acc += P V over the block's V key chunks, keys in order
#pragma unroll 1
    for (int r = 0; r < C::NVC; ++r, ++c) {
      const float* vs = next(c);
      const float* ps = Pt + r * C::VC * C::PSTR + ty * SR;
#pragma unroll
      for (int jj = 0; jj < C::VC; ++jj) {
        float p[SR];
#pragma unroll
        for (int i = 0; i < SR; i += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(ps + jj * C::PSTR + i);
          p[i] = x.x;
          p[i + 1] = x.y;
          p[i + 2] = x.z;
          p[i + 3] = x.w;
        }
        float vv[OC];
        const float* vrow = vs + jj * DP;
        if constexpr (DP >= 64) {
#pragma unroll
          for (int g = 0; g < OC / 4; ++g) {
            const float4 x =
                *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
            vv[4 * g] = x.x;
            vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z;
            vv[4 * g + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int cc = 0; cc < OC; ++cc) vv[cc] = vrow[tx * OC + cc];
        }
#pragma unroll
        for (int i = 0; i < SR; ++i)
#pragma unroll
          for (int cc = 0; cc < OC; ++cc)
            acc[i][cc] = fmaf(p[i], vv[cc], acc[i][cc]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < SR; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = LANES / 2; off > 0; off /= 2)
      lt += __shfl_xor_sync(0xffffffffu, lt, off, LANES);
    const int qi = q0 + ty + GROUPS * i;
    if (qi >= S) continue;
    const float den = fmaxf(lt, 1e-30f);
    float* orow = out + ((size_t)bh * S + qi) * D;
#pragma unroll
    for (int cc = 0; cc < OC; ++cc) {
      const int col = out_col<DP>(tx, cc);
      if (col < D) orow[col] = acc[i][cc] / den;
    }
  }
}

template <int DP>
int enqueue(const float* q, const float* k, const float* v, float* out,
            int B, int H, int rep, int S, int D, int has_window, int window,
            float scale, cudaStream_t stream) {
  using C = Cfg<DP>;
  const long long bh = (long long)B * H;
  const long long nqb = (S + C::BQ - 1) / C::BQ;
  if (bh > 0x7fffffffLL || nqb * bh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int vec =
      D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const unsigned ctas = (unsigned)(nqb * bh);
  flash_fwd<DP><<<ctas, THREADS, C::SMEM, stream>>>(
      q, k, v, out, H, rep, S, D, (int)bh, (int)nqb, has_window, window,
      scale, vec);
  return (int)cudaGetLastError();
}

int launch(const float* q, const float* k, const float* v, float* out,
           int B, int H, int Hkv, int S, int D, int has_window, int window,
           float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || D <= 0 ||
      D > 256)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rep = H / Hkv;
  if (D <= 16)
    return enqueue<16>(q, k, v, out, B, H, rep, S, D, has_window, window,
                       scale, s);
  if (D <= 32)
    return enqueue<32>(q, k, v, out, B, H, rep, S, D, has_window, window,
                       scale, s);
  if (D <= 64)
    return enqueue<64>(q, k, v, out, B, H, rep, S, D, has_window, window,
                       scale, s);
  if (D <= 128)
    return enqueue<128>(q, k, v, out, B, H, rep, S, D, has_window, window,
                        scale, s);
  return enqueue<256>(q, k, v, out, B, H, rep, S, D, has_window, window,
                      scale, s);
}

}  // namespace

// q, out (B, H, S, D); k, v (B, Hkv, S, D); all row-major, contiguous,
// float32.  has_window == 0 runs plain causal attention; scale is the
// float32 query scale (1 / sqrt(D)).  Returns the launch's cudaError_t.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* out, int B, int H,
                                   int Hkv, int S, int D, int has_window,
                                   int window, float scale, void* stream) {
  return launch(q, k, v, out, B, H, Hkv, S, D, has_window, window, scale,
                stream);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
