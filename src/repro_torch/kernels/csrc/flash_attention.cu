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
// Design.  The TPU kernel walks a 1-D grid of (query block, key block) jobs
// in row-major lower-triangle (or band) order and carries the online-softmax
// state (m, l, acc) in VMEM from one sequential grid step to the next.  CUDA
// blocks run in parallel and in no order, so here one CTA owns one
// (b, h, 64-row query block) and loops over its own key blocks, from the
// band's first (the block that holds key q0 - window + 1, else block 0) to
// the diagonal block; nothing carries over between CTAs.  CTAs are numbered
// so that the longest query rows (the last blocks of the triangle) start
// first, across every head.
//
// Per step of 64 keys, 256 threads as 16 x 16: thread (ty, tx) holds the
// logits of rows 4 ty .. 4 ty + 3 against keys tx, tx + 16, tx + 32, tx + 48,
// and the output of the same four rows in D / 16 columns.  The 16 threads of
// a row are one half warp, so row maxima and sums are shuffles.  Q (scaled),
// the K block and the V block sit in shared memory with a row stride of
// D + 4 floats, so the float4 reads of four keys at one depth hit distinct
// banks; the probabilities pass through shared memory, over the K block,
// which is dead by then, for the P V product.
//
// Numerics:
//  * q is multiplied by the float32 scale 1 / sqrt(D) before the dot, as in
//    _attn_kernel (:71);
//  * each logit is one fmaf chain over d = 0 .. D - 1, IEEE float32 (no
//    TF32);
//  * the running max starts at the reference's finite NEG_INF = -1e30 and a
//    masked entry's weight is exactly 0, so a row whose keys in one step are
//    all masked (the far block of a band) keeps l = 0 and acc = 0, and no
//    inf - inf arises;
//  * exp is expf (not __expf), the final acc / max(l, 1e-30) an IEEE
//    division.
// S need not be a multiple of 64: keys j >= S load as zero and are masked,
// query rows i >= S compute on zeros and are never stored.  Offsets are
// 64-bit: B H S D passes 2^31 at S = 32,768 once B H D >= 65,536.
//
// What bounds it: 4 D FLOP per visible (query, key) pair (two dot products
// of length D), on the SIMT FP32 pipes (67 TFLOP/s on an H100 SXM at 700 W):
// IEEE float32 has no tensor-core path (TF32 keeps 10 mantissa bits).
// Llama-3.2-3B's heads (H 24, Hkv 8, D 128) at S = 4,096, causal, are
// 1.03e11 FLOP, >= 1.54 ms, against 134 MB of q, k, v and out (0.04 ms at
// 3.35 TB/s): bound by operations.  Left for later: TMA or cp.async
// staging of the K and V blocks through an mbarrier ring so that loads
// overlap the math (here a step's loads wait behind a barrier), and exp2
// with log2(e) folded into the scale.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BKV = 64;         // keys per step
constexpr int LANES = 16;       // threads of one row group (a half warp)
constexpr int THREADS = LANES * LANES;   // 256
constexpr int TR = BQ / LANES;  // rows per thread (4)
constexpr int TK = BKV / LANES; // keys per thread (4)
constexpr int PSTR = BKV + 4;   // row stride of the probabilities
constexpr float NEG_INF = -1e30f;

// Shared memory of a CTA at head tile DP, in floats: the Q stage, the K
// stage (reused for the probabilities), the V stage.
template <int DP>
__host__ __device__ constexpr int kp_floats() {
  return BKV * (DP + 4) > BQ * PSTR ? BKV * (DP + 4) : BQ * PSTR;
}
template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (DP + 4) + kp_floats<DP>() +
                          (size_t)BKV * (DP + 4));
}

// Stage 64 rows of a (., D) row-major operand as float32 into dst (row
// stride DP + 4); rows >= rows_valid and columns >= D are zero.  SCALE
// multiplies each value by `mul` (the query scale).
template <typename T, int DP, bool SCALE>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int rows_valid, int D, float mul) {
  for (int idx = threadIdx.x; idx < 64 * DP; idx += THREADS) {
    const int r = idx / DP;
    const int d = idx % DP;
    float x = 0.0f;
    if (r < rows_valid && d < D) x = src[(size_t)r * D + d];
    if (SCALE) x = __fmul_rn(x, mul);
    dst[r * (DP + 4) + d] = x;
  }
}

// Output column of a thread's jd-th accumulator: groups of four adjacent
// columns, 64 apart, when DP >= 64; else DP / 16 adjacent columns.
template <int DP>
__device__ __forceinline__ int out_col(int tx, int jd) {
  if constexpr (DP >= 64) return (jd / 4) * 64 + tx * 4 + (jd % 4);
  return tx * (DP / LANES) + jd;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, DP <= 128 ? 2 : 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ out, int H, int rep,
          int S, int D, int BH, int nqb, int has_window, int window,
          float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int STR = DP + 4;
  constexpr int CPT = DP / LANES;
  float* Qs = smem;
  float* Ks = Qs + BQ * STR;   // the K block, then the step's probabilities
  float* Ps = Ks;
  float* Vs = Ks + kp_floats<DP>();

  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int qb = nqb - 1 - (int)(blockIdx.x / (unsigned)BH);
  const int b = bh / H;
  const int hk = (bh % H) / rep;
  const int q0 = qb * BQ;
  const size_t kv_base = ((size_t)b * (H / rep) + hk) * S * (size_t)D;
  const int tx = threadIdx.x % LANES;
  const int ty = threadIdx.x / LANES;

  stage<T, DP, true>(Qs, q + ((size_t)bh * S + q0) * D, S - q0, D, scale);

  int kb0 = 0;
  if (has_window) {
    const long long first = (long long)q0 - window + 1;
    if (first > 0) kb0 = (int)(first / BKV);
  }

  float m[TR], l[TR], acc[TR][CPT];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
  }

  for (int kb = kb0; kb <= qb; ++kb) {
    const int k0 = kb * BKV;
    __syncthreads();  // the last step's reads of Ps and Vs are done
    stage<T, DP, false>(Ks, k + kv_base + (size_t)k0 * D, S - k0, D, 1.0f);
    stage<T, DP, false>(Vs, v + kv_base + (size_t)k0 * D, S - k0, D, 1.0f);
    __syncthreads();

    float s[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 kk[TK];
#pragma unroll
      for (int j = 0; j < TK; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Ks + (tx + LANES * j) * STR +
                                                 d);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(Qs + (ty * TR + i) * STR + d);
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          float a = s[i][j];
          a = fmaf(qq.x, kk[j].x, a);
          a = fmaf(qq.y, kk[j].y, a);
          a = fmaf(qq.z, kk[j].z, a);
          a = fmaf(qq.w, kk[j].w, a);
          s[i][j] = a;
        }
      }
    }

    // mask, running max, weights
    unsigned vis = 0;
    float mx[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const long long qi = q0 + ty * TR + i;
      mx[i] = NEG_INF;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const long long kj = k0 + tx + LANES * j;
        if (kj <= qi && kj < S && (!has_window || kj > qi - window)) {
          vis |= 1u << (i * TK + j);
          mx[i] = fmaxf(mx[i], s[i][j]);
        }
      }
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off /= 2)
#pragma unroll
      for (int i = 0; i < TR; ++i)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off, LANES));
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float mn = fmaxf(m[i], mx[i]);
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p =
            (vis >> (i * TK + j)) & 1u ? expf(s[i][j] - mn) : 0.0f;
        s[i][j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading the K block
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j)
        Ps[(ty * TR + i) * PSTR + tx + LANES * j] = s[i][j];
    __syncthreads();

    // acc += P V over the step's keys, in key order
#pragma unroll 2
    for (int c = 0; c < BKV; c += 4) {
      float4 pp[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        pp[i] = *reinterpret_cast<const float4*>(Ps + (ty * TR + i) * PSTR +
                                                 c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = Vs + (c + cc) * STR;
        float vv[CPT];
        if constexpr (DP >= 64) {
#pragma unroll
          for (int g = 0; g < CPT / 4; ++g) {
            const float4 x =
                *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
            vv[4 * g] = x.x;
            vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z;
            vv[4 * g + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int jd = 0; jd < CPT; ++jd) vv[jd] = vrow[tx * CPT + jd];
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float p = cc == 0   ? pp[i].x
                          : cc == 1 ? pp[i].y
                          : cc == 2 ? pp[i].z
                                    : pp[i].w;
#pragma unroll
          for (int jd = 0; jd < CPT; ++jd)
            acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = LANES / 2; off > 0; off /= 2)
      lt += __shfl_xor_sync(0xffffffffu, lt, off, LANES);
    const int qi = q0 + ty * TR + i;
    if (qi >= S) continue;
    const float den = fmaxf(lt, 1e-30f);
    T* orow = out + ((size_t)bh * S + qi) * D;
#pragma unroll
    for (int jd = 0; jd < CPT; ++jd) {
      const int col = out_col<DP>(tx, jd);
      if (col < D) orow[col] = acc[i][jd] / den;
    }
  }
}

template <typename T, int DP>
int enqueue(const T* q, const T* k, const T* v, T* out, int H, int rep,
            int S, int D, int BH, int nqb, int has_window, int window,
            float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned ctas = (unsigned)nqb * (unsigned)BH;
  flash_fwd<T, DP><<<ctas, THREADS, smem, stream>>>(q, k, v, out, H, rep, S, D, BH, nqb, has_window, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* out, int B, int H,
           int Hkv, int S, int D, int has_window, int window, float scale,
           void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || D <= 0 ||
      D > 256)
    return (int)cudaErrorInvalidValue;
  const long long bh = (long long)B * H;
  const long long nqb = (S + BQ - 1) / BQ;
  if (bh > 0x7fffffffLL || nqb * bh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rep = H / Hkv;
  if (D <= 16)
    return enqueue<T, 16>(q, k, v, out, H, rep, S, D, (int)bh, (int)nqb,
                          has_window, window, scale, s);
  if (D <= 32)
    return enqueue<T, 32>(q, k, v, out, H, rep, S, D, (int)bh, (int)nqb,
                          has_window, window, scale, s);
  if (D <= 64)
    return enqueue<T, 64>(q, k, v, out, H, rep, S, D, (int)bh, (int)nqb,
                          has_window, window, scale, s);
  if (D <= 128)
    return enqueue<T, 128>(q, k, v, out, H, rep, S, D, (int)bh, (int)nqb,
                           has_window, window, scale, s);
  return enqueue<T, 256>(q, k, v, out, H, rep, S, D, (int)bh, (int)nqb,
                         has_window, window, scale, s);
}

}  // namespace

// q, out (B, H, S, D); k, v (B, Hkv, S, D); all row-major, contiguous,
// float32.  has_window == 0 runs plain causal attention; scale is the
// float32 query scale (1 / sqrt(D)).  Returns the launch's cudaError_t.
#define FLASH_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const T* q, const T* k, const T* v, T* out, int B,     \
                      int H, int Hkv, int S, int D, int has_window,          \
                      int window, float scale, void* stream) {               \
    return launch<T>(q, k, v, out, B, H, Hkv, S, D, has_window, window,      \
                     scale, stream);                                         \
  }

FLASH_ENTRY(flash_attention_f32, float)

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
