// Per-row top-k of all-pairs correlation tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pcc_tile.py::pcc_topk_tiles
// (bodies _topk_kernel and _topk_select) with float32, bfloat16 or int8
// operands (select entry points pcc_topk_select_f32 / _bf16 / _i8; the
// accumulation _topk_kernel shares with _kernel, pcc_tile.py:550-559),
// triangle and rectangular grid.  A launch covers the tiles jt = min(j_start + i,
// total - 1), i < pass_tiles, of which only slots with j_start + i < dev_hi
// count.  Each finished (t, t) tile is folded into per-row top-kk state
// under the canonical order (|v| descending, then column ascending) without
// ever being written to device memory.  Outputs, each (m, t, kk):
//   row_vals/row_cols  row block y's rows ranked over this pass's tiles
//                      (y, x), columns x*t + j;
//   col_vals/col_cols  (triangle only) block x's rows ranked over the
//                      transposes of the off-diagonal tiles (y, x), y != x,
//                      columns y*t + i.
// Masked candidates (columns >= n_cols_valid, self-pairs when symmetric) and
// empty slots hold value 0 and column -1, as in the reference.
//
// The TPU kernel revisits state blocks across sequential grid steps; its
// mirrored column state is not visited in monotonic order.  CTAs on Hopper
// run in no order, so no state block is ever read-modified-written by two
// CTAs.  Two kernels instead:
//   1. pcc_topk_select: the tile accumulation of pcc_tiles, so the values
//      are bitwise pcc_tiles': for float32 and int8 the SIMT fmaf / dp4a
//      chain of pcc_accum.cuh on a 64 x 64 block; for bf16 the tensor-core
//      mainloop of pcc_tile_sm90.cu (pcc_mma.cuh, the same stages and
//      wgmma steps) on a 128 x 128 block, cut into four 64 x 64 blocks.
//      The CTA's finished block goes to shared memory and each row of a
//      64 x 64 block (and, off the diagonal, each of its columns) selects
//      its top-min(kk, 64) by exact rank counting.  The partial lists go to
//      a pass scratch of (pass_tiles, t, ceil(t/64), min(kk, 64)) entries
//      per side: 160 KB per 256 x 256 tile at kk = 10, against the 256 KB
//      tile.
//   2. pcc_topk_merge: one warp per output row merges the partial lists of
//      the pass's tiles of its row block, found in closed form from the
//      pass's tile-id range (no host index), 32 candidates at a time:
//      candidates that cannot enter the held top-kk are dropped, the rest
//      are bitonic-sorted in registers and merged by rank into the state
//      held in shared memory.
// The canonical order is total over a row's unique columns, so any merge
// order gives the reference's set and order.
//
// What bounds it: the same work as pcc_tiles (2 l t^2 per tile; in float32
// 1.61e12 FLOP, >= 24 ms at 67 TFLOP/s, for the Table II pass; bf16, >= 1.6
// ms at 989 TFLOP/s, on the tensor cores; int8 is bound by the int8
// tensor-core peak, which the SIMT dp4a chain does not use).  The merge
// kernel reads float32 values whatever the operands.  The selection adds
// O(64) comparisons per candidate in the CTA (about 2 x 64^3 per 64 x 64
// block against 2 x 64^2 x l_pad FLOP) and the merge reads the scratch
// once (~0.4 GB at Table II, ~0.12 ms at 3.35 TB/s).

#include <stdio.h>

#include "pcc_accum.cuh"
#include "pcc_mma.cuh"

namespace {

using namespace pcc;

constexpr int KC_MAX = BM;        // partial list length per CTA row/column
constexpr int KK_MAX = 256;       // state capacity cap (the wrapper checks)
constexpr int MERGE_WARPS = 8;    // output rows per merge CTA
// error codes beside cudaError_t: a tensor map cuTensorMapEncodeTiled refused
constexpr int ERR_MAP = -1000;

// The selection of one finished 64 x 64 block val (row stride LD) at
// (r_in, c_in) of tile (yt, xt) in pass slot `slot`, by 256 threads (tid)
// with the barrier sync() over them: each row's top-kc, and off the
// diagonal of a triangle each column's, into the pass scratch.  key is a
// 64 x 65 scratch of shared memory; the block's values must be complete
// when the threads arrive (the first sync orders them).
template <int LD, typename Sync>
__device__ __forceinline__ void select_block(
    const float* val, float (&key)[BM][BM + 1], int tid, Sync sync,
    long long slot, int yt, int xt, int r_in, int c_in, int t, int nb,
    int kc, int n_cols_valid, int symmetric, int grid_cols,
    float* __restrict__ prv, int* __restrict__ prc, float* __restrict__ pcv,
    int* __restrict__ pcc_) {
  // Thread -> one line (row or column) of the block and 16 of its 64
  // candidates.  A candidate's rank is the number of candidates of its line
  // that precede it under (key desc, index asc); inside a block the global
  // column grows with the index and masked keys (-1) sort last, so this is
  // the canonical order, and ranks are unique.
  const int line = tid >> 2;
  const int q0 = (tid & 3) * (BM / 4);
  const size_t per = (size_t)nb * kc;
  const int rb = r_in / BM, cb = c_in / BM;

  // rows: line = row of the block, candidates = its columns
  sync();
  const long long grow = (long long)yt * t + r_in + line;
  const long long gcol0 = (long long)xt * t + c_in;
  for (int q = q0; q < q0 + BM / 4; ++q) {
    const long long gc = gcol0 + q;
    const bool ok = c_in + q < t && gc < n_cols_valid &&
                    !(symmetric && gc == grow);
    key[line][q] = ok ? fabsf(val[line * LD + q]) : -1.f;
  }
  sync();
  if (r_in + line < t) {
    const size_t base = ((size_t)slot * t + r_in + line) * per +
                        (size_t)cb * kc;
    for (int q = q0; q < q0 + BM / 4; ++q) {
      const float kq = key[line][q];
      int rank = 0;
      for (int o = 0; o < BM; ++o) {
        const float ko = key[line][o];
        rank += (ko > kq) || (ko == kq && o < q);
      }
      if (rank < kc) {
        prv[base + rank] = kq >= 0.f ? val[line * LD + q] : 0.f;
        prc[base + rank] = kq >= 0.f ? (int)(gcol0 + q) : -1;
      }
    }
  }
  if (grid_cols > 0 || yt == xt) return;   // uniform: no mirrored state
  sync();

  // columns (off-diagonal triangle tiles): line = column of the block,
  // candidates = its rows, global column y*t + row
  const long long grow0 = (long long)yt * t + r_in;
  for (int q = q0; q < q0 + BM / 4; ++q) {
    const bool ok = r_in + q < t && grow0 + q < n_cols_valid;
    key[line][q] = ok ? fabsf(val[q * LD + line]) : -1.f;
  }
  sync();
  if (c_in + line < t) {
    const size_t base = ((size_t)slot * t + c_in + line) * per +
                        (size_t)rb * kc;
    for (int q = q0; q < q0 + BM / 4; ++q) {
      const float kq = key[line][q];
      int rank = 0;
      for (int o = 0; o < BM; ++o) {
        const float ko = key[line][o];
        rank += (ko > kq) || (ko == kq && o < q);
      }
      if (rank < kc) {
        pcv[base + rank] = kq >= 0.f ? val[q * LD + line] : 0.f;
        pcc_[base + rank] = kq >= 0.f ? (int)(grow0 + q) : -1;
      }
    }
  }
}

// Select (float32, int8): one CTA per 64 x 64 block of each valid tile.
template <typename T>
__global__ void __launch_bounds__(THREADS)
pcc_topk_select_kernel(const T* __restrict__ u,
                       const T* __restrict__ v, float* __restrict__ prv,
                       int* __restrict__ prc, float* __restrict__ pcv,
                       int* __restrict__ pcc_, long long j_start,
                       long long dev_hi, int m, int grid_cols, int t,
                       int l_pad, int nb, int kc, int n_cols_valid,
                       int symmetric, int has_div, float recip, int has_clip,
                       float lo, float hi) {
  __shared__ __align__(16) Stage st;
  __shared__ float val[BM][BM + 1];   // the finished block
  __shared__ float key[BM][BM + 1];   // |v| of a candidate, -1 if masked

  const long long jt_raw = j_start + (long long)blockIdx.x;
  if (jt_raw >= dev_hi) return;       // uniform over the CTA
  const long long total = tile_total(m, grid_cols);
  const long long jt = jt_raw < total ? jt_raw : total - 1;
  int yt, xt;
  tile_coord(m, grid_cols, jt, &yt, &xt);

  // rb and cb as names: with (blockIdx.y / nb) * BM written inline, nvcc
  // gave the int8 instantiation 128 registers, not 72 (two CTAs an SM
  // instead of three, ~10 % slower)
  const int rb = blockIdx.y / nb, cb = blockIdx.y % nb;
  const int r_in = rb * BM, c_in = cb * BM;
  float acc[TM][TM];
  accumulate_block(u + ((size_t)yt * t + r_in) * l_pad,
                   v + ((size_t)xt * t + c_in) * l_pad, t - r_in, t - c_in,
                   l_pad, st, acc);

  const int tid = threadIdx.x;
  {
    const int tx = tid % (BM / TM), ty = tid / (BM / TM);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        val[ty * TM + i][tx * TM + j] =
            epilogue(acc[i][j], has_div, recip, has_clip, lo, hi);
  }
  select_block<BM + 1>(&val[0][0], key, tid, [] { __syncthreads(); },
                       blockIdx.x, yt, xt, r_in, c_in, t, nb, kc,
                       n_cols_valid, symmetric, grid_cols, prv, prc, pcv,
                       pcc_);
}

// Select (bf16): one CTA per 128 x 128 block of each valid tile, computed
// by the tensor-core mainloop of pcc_tiles (pcc_mma.cuh, the same stages
// and steps, so the values are bitwise pcc_tiles'), then selected as the
// four 64 x 64 blocks of the SIMT kernel, into the same scratch.  The ring
// is reused for the finished block once both warpgroups are done with it.
constexpr int SEL_STAGES = 4;
constexpr int SEL_LD = mma::BLOCK + 1;
constexpr int SEL_SMEM = SEL_STAGES * mma::STAGE_BYTES + 1024;
static_assert(mma::BLOCK * SEL_LD * 4 + BM * (BM + 1) * 4 <=
                  SEL_STAGES * mma::STAGE_BYTES,
              "the finished block and the keys fit in the ring");

template <typename T>
__global__ void __launch_bounds__(mma::THREADS, 1)
pcc_topk_select_sm90(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     float* __restrict__ prv, int* __restrict__ prc,
                     float* __restrict__ pcv, int* __restrict__ pcc_,
                     long long j_start, long long dev_hi, int m,
                     int grid_cols, int t, int nk, int nb, int nb_mma,
                     int kc, int n_cols_valid, int symmetric, int has_div,
                     float recip, int has_clip, float lo, float hi) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * SEL_STAGES];
  const sm90::Ring<SEL_STAGES> ring{bars, bars + SEL_STAGES};
  uint8_t* slots = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const long long jt_raw = j_start + (long long)blockIdx.x;
  if (jt_raw >= dev_hi) return;       // uniform over the CTA
  const long long total = tile_total(m, grid_cols);
  const long long jt = jt_raw < total ? jt_raw : total - 1;
  int yt, xt;
  tile_coord(m, grid_cols, jt, &yt, &xt);
  const int r_blk = (blockIdx.y / nb_mma) * mma::BLOCK;
  const int c_blk = (blockIdx.y % nb_mma) * mma::BLOCK;

  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < SEL_STAGES; ++s) {
      sm90::mbar_init(&ring.full[s], 1);
      sm90::mbar_init(&ring.empty[s], mma::CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (warp >= mma::CONSUMERS / 32) {
    if (threadIdx.x == mma::CONSUMERS) {
      int it = 0;
      mma::load_block<T, SEL_STAGES>(&ta, &tb, ring, slots, it, nk,
                                     yt * t + r_blk, xt * t + c_blk, 0);
    }
    return;
  }

  const int tid = threadIdx.x;
  const int wg = warp / 4;
  const int lane = tid % 128;
  float acc[mma::ACC];
  int it = 0;
  mma::mma_block<T, SEL_STAGES>(acc, ring, sm90::smem_u32(slots), it, nk, wg);
  auto sync = [] { sm90::bar_sync(1, mma::CONSUMERS); };
  sync();   // both warpgroups' products have read the ring

  float* val = reinterpret_cast<float*>(slots);
  auto& key = *reinterpret_cast<float(*)[BM][BM + 1]>(
      val + mma::BLOCK * SEL_LD);
  const int row0 = 64 * wg + 16 * (lane / 32) + (lane % 32) / 4;
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < mma::BLOCK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      val[(row0 + 8 * (e >> 1)) * SEL_LD + 8 * j + col0 + (e & 1)] =
          epilogue(acc[4 * j + e], has_div, recip, has_clip, lo, hi);
  for (int sb = 0; sb < 4; ++sb) {
    const int r_off = BM * (sb >> 1), c_off = BM * (sb & 1);
    if (r_blk + r_off >= t || c_blk + c_off >= t) continue;   // uniform
    select_block<SEL_LD>(val + r_off * SEL_LD + c_off, key, tid, sync,
                         blockIdx.x, yt, xt, r_blk + r_off, c_blk + c_off,
                         t, nb, kc, n_cols_valid, symmetric, grid_cols, prv,
                         prc, pcv, pcc_);
  }
}

// id of the triangle tile (y, Y)
__device__ __forceinline__ long long mirror_id(long long m, long long Y,
                                               long long y) {
  return tri_before(m, y) + Y - y;
}

// a precedes b in the canonical order (both valid)
__device__ __forceinline__ bool precedes(float va, int ca, float vb, int cb) {
  const float ka = fabsf(va), kb = fabsf(vb);
  return ka > kb || (ka == kb && ca < cb);
}

// first i in [0, n) whose entry does not precede (v, c)
__device__ __forceinline__ int count_preceding(const float* sv, const int* sc,
                                               int n, float v, int c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (precedes(sv[mid], sc[mid], v, c)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Merge: one warp per output row r of row block blockIdx.x; blockIdx.z
// selects the row state (0) or the mirrored column state (1).
__global__ void __launch_bounds__(MERGE_WARPS * 32)
pcc_topk_merge_kernel(const float* __restrict__ prv,
                      const int* __restrict__ prc,
                      const float* __restrict__ pcv,
                      const int* __restrict__ pcc_, float* __restrict__ rv,
                      int* __restrict__ rc, float* __restrict__ cv,
                      int* __restrict__ cc, long long j_start,
                      long long hi_eff, int m, int grid_cols, int t, int nb,
                      int kc, int kk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.y * MERGE_WARPS + warp;
  if (r >= t) return;                 // whole warp; no block barrier below
  const int Y = blockIdx.x;
  const bool mirror = blockIdx.z == 1;

  float* sv = reinterpret_cast<float*>(smem) + (size_t)warp * (4 * kk + 64);
  int* sc = reinterpret_cast<int*>(sv + kk);
  float* nv = sv + 2 * kk;
  int* nc = reinterpret_cast<int*>(sv + 3 * kk);
  float* chv = sv + 4 * kk;
  int* chc = reinterpret_cast<int*>(sv + 4 * kk + 32);

  // This pass's tiles feeding row block Y, as slot = first + step(s).
  const long long mm = m;
  long long n_src = 0, y_lo = 0, slot0 = 0;
  if (!mirror) {
    const long long id_lo = grid_cols > 0 ? (long long)Y * grid_cols
                                          : tri_before(mm, Y);
    const long long id_hi = grid_cols > 0 ? id_lo + grid_cols
                                          : id_lo + (mm - Y);
    const long long lo = id_lo > j_start ? id_lo : j_start;
    const long long hi = id_hi < hi_eff ? id_hi : hi_eff;
    n_src = hi > lo ? hi - lo : 0;
    slot0 = lo - j_start;
  } else {
    // tiles (y, Y), y < Y: mirror_id grows with y
    auto first_at_least = [&](long long bound) {
      long long a = 0, b = Y;
      while (a < b) {
        const long long mid = (a + b) >> 1;
        if (mirror_id(mm, Y, mid) < bound) a = mid + 1; else b = mid;
      }
      return a;
    };
    y_lo = first_at_least(j_start);
    n_src = first_at_least(hi_eff) - y_lo;
  }
  const float* pv = mirror ? pcv : prv;
  const int* pc = mirror ? pcc_ : prc;
  const long long per = (long long)nb * kc;
  const long long n_cand = n_src * per;

  int held = 0;
  for (long long base = 0; base < n_cand; base += 32) {
    const long long q = base + lane;
    float cv_ = 0.f;
    int cc_ = -1;
    if (q < n_cand) {
      const long long s = q / per, e = q % per;
      const long long slot =
          mirror ? mirror_id(mm, Y, y_lo + s) - j_start : slot0 + s;
      const size_t idx = ((size_t)slot * t + r) * per + e;
      cv_ = pv[idx];
      cc_ = pc[idx];
    }
    bool ok = cc_ >= 0;
    if (ok && held == kk) ok = precedes(cv_, cc_, sv[kk - 1], sc[kk - 1]);
    const unsigned ballot = __ballot_sync(0xffffffffu, ok);
    if (ballot == 0) continue;
    // bitonic sort of the 32 lanes: valid first, then canonical order
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        const float pv_ = __shfl_xor_sync(0xffffffffu, cv_, stride);
        const int pc_ = __shfl_xor_sync(0xffffffffu, cc_, stride);
        const bool pok = __shfl_xor_sync(0xffffffffu, (int)ok, stride);
        const bool first = ((lane & stride) == 0) == ((lane & size) == 0);
        const bool partner_first = pok && (!ok || precedes(pv_, pc_, cv_, cc_));
        const bool mine_first = ok && (!pok || precedes(cv_, cc_, pv_, pc_));
        if (first ? partner_first : mine_first) {
          cv_ = pv_;
          cc_ = pc_;
          ok = pok;
        }
      }
    }
    const int n_new = __popc(ballot);
    chv[lane] = cv_;
    chc[lane] = cc_;
    __syncwarp();
    if (lane < n_new) {
      const int pos = lane + count_preceding(sv, sc, held, cv_, cc_);
      if (pos < kk) {
        nv[pos] = cv_;
        nc[pos] = cc_;
      }
    }
    for (int i = lane; i < held; i += 32) {
      const int pos = i + count_preceding(chv, chc, n_new, sv[i], sc[i]);
      if (pos < kk) {
        nv[pos] = sv[i];
        nc[pos] = sc[i];
      }
    }
    __syncwarp();
    held = held + n_new < kk ? held + n_new : kk;
    for (int i = lane; i < held; i += 32) {
      sv[i] = nv[i];
      sc[i] = nc[i];
    }
    __syncwarp();
  }

  float* ov = (mirror ? cv : rv) + ((size_t)Y * t + r) * kk;
  int* oc = (mirror ? cc : rc) + ((size_t)Y * t + r) * kk;
  for (int i = lane; i < kk; i += 32) {
    ov[i] = i < held ? sv[i] : 0.f;
    oc[i] = i < held ? sc[i] : -1;
  }
}

template <typename T>
int launch_select(const T* u, const T* v, float* prv, int* prc, float* pcv,
                  int* pcc_, long long j_start, long long dev_hi,
                  int pass_tiles, int m, int grid_cols, int t, int l_pad,
                  int kk, int n_cols_valid, int symmetric, int has_div,
                  float recip, int has_clip, float lo, float hi,
                  void* stream) {
  if (pass_tiles <= 0 || m <= 0 || grid_cols < 0 || t <= 0 || l_pad <= 0 ||
      j_start < 0 || kk <= 0 || kk > KK_MAX)
    return (int)cudaErrorInvalidValue;
  const int nb = (t + BM - 1) / BM;
  if ((long long)nb * nb > 65535) return (int)cudaErrorInvalidValue;
  const int kc = kk < KC_MAX ? kk : KC_MAX;
  const dim3 grid((unsigned)pass_tiles, (unsigned)(nb * nb));
  pcc_topk_select_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      u, v, prv, prc, pcv, pcc_, j_start, dev_hi, m, grid_cols, t, l_pad, nb,
      kc, n_cols_valid, symmetric, has_div, recip, has_clip, lo, hi);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core select.  Its operands meet TMA's alignment (l_pad
// a multiple of 8, 16-byte bases; the wrapper pads otherwise).
int launch_select_sm90(const __nv_bfloat16* u, const __nv_bfloat16* v,
                       float* prv, int* prc, float* pcv, int* pcc_,
                       long long j_start, long long dev_hi, int pass_tiles,
                       int m, int grid_cols, int t, int l_pad, int kk,
                       int n_cols_valid, int symmetric, int has_div,
                       float recip, int has_clip, float lo, float hi,
                       void* stream) {
  using T = __nv_bfloat16;
  if (pass_tiles <= 0 || m <= 0 || grid_cols < 0 || t <= 0 || l_pad <= 0 ||
      j_start < 0 || kk <= 0 || kk > KK_MAX)
    return (int)cudaErrorInvalidValue;
  const long long u_rows = (long long)m * t;
  const long long v_rows = grid_cols > 0 ? (long long)grid_cols * t : u_rows;
  if ((l_pad * (int)sizeof(T)) % 16 || u_rows > INT32_MAX ||
      v_rows > INT32_MAX ||
      ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(v)) %
       16))
    return (int)cudaErrorMisalignedAddress;
  const int nb = (t + BM - 1) / BM;
  const int nb_mma = (t + mma::BLOCK - 1) / mma::BLOCK;
  if ((long long)nb_mma * nb_mma > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  CUresult r = sm90::encode_3d(&ta, sm90::MapType<T>::value, sizeof(T), u,
                               l_pad, u_rows, 1, u_rows * l_pad, mma::BLOCK);
  if (r == CUDA_SUCCESS)
    r = sm90::encode_3d(&tb, sm90::MapType<T>::value, sizeof(T), v, l_pad,
                        v_rows, 1, v_rows * l_pad, mma::BLOCK);
  if (r != CUDA_SUCCESS) return ERR_MAP - (int)r;
  const cudaError_t e = cudaFuncSetAttribute(
      pcc_topk_select_sm90<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SEL_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int kc = kk < KC_MAX ? kk : KC_MAX;
  const dim3 grid((unsigned)pass_tiles, (unsigned)(nb_mma * nb_mma));
  pcc_topk_select_sm90<T><<<grid, mma::THREADS, SEL_SMEM,
                            (cudaStream_t)stream>>>(
      ta, tb, prv, prc, pcv, pcc_, j_start, dev_hi, m, grid_cols, t,
      mma::stages<T>(l_pad), nb, nb_mma, kc, n_cols_valid, symmetric,
      has_div, recip, has_clip, lo, hi);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 1, one entry point per operand type.  pcv/pcc are unused (may be
// null) on the grid.
#define PCC_TOPK_SELECT_ENTRY(NAME, T, LAUNCH)                                \
  extern "C" int NAME(const T* u, const T* v, float* prv, int* prc,          \
                      float* pcv, int* pcc_, long long j_start,               \
                      long long dev_hi, int pass_tiles, int m, int grid_cols, \
                      int t, int l_pad, int kk, int n_cols_valid,             \
                      int symmetric, int has_div, float recip, int has_clip,  \
                      float lo, float hi, void* stream) {                     \
    return LAUNCH(u, v, prv, prc, pcv, pcc_, j_start, dev_hi, pass_tiles, m,  \
                  grid_cols, t, l_pad, kk, n_cols_valid, symmetric, has_div,  \
                  recip, has_clip, lo, hi, stream);                           \
  }

PCC_TOPK_SELECT_ENTRY(pcc_topk_select_f32, float, launch_select<float>)
PCC_TOPK_SELECT_ENTRY(pcc_topk_select_bf16, __nv_bfloat16, launch_select_sm90)
PCC_TOPK_SELECT_ENTRY(pcc_topk_select_i8, int8_t, launch_select<int8_t>)

// Kernel 2.  hi_eff = min(j_start + pass_tiles, dev_hi); cv/cc (and
// pcv/pcc) are unused on the grid.
extern "C" int pcc_topk_merge(const float* prv, const int* prc,
                              const float* pcv, const int* pcc_, float* rv,
                              int* rc, float* cv, int* cc, long long j_start,
                              long long hi_eff, int m, int grid_cols, int t,
                              int kk, void* stream) {
  if (m <= 0 || grid_cols < 0 || t <= 0 || kk <= 0 || kk > KK_MAX ||
      j_start < 0)
    return (int)cudaErrorInvalidValue;
  const int nb = (t + BM - 1) / BM;
  const int kc = kk < KC_MAX ? kk : KC_MAX;
  const dim3 grid((unsigned)m, (unsigned)((t + MERGE_WARPS - 1) / MERGE_WARPS),
                  grid_cols > 0 ? 1u : 2u);
  const size_t smem = (size_t)MERGE_WARPS * (4 * kk + 64) * sizeof(float);
  pcc_topk_merge_kernel<<<grid, MERGE_WARPS * 32, smem,
                          (cudaStream_t)stream>>>(
      prv, prc, pcv, pcc_, rv, rc, cv, cc, j_start, hi_eff, m, grid_cols, t,
      nb, kc, kk);
  return (int)cudaGetLastError();
}

extern "C" const char* pcc_topk_error_string(int err) {
  static thread_local char buf[96];
  if (err <= ERR_MAP) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             ERR_MAP - err);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)err);
}
