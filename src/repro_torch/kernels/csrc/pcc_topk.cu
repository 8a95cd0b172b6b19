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
//      its top-min(kk, 64) (below): by warp extraction while that is at
//      most 32, else by rank counting.  The partial lists go to a pass
//      scratch of (pass_tiles, t, ceil(t/64), min(kk, 64)) entries per
//      side: 160 KB per 256 x 256 tile at kk = 10, against the 256 KB tile.
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
// kernel reads float32 values whatever the operands.  The selection is
// not in the bound, and its cost is what this design keeps down: at kc
// entries a line, extraction is kc rounds, each a warp reduction, a ballot
// and a few selects for the line's 64 candidates, with no branch or memory
// access inside a round (rank counting, kept for kc > 32, takes 64
// comparisons a candidate whatever kc); the bf16 select spreads it over all
// 12 of its warps.  The merge reads the scratch once (~0.4 GB at Table II,
// ~0.12 ms at 3.35 TB/s).

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

// The selection.  A line is a row of a finished 64 x 64 block (its
// candidates the block's columns) or, off the diagonal of a triangle, a
// column (its candidates the rows); each line's top-kc under the canonical
// order (|v| desc, then index asc; masked candidates, columns past t or
// n_cols_valid and self-pairs, last) goes to slots 0 .. kc-1 of its
// partial list in the pass scratch, a masked entry as value 0, column -1.
// Two routes by kc, each exact, so the scratch holds the same entries in
// the same slots either way:
//   * kc <= KC_EXTRACT, extraction (extract_lines): one warp holds a line,
//     lane l the candidates q = 2l and 2l + 1 as keys __float_as_uint(|v|)
//     + 1, 0 when masked.  Non-negative floats order as their bits, and
//     lane l's indices are all below lane l + 1's, so the key order with
//     the lowest lane first among equal keys is the canonical order.  Each
//     lane orders its pair; then each of kc rounds takes the line's next
//     entry: a warp max of the lanes' first keys (__reduce_max_sync), the
//     lowest lane holding it (a ballot), which moves on to its second
//     candidate; lane r keeps round r's entry, and the kc entries are
//     stored side by side at the end.  Work in proportion to kc, no
//     branches and no memory traffic inside the rounds; a warp holds LINES
//     lines and runs each round as sweeps over them, so their reductions
//     issue back to back.
//   * larger kc, rank counting (rank_lines): 4 threads a line, each
//     candidate's slot is the number of candidates of its line that
//     precede it; 64 comparisons a candidate, whatever kc.
// Keys of NaN values sort first on the first route; NaN tiles are outside
// the contract of both.
constexpr int SEL_WARPS = THREADS / 32;      // warps of a 64 x 64 block
constexpr int LINES = BM / SEL_WARPS;        // lines a warp holds, per side
constexpr int KC_EXTRACT = 32;
static_assert(KC_EXTRACT <= 32, "lane r keeps entry r of its lines");
// lines per sweep in the SIMT selects, whose other CTAs on the SM hide
// latency (and whose int8 instantiation stays at 70 registers: 74 with
// sweeps of 8, at the same time); the bf16 select sweeps all LINES
constexpr int SIMT_SWEEP = 4;

// One side of a finished block: line j at line_in + j of the tile,
// candidate q at cand_in + q of the tile and at global column gcand0 + q,
// read at val[j * line_step + q * cand_step]; self-pairs (gcand0 + q ==
// gline0 + j) masked when `self`.  Line j's entries go to
// part_v/part_c[((slot * t + line_in + j) * per + blk * kc + rank].
struct Side {
  const float* val;
  int line_step, cand_step;
  int line_in, cand_in;
  long long gline0, gcand0;
  bool self;
  int blk;
  float* part_v;
  int* part_c;
};

// The rows (candidates: columns x*t + c) and the columns (off-diagonal
// triangle tiles; candidates: rows y*t + r) of the 64 x 64 block val at
// (r_in, c_in) of tile (yt, xt).
template <int LD>
__device__ __forceinline__ Side row_side(const float* val, int yt, int xt,
                                         int r_in, int c_in, int t,
                                         int symmetric, float* prv,
                                         int* prc) {
  return {val, LD, 1, r_in, c_in, (long long)yt * t + r_in,
          (long long)xt * t + c_in, symmetric != 0, c_in / BM, prv, prc};
}
template <int LD>
__device__ __forceinline__ Side col_side(const float* val, int yt, int xt,
                                         int r_in, int c_in, int t,
                                         float* pcv, int* pcc_) {
  return {val, 1, LD, c_in, r_in, (long long)xt * t + c_in,
          (long long)yt * t + r_in, false, r_in / BM, pcv, pcc_};
}

// Extraction: lines g + SEL_WARPS * i, i < LINES, of side `sd`, by one
// warp (lane).  A round's winner is the lowest lane holding the warp's
// largest key, so it is known to the whole warp; lane r keeps the
// candidate of round r and, after the last round, lanes 0 .. kc-1 store
// their entries side by side.
template <int SWEEP>
__device__ __forceinline__ void extract_lines(const Side& sd, int g,
                                              int lane, long long slot,
                                              int t, size_t per, int kc,
                                              int n_cols_valid) {
  static_assert(LINES % SWEEP == 0, "sweeps cover the lines");
  unsigned hi[LINES], lo[LINES];   // keys of the lane's next, then last
  unsigned sec[LINES];   // bit l: lane l's next candidate is 2 l + 1
  int mine[LINES];       // candidate of entry `lane`, -1 if masked
#pragma unroll
  for (int i = 0; i < LINES; ++i) {
    const int line = g + SEL_WARPS * i;
    unsigned key[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int q = 2 * lane + s;
      const long long gc = sd.gcand0 + q;
      const bool ok = sd.cand_in + q < t && gc < n_cols_valid &&
                      !(sd.self && gc == sd.gline0 + line);
      const float v = sd.val[line * sd.line_step + q * sd.cand_step];
      key[s] = ok ? __float_as_uint(fabsf(v)) + 1u : 0u;
    }
    const bool second = key[1] > key[0];
    hi[i] = second ? key[1] : key[0];
    lo[i] = second ? key[0] : key[1];
    sec[i] = __ballot_sync(0xffffffffu, second);
    mine[i] = -1;
  }
  for (int r = 0; r < kc; ++r) {
#pragma unroll
    for (int i0 = 0; i0 < LINES; i0 += SWEEP) {
      unsigned best[SWEEP], tied[SWEEP];
#pragma unroll
      for (int i = 0; i < SWEEP; ++i)
        best[i] = __reduce_max_sync(0xffffffffu, hi[i0 + i]);
#pragma unroll
      for (int i = 0; i < SWEEP; ++i)
        tied[i] = __ballot_sync(0xffffffffu, hi[i0 + i] == best[i]);
#pragma unroll
      for (int i = 0; i < SWEEP; ++i) {
        const int w = __ffs(tied[i]) - 1;          // the same in every lane
        const int q = 2 * w + (int)((sec[i0 + i] >> w) & 1u);
        mine[i0 + i] = lane == r ? (best[i] ? q : -1) : mine[i0 + i];
        hi[i0 + i] = lane == w ? lo[i0 + i] : hi[i0 + i];
        lo[i0 + i] = lane == w ? 0u : lo[i0 + i];
        sec[i0 + i] ^= 1u << w;
      }
    }
  }
  if (lane >= kc) return;
  const size_t base =
      ((size_t)slot * t + sd.line_in + g) * per + (size_t)sd.blk * kc + lane;
#pragma unroll
  for (int i = 0; i < LINES; ++i) {
    const int line = g + SEL_WARPS * i;
    if (sd.line_in + line >= t) continue;
    const int q = mine[i];
    const size_t idx = base + (size_t)i * SEL_WARPS * per;
    sd.part_v[idx] =
        q >= 0 ? sd.val[line * sd.line_step + q * sd.cand_step] : 0.f;
    sd.part_c[idx] = q >= 0 ? (int)(sd.gcand0 + q) : -1;
  }
}

// Rank counting: all 64 lines of side `sd`, by 256 threads (tid) with the
// barrier sync() over them; key is a 64 x 65 scratch of shared memory.
template <typename Sync>
__device__ __forceinline__ void rank_lines(const Side& sd,
                                           float (&key)[BM][BM + 1], int tid,
                                           Sync sync, long long slot, int t,
                                           size_t per, int kc,
                                           int n_cols_valid) {
  const int line = tid >> 2;
  const int q0 = (tid & 3) * (BM / 4);
  const float* vl = sd.val + line * sd.line_step;
  sync();   // the previous side's ranks have read key
  for (int q = q0; q < q0 + BM / 4; ++q) {
    const long long gc = sd.gcand0 + q;
    const bool ok = sd.cand_in + q < t && gc < n_cols_valid &&
                    !(sd.self && gc == sd.gline0 + line);
    key[line][q] = ok ? fabsf(vl[q * sd.cand_step]) : -1.f;
  }
  sync();
  if (sd.line_in + line >= t) return;
  const size_t base =
      ((size_t)slot * t + sd.line_in + line) * per + (size_t)sd.blk * kc;
  for (int q = q0; q < q0 + BM / 4; ++q) {
    const float kq = key[line][q];
    int rank = 0;
    for (int o = 0; o < BM; ++o) {
      const float ko = key[line][o];
      rank += (ko > kq) || (ko == kq && o < q);
    }
    if (rank < kc) {
      sd.part_v[base + rank] = kq >= 0.f ? vl[q * sd.cand_step] : 0.f;
      sd.part_c[base + rank] = kq >= 0.f ? (int)(sd.gcand0 + q) : -1;
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
  __shared__ float key[BM][BM + 1];   // rank counting: |v|, -1 if masked

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
  __syncthreads();
  const size_t per = (size_t)nb * kc;
  const Side rows = row_side<BM + 1>(&val[0][0], yt, xt, r_in, c_in, t,
                                     symmetric, prv, prc);
  const Side cols = col_side<BM + 1>(&val[0][0], yt, xt, r_in, c_in, t,
                                     pcv, pcc_);
  const bool mirror = grid_cols == 0 && yt != xt;   // uniform
  if (kc <= KC_EXTRACT) {
    extract_lines<SIMT_SWEEP>(rows, tid / 32, tid % 32, blockIdx.x, t, per,
                              kc, n_cols_valid);
    if (mirror)
      extract_lines<SIMT_SWEEP>(cols, tid / 32, tid % 32, blockIdx.x, t,
                                per, kc, n_cols_valid);
  } else {
    auto sync = [] { __syncthreads(); };
    rank_lines(rows, key, tid, sync, blockIdx.x, t, per, kc, n_cols_valid);
    if (mirror)
      rank_lines(cols, key, tid, sync, blockIdx.x, t, per, kc,
                 n_cols_valid);
  }
}

// Select (bf16): one CTA per 128 x 128 block of each valid tile, computed
// by the tensor-core mainloop of pcc_tiles (pcc_mma.cuh, the same stages
// and steps, so the values are bitwise pcc_tiles'), then selected as the
// four 64 x 64 blocks of the SIMT kernel, into the same scratch.  The ring
// is reused for the finished block once both consumer warpgroups are done
// with it.  Extraction runs on all SEL_ALL warps, the producer warpgroup's
// too (it has issued its loads by then), one (side, 64 x 64 block, line
// group) unit at a time; rank counting on the two consumer warpgroups.
constexpr int SEL_STAGES = 4;
constexpr int SEL_LD = mma::BLOCK + 1;
constexpr int SEL_SMEM = SEL_STAGES * mma::STAGE_BYTES + 1024;
constexpr int SEL_ALL = mma::THREADS / 32;
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
  const bool extract = kc <= KC_EXTRACT;   // uniform

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
  float* val = reinterpret_cast<float*>(slots);
  auto& key = *reinterpret_cast<float(*)[BM][BM + 1]>(
      val + mma::BLOCK * SEL_LD);
  auto sync = [] { sm90::bar_sync(1, mma::CONSUMERS); };
  if (warp >= mma::CONSUMERS / 32) {
    if (threadIdx.x == mma::CONSUMERS) {
      int it = 0;
      mma::load_block<T, SEL_STAGES>(&ta, &tb, ring, slots, it, nk,
                                     yt * t + r_blk, xt * t + c_blk, 0);
    }
    __syncwarp();
    if (!extract) return;
  } else {
    const int wg = warp / 4;
    const int lane = threadIdx.x % 128;
    float acc[mma::ACC];
    int it = 0;
    mma::mma_block<T, SEL_STAGES>(acc, ring, sm90::smem_u32(slots), it, nk,
                                  wg);
    sync();   // both warpgroups' products have read the ring
    const int row0 = 64 * wg + 16 * (lane / 32) + (lane % 32) / 4;
    const int col0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < mma::BLOCK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        val[(row0 + 8 * (e >> 1)) * SEL_LD + 8 * j + col0 + (e & 1)] =
            epilogue(acc[4 * j + e], has_div, recip, has_clip, lo, hi);
  }

  const size_t per = (size_t)nb * kc;
  const bool mirror = grid_cols == 0 && yt != xt;
  auto side_of = [&](int sb, bool cols) {
    const int r_in = r_blk + BM * (sb >> 1), c_in = c_blk + BM * (sb & 1);
    const float* vb = val + BM * (sb >> 1) * SEL_LD + BM * (sb & 1);
    return cols ? col_side<SEL_LD>(vb, yt, xt, r_in, c_in, t, pcv, pcc_)
                : row_side<SEL_LD>(vb, yt, xt, r_in, c_in, t, symmetric,
                                   prv, prc);
  };
  auto inside = [&](int sb) {
    return r_blk + BM * (sb >> 1) < t && c_blk + BM * (sb & 1) < t;
  };
  if (extract) {
    sm90::bar_sync(2, mma::THREADS);   // the finished block is complete
    const int units = (mirror ? 2 : 1) * 4 * SEL_WARPS;
    for (int u = warp; u < units; u += SEL_ALL) {
      const int sb = (u / SEL_WARPS) % 4;
      if (!inside(sb)) continue;   // uniform over the warp
      extract_lines<LINES>(side_of(sb, u >= 4 * SEL_WARPS), u % SEL_WARPS,
                           threadIdx.x % 32, blockIdx.x, t, per, kc,
                           n_cols_valid);
    }
    return;
  }
  for (int sb = 0; sb < 4; ++sb) {
    if (!inside(sb)) continue;   // uniform over the CTA
    rank_lines(side_of(sb, false), key, threadIdx.x, sync, blockIdx.x, t,
               per, kc, n_cols_valid);
    if (mirror)
      rank_lines(side_of(sb, true), key, threadIdx.x, sync, blockIdx.x, t,
                 per, kc, n_cols_valid);
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
