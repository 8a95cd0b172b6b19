// Per-row top-k of all-pairs correlation tiles for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/pcc_tile.py::pcc_topk_tiles
// (bodies _topk_kernel and _topk_select) with float32, bfloat16, float16 or
// int8 operands (select entry points pcc_topk_select_f32 / _bf16 / _f16 /
// _i8; the accumulation _topk_kernel shares with _kernel,
// pcc_tile.py:550-559),
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
//      are bitwise pcc_tiles': for float32 the 128 x 128 SGEMM mainloop of
//      the float32 tiles (pcc_sgemm.cuh), for bf16, fp16 and int8 the
//      tensor-core mainloop of pcc_tile_sm90.cu (pcc_mma.cuh, the same
//      stages and wgmma steps; int8 one exact int32 sum, converted once),
//      each on a 128 x 128 block cut into four 64 x 64 quarters.  The
//      CTA's finished block goes to shared memory and each row of a 64 x 64
//      quarter (and, off the diagonal, each of its columns) selects its
//      top-min(kk, 64) (below): by warp extraction while that is at most
//      32, else by rank counting.  The partial lists go to a pass scratch
//      of (pass_tiles, t, ceil(t/64), min(kk, 64)) entries per side: 160 KB
//      per 256 x 256 tile at kk = 10, against the 256 KB tile.
//   2. pcc_topk_merge: one warp per output row (both sides of it on the
//      triangle, so every warp merges the same number of tiles) merges the
//      partial lists of the pass's tiles of its row block, found in closed
//      form from the pass's tile-id range (no host index).  Each partial
//      list is in canonical order, so its head decides it: the warp reads
//      the heads of 32 lists at a time (the next 32 in flight meanwhile),
//      and walks only the lists whose head precedes the held kk-th entry,
//      entry by entry until one does not; each entry that passes is
//      inserted into the held state, kept in registers (lane i holds
//      entries i, i + 32, ...).  The heads lie 4 * kc bytes apart, so
//      reading them touches most sectors of the value array, ~0.1 ms at
//      Table II whatever the warps do; the rest is the walks, which the
//      design keeps few and off the loads' path: the lanes whose heads
//      pass load their lists' first WALK entries together, once a step,
//      and a walk reads them by shuffle; and while a row's state is empty,
//      only the lists whose head is among the step's kk largest are walked
//      (the kk-th head bounds the final kk-th entry from below).  Two or
//      four heads a lane a step, more loads in flight, were slower on the
//      H100; scripts/merge_ablation.py times the other choices.
// The canonical order is total over a row's unique columns, so any merge
// order gives the reference's set and order.
//
// What bounds it: the same work as pcc_tiles (2 l t^2 per tile; in float32
// 1.61e12 FLOP, >= 24 ms at 67 TFLOP/s, for the Table II pass; bf16, >= 1.6
// ms at 989 TFLOP/s, on the tensor cores; int8, 2 x 2,016 x 256^2 ops a
// tile of int8 Kendall over 64 samples, >= 0.32 ms a Table II pass at
// 1,979 TOP/s).  The merge kernel reads float32 values whatever the
// operands.  The selection is
// not in the bound, and its cost is what this design keeps down: at kc
// entries a line, extraction is kc rounds, each a warp reduction, a ballot
// and a few selects for the line's 64 candidates, with no branch or memory
// access inside a round (rank counting, kept for kc > 32, takes 64
// comparisons a candidate whatever kc); the 128 x 128 selects spread it
// over all their warps.  The merge must read every list's head (4 bytes;
// at Table II 4.9 M lists, 20 MB, though the card moves 32-byte sectors:
// 156 MB, >= 0.047 ms) and the entries that enter the state; reading the
// whole scratch would be ~0.4 GB (~0.12 ms at 3.35 TB/s).

#include <stdio.h>

#include "pcc_accum.cuh"
#include "pcc_mma.cuh"
#include "pcc_sgemm.cuh"

namespace {

using namespace pcc;

constexpr int BM = 64;            // a quarter of a 128 x 128 block: lists
                                  // are per line and 64-candidate quarter
constexpr int KC_MAX = BM;        // partial list length per quarter line
constexpr int KK_MAX = 256;       // state capacity cap (the wrapper checks)
constexpr int MERGE_WARPS = 8;    // output rows per merge CTA
static_assert(KK_MAX % 32 == 0, "the merge holds KK_MAX / 32 entries a lane");
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
//     lines and runs each round over all of them, so their reductions
//     issue back to back.
//   * larger kc, rank counting (rank_lines): 4 threads a line, each
//     candidate's slot is the number of candidates of its line that
//     precede it; 64 comparisons a candidate, whatever kc.
// Keys of NaN values sort first on the first route; NaN tiles are outside
// the contract of both.
constexpr int SEL_WARPS = 8;                 // warps sharing a quarter side
constexpr int LINES = BM / SEL_WARPS;        // lines a warp holds, per side
constexpr int RANK_THREADS = 4 * BM;         // rank counting: 4 a line
constexpr int KC_EXTRACT = 32;
static_assert(KC_EXTRACT <= 32, "lane r keeps entry r of its lines");

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
__device__ __forceinline__ void extract_lines(const Side& sd, int g,
                                              int lane, long long slot,
                                              int t, size_t per, int kc,
                                              int n_cols_valid) {
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
    unsigned best[LINES], tied[LINES];
#pragma unroll
    for (int i = 0; i < LINES; ++i)
      best[i] = __reduce_max_sync(0xffffffffu, hi[i]);
#pragma unroll
    for (int i = 0; i < LINES; ++i)
      tied[i] = __ballot_sync(0xffffffffu, hi[i] == best[i]);
#pragma unroll
    for (int i = 0; i < LINES; ++i) {
      const int w = __ffs(tied[i]) - 1;            // the same in every lane
      const int q = 2 * w + (int)((sec[i] >> w) & 1u);
      mine[i] = lane == r ? (best[i] ? q : -1) : mine[i];
      hi[i] = lane == w ? lo[i] : hi[i];
      lo[i] = lane == w ? 0u : lo[i];
      sec[i] ^= 1u << w;
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

// Rank counting: all 64 lines of side `sd`, by RANK_THREADS threads (tid)
// with the barrier sync() over them; key is a 64 x 65 scratch of shared
// memory.
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

// The selection of a finished 128 x 128 block: val (row stride SEL_LD) at
// (r_blk, c_blk) of tile (yt, xt), written to the scratch of slot
// blockIdx.x as four 64 x 64 quarters.  Quarters past t are skipped; the
// column side runs only off the diagonal of a triangle (`mirror`).
// kc <= KC_EXTRACT: extraction by warps warp, warp + n_warps, ..., one
// (side, quarter, line group) unit at a time; else rank counting by the
// RANK_THREADS threads that call it (barrier sync()) in the key scratch.
constexpr int SEL_LD = 128 + 1;
static_assert(mma::BLOCK == 128 && sgemm::BLOCK == 128,
              "both selects cut 128 x 128 blocks into 64 x 64 quarters");

template <typename Sync>
__device__ __forceinline__ void select_quarters(
    const float* val, float (&key)[BM][BM + 1], Sync sync, int warp,
    int n_warps, int yt, int xt, int r_blk, int c_blk, int t, int nb,
    int kc, int n_cols_valid, int symmetric, bool mirror, float* prv,
    int* prc, float* pcv, int* pcc_) {
  const size_t per = (size_t)nb * kc;
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
  if (kc <= KC_EXTRACT) {
    const int units = (mirror ? 2 : 1) * 4 * SEL_WARPS;
    for (int u = warp; u < units; u += n_warps) {
      const int sb = (u / SEL_WARPS) % 4;
      if (!inside(sb)) continue;   // uniform over the warp
      extract_lines(side_of(sb, u >= 4 * SEL_WARPS), u % SEL_WARPS,
                    threadIdx.x % 32, blockIdx.x, t, per, kc, n_cols_valid);
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

// Select (float32): one CTA per 128 x 128 block of each valid tile, computed
// by the mainloop of the float32 tiles (sgemm::accumulate_block, the same
// fmaf chains, so the values are bitwise pcc_tiles'), two CTAs an SM.  Once
// every thread is past the mainloop, its ring takes the finished block
// (66,048 B at the row stride SEL_LD) and, behind it, the key scratch of
// rank counting; then all 8 warps select the four quarters.
constexpr int F32_SMEM = (sgemm::BLOCK * SEL_LD + BM * (BM + 1)) * 4;
static_assert(F32_SMEM >= sgemm::SMEM_BYTES, "the ring fits too");
static_assert(sgemm::THREADS == RANK_THREADS, "all threads rank");

__global__ void __launch_bounds__(sgemm::THREADS, 2)
pcc_topk_select_f32_kernel(const float* __restrict__ u,
                           const float* __restrict__ v,
                           float* __restrict__ prv, int* __restrict__ prc,
                           float* __restrict__ pcv, int* __restrict__ pcc_,
                           long long j_start, long long dev_hi, int m,
                           int grid_cols, int t, int l_pad, int nb,
                           int nb128, int kc, int n_cols_valid,
                           int symmetric, int has_div, float recip,
                           int has_clip, float lo, float hi) {
  extern __shared__ __align__(16) float smem[];
  const long long jt_raw = j_start + (long long)blockIdx.x;
  if (jt_raw >= dev_hi) return;       // uniform over the CTA
  const long long total = tile_total(m, grid_cols);
  const long long jt = jt_raw < total ? jt_raw : total - 1;
  int yt, xt;
  tile_coord(m, grid_cols, jt, &yt, &xt);
  const int r_blk = (blockIdx.y / nb128) * sgemm::BLOCK;
  const int c_blk = (blockIdx.y % nb128) * sgemm::BLOCK;

  float acc[sgemm::TM][sgemm::TM];
  sgemm::accumulate_block(u + ((size_t)yt * t + r_blk) * l_pad,
                          v + ((size_t)xt * t + c_blk) * l_pad, t - r_blk,
                          t - c_blk, l_pad, smem, acc);
  __syncthreads();   // every thread is done reading the ring
  const int ty = sgemm::ty_of(threadIdx.x), tx = sgemm::tx_of(threadIdx.x);
#pragma unroll
  for (int i = 0; i < sgemm::TM; ++i)
#pragma unroll
    for (int j = 0; j < sgemm::TM; ++j)
      smem[sgemm::strip(ty, i) * SEL_LD + sgemm::strip(tx, j)] =
          epilogue(acc[i][j], has_div, recip, has_clip, lo, hi);
  __syncthreads();
  auto& key = *reinterpret_cast<float(*)[BM][BM + 1]>(
      smem + sgemm::BLOCK * SEL_LD);
  select_quarters(smem, key, [] { __syncthreads(); }, threadIdx.x / 32,
                  sgemm::THREADS / 32, yt, xt, r_blk, c_blk, t, nb, kc,
                  n_cols_valid, symmetric, grid_cols == 0 && yt != xt, prv,
                  prc, pcv, pcc_);
}

// Select (bf16, fp16, int8): one CTA per 128 x 128 block of each valid tile,
// computed by the tensor-core mainloop of pcc_tiles (pcc_mma.cuh, the same
// stages and steps, so the values are bitwise pcc_tiles'; int8's int32 sum
// is converted once, by acc_value, before the epilogue), then selected as
// the four quarters.  The ring is reused for the finished block once both
// consumer warpgroups are done with it.  Extraction runs on all SEL_ALL
// warps, the producer warpgroup's too (it has issued its loads by then);
// rank counting on the two consumer warpgroups.
constexpr int SEL_STAGES = 4;
constexpr int SEL_SMEM = SEL_STAGES * mma::STAGE_BYTES + 1024;
constexpr int SEL_ALL = mma::THREADS / 32;
static_assert(mma::BLOCK * SEL_LD * 4 + BM * (BM + 1) * 4 <=
                  SEL_STAGES * mma::STAGE_BYTES,
              "the finished block and the keys fit in the ring");
static_assert(mma::CONSUMERS == RANK_THREADS, "the consumers rank");

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
    typename mma::Operand<T>::Acc acc[mma::ACC];
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
            epilogue(mma::acc_value(acc[4 * j + e]), has_div, recip,
                     has_clip, lo, hi);
  }
  if (extract)
    sm90::bar_sync(2, mma::THREADS);   // the finished block is complete
  select_quarters(val, key, sync, warp, SEL_ALL, yt, xt, r_blk, c_blk, t,
                  nb, kc, n_cols_valid, symmetric,
                  grid_cols == 0 && yt != xt, prv, prc, pcv, pcc_);
}

// id of the triangle tile (y, Y)
__device__ __forceinline__ long long mirror_id(long long m, long long Y,
                                               long long y) {
  return tri_before(m, y) + Y - y;
}

// The merge's order key of an entry: |v|'s bits (non-negative floats order
// as their bits), then the complement of the column, so a larger key comes
// first in the canonical order.  A masked entry (value 0, column -1) has
// key 0, below every valid one (whose low word is >= 2^31).
__device__ __forceinline__ unsigned long long merge_key(float v, int c) {
  return ((unsigned long long)__float_as_uint(fabsf(v)) << 32) |
         (unsigned)~c;
}

constexpr unsigned FULL = 0xffffffffu;
// entries of a passing list that its lane loads for the walk
constexpr int WALK = 4;

// A row's held state: entry i = 32 w + lane in key[w] / val[w], keys
// descending; empty entries have key 0 and value 0 (so column ~0 = -1).
template <int KW>
struct Held {
  unsigned long long key[KW];
  float val[KW];
};

// Put (k, v) at its rank among the held entries, each entry behind it
// moving up one; entries pushed past KW * 32 are dropped.
template <int KW>
__device__ __forceinline__ void insert(Held<KW>& h, unsigned long long k,
                                       float v, int lane) {
  int pos = 0;
#pragma unroll
  for (int w = 0; w < KW; ++w)
    pos += __popc(__ballot_sync(FULL, h.key[w] > k));
#pragma unroll
  for (int w = KW - 1; w >= 0; --w) {   // key[w - 1] is still the old one
    unsigned long long pk = __shfl_up_sync(FULL, h.key[w], 1);
    float pv = __shfl_up_sync(FULL, h.val[w], 1);
    if (w > 0) {
      const unsigned long long ck = __shfl_sync(FULL, h.key[w - 1], 31);
      const float cv = __shfl_sync(FULL, h.val[w - 1], 31);
      if (lane == 0) {
        pk = ck;
        pv = cv;
      }
    }
    const int i = 32 * w + lane;
    h.key[w] = i == pos ? k : (i > pos ? pk : h.key[w]);
    h.val[w] = i == pos ? v : (i > pos ? pv : h.val[w]);
  }
}

// Key of held entry i (the same in every lane).  Each row is shuffled and
// the row picked after: picking among the rows' registers first compiled
// to an indexed load, which put the state in local memory (a stack frame).
template <int KW>
__device__ __forceinline__ unsigned long long held_key(const Held<KW>& h,
                                                       int i) {
  unsigned long long k = 0;
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    const unsigned long long x = __shfl_sync(FULL, h.key[w], i % 32);
    k = w == i / 32 ? x : k;
  }
  return k;
}

// Merge into one output row (ov, oc: its kk entries) the lists of n_src
// tiles of the pass: tile s is at slot slot0 + s, or, for the mirrored
// column state, at the slot of tile (y_lo + s, Y).  Its lists sit at
// ((slot * t + r) * nb + b) * kc, b < nb, each in canonical order with its
// masked entries last.  thr is the held kk-th key once kk entries are held
// (0 before: any valid entry passes); an entry enters iff its key exceeds
// thr.
template <int KW>
__device__ __forceinline__ void merge_row(
    const float* __restrict__ pv, const int* __restrict__ pc,
    float* __restrict__ ov, int* __restrict__ oc, bool mirror, int n_src,
    long long slot0, long long y_lo, int m, int Y, long long j_start, int t,
    int r, int nb, int kc, int kk, int lane) {
  Held<KW> h;
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    h.key[w] = 0;
    h.val[w] = 0.f;
  }
  int held = 0;
  unsigned long long thr = 0;
  // Insert, in order, the entries of a passing list that precede the held
  // kk-th entry, up to the first that does not (every later entry of the
  // list follows it); returns whether the next entry may still enter.
  auto take = [&](float v, int c) {
    const unsigned long long k = merge_key(v, c);
    if (k <= thr) return false;
    insert(h, k, v, lane);
    if (held < kk) ++held;
    if (held == kk) thr = held_key(h, kk - 1);
    return true;
  };
  const int per = nb * kc;
  const int n_lists = n_src * nb;
  // lane's list L = 32 c + lane of step c is block b of tile s; L, s and b
  // move on by 32 lists a step, without a division
  const int ds = 32 / nb, db = 32 % nb;
  int s = lane / nb, b = lane % nb, L = lane;
  size_t idx = 0;
  float head = 0.f;
  auto fetch = [&]() {
    if (L < n_lists) {
      long long slot = slot0 + s;
      if (mirror) slot = mirror_id(m, Y, y_lo + s) - j_start;
      idx = ((size_t)slot * t + r) * per + (size_t)b * kc;
      head = pv[idx];
    }
    L += 32;
    s += ds;
    b += db;
    if (b >= nb) {
      b -= nb;
      ++s;
    }
  };
  fetch();
  for (int c0 = 0; c0 < n_lists; c0 += 32) {
    const bool ok = c0 + lane < n_lists;
    const size_t cur = idx;
    const float cur_v = head;
    fetch();   // the next step's heads load while this step is decided
    const unsigned hb = __float_as_uint(fabsf(cur_v));
    // While the state is empty, the kk-th largest |v| among this step's
    // heads (those above 0, surely valid) bounds the final kk-th entry
    // from below, so lists whose head is under it are skipped unwalked.
    unsigned floor_hb = 0;
    if (held == 0 && kk <= 32) {   // uniform
      unsigned x = ok ? hb : 0u;
      if (__popc(__ballot_sync(FULL, x > 0)) >= kk) {
        for (int i = 1; i < kk; ++i) {
          const unsigned top = __reduce_max_sync(FULL, x);
          const int at = __ffs(__ballot_sync(FULL, x == top)) - 1;
          x = lane == at ? 0u : x;
        }
        floor_hb = __reduce_max_sync(FULL, x);
      }
    }
    // a head with |v| above the threshold's is valid (masked entries are
    // 0); at equal |v| its column decides
    const unsigned th = (unsigned)(thr >> 32);
    const bool pass =
        ok && hb >= floor_hb &&
        (hb > th || (hb == th && merge_key(cur_v, pc[cur]) > thr));
    // the lanes whose heads pass load their lists' first WALK entries, all
    // at once, so the walks below wait on no load until entry WALK
    float lv[WALK];
    int lc[WALK];
#pragma unroll
    for (int e = 0; e < WALK; ++e) {
      lv[e] = e == 0 ? cur_v : (pass && e < kc ? pv[cur + e] : 0.f);
      lc[e] = pass && e < kc ? pc[cur + e] : -1;
    }
    unsigned lists = __ballot_sync(FULL, pass);
    while (lists) {   // uniform
      const int src = __ffs(lists) - 1;
      lists &= lists - 1;
      bool more = true;
#pragma unroll
      for (int e = 0; e < WALK; ++e)
        if (more && e < kc)
          more = take(__shfl_sync(FULL, lv[e], src),
                      __shfl_sync(FULL, lc[e], src));
      if (!more || kc <= WALK) continue;
      // the rest of the list, entries WALK .. kc-1 (kc <= 64)
      const size_t at =
          __shfl_sync(FULL, (unsigned long long)cur, src) + WALK;
      const int rest = kc - WALK;
      float va = 0.f, vb = 0.f;
      int ca = -1, cb = -1;
      if (lane < rest) {
        va = pv[at + lane];
        ca = pc[at + lane];
      }
      if (lane + 32 < rest) {
        vb = pv[at + lane + 32];
        cb = pc[at + lane + 32];
      }
      for (int q = 0; q < rest && more; ++q)
        more = take(__shfl_sync(FULL, q < 32 ? va : vb, q & 31),
                    __shfl_sync(FULL, q < 32 ? ca : cb, q & 31));
    }
  }
#pragma unroll
  for (int w = 0; w < KW; ++w) {
    const int i = 32 * w + lane;
    if (i < kk) {
      ov[i] = h.val[w];
      oc[i] = (int)~(unsigned)h.key[w];
    }
  }
}

// Merge: one warp per output row r of row block Y: the row state from the
// tiles (Y, x) of the pass and, on the triangle, the mirrored column state
// from the tiles (y, Y), y < Y, so that each warp merges the lists of the
// same number of tiles (m, over a whole triangle).  KW * 32 >= kk.
template <int KW>
__global__ void __launch_bounds__(MERGE_WARPS * 32)
pcc_topk_merge_kernel(const float* __restrict__ prv,
                      const int* __restrict__ prc,
                      const float* __restrict__ pcv,
                      const int* __restrict__ pcc_, float* __restrict__ rv,
                      int* __restrict__ rc, float* __restrict__ cv,
                      int* __restrict__ cc, long long j_start,
                      long long hi_eff, int m, int grid_cols, int t, int nb,
                      int kc, int kk) {
  const int lane = threadIdx.x & 31;
  const long long g =
      (long long)blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (g >= (long long)m * t) return;   // whole warp
  const int Y = (int)(g / t), r = (int)(g % t);
  const long long mm = m;
  const size_t out = ((size_t)Y * t + r) * kk;

  // this pass's tiles (Y, x): consecutive slots
  const long long id_lo = grid_cols > 0 ? (long long)Y * grid_cols
                                        : tri_before(mm, Y);
  const long long id_hi = grid_cols > 0 ? id_lo + grid_cols
                                        : id_lo + (mm - Y);
  const long long lo = id_lo > j_start ? id_lo : j_start;
  const long long hi = id_hi < hi_eff ? id_hi : hi_eff;
  merge_row<KW>(prv, prc, rv + out, rc + out, false,
                hi > lo ? (int)(hi - lo) : 0, lo - j_start, 0, m, Y, j_start,
                t, r, nb, kc, kk, lane);
  if (grid_cols > 0) return;

  // tiles (y, Y), y < Y: mirror_id grows with y
  auto first_at_least = [&](long long bound) {
    long long a = 0, b = Y;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (mirror_id(mm, Y, mid) < bound) a = mid + 1; else b = mid;
    }
    return a;
  };
  const long long y_lo = first_at_least(j_start);
  merge_row<KW>(pcv, pcc_, cv + out, cc + out, true,
                (int)(first_at_least(hi_eff) - y_lo), 0, y_lo, m, Y,
                j_start, t, r, nb, kc, kk, lane);
}

// float32: the select on the SGEMM mainloop.
int launch_select_f32(const float* u, const float* v, float* prv, int* prc,
                      float* pcv, int* pcc_, long long j_start,
                      long long dev_hi, int pass_tiles, int m, int grid_cols,
                      int t, int l_pad, int kk, int n_cols_valid,
                      int symmetric, int has_div, float recip, int has_clip,
                      float lo, float hi, void* stream) {
  if (pass_tiles <= 0 || m <= 0 || grid_cols < 0 || t <= 0 || l_pad <= 0 ||
      j_start < 0 || kk <= 0 || kk > KK_MAX)
    return (int)cudaErrorInvalidValue;
  const int nb = (t + BM - 1) / BM;
  const int nb128 = (t + sgemm::BLOCK - 1) / sgemm::BLOCK;
  if ((long long)nb128 * nb128 > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      pcc_topk_select_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F32_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int kc = kk < KC_MAX ? kk : KC_MAX;
  const dim3 grid((unsigned)pass_tiles, (unsigned)(nb128 * nb128));
  pcc_topk_select_f32_kernel<<<grid, sgemm::THREADS, F32_SMEM,
                               (cudaStream_t)stream>>>(
      u, v, prv, prc, pcv, pcc_, j_start, dev_hi, m, grid_cols, t, l_pad, nb,
      nb128, kc, n_cols_valid, symmetric, has_div, recip, has_clip, lo, hi);
  return (int)cudaGetLastError();
}

// bf16, fp16 and int8: the tensor-core select.  Its operands meet TMA's
// alignment (16-byte rows: l_pad a multiple of 8 bf16 / fp16 or 16 int8 samples,
// and 16-byte bases; the wrapper pads otherwise).
template <typename T>
int launch_select_sm90(const T* u, const T* v, float* prv, int* prc,
                       float* pcv, int* pcc_, long long j_start,
                       long long dev_hi, int pass_tiles, int m,
                       int grid_cols, int t, int l_pad, int kk,
                       int n_cols_valid, int symmetric, int has_div,
                       float recip, int has_clip, float lo, float hi,
                       void* stream) {
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

PCC_TOPK_SELECT_ENTRY(pcc_topk_select_f32, float, launch_select_f32)
PCC_TOPK_SELECT_ENTRY(pcc_topk_select_bf16, __nv_bfloat16, launch_select_sm90)
PCC_TOPK_SELECT_ENTRY(pcc_topk_select_f16, __half, launch_select_sm90)
PCC_TOPK_SELECT_ENTRY(pcc_topk_select_i8, int8_t, launch_select_sm90)

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
  const long long blocks = ((long long)m * t + MERGE_WARPS - 1) / MERGE_WARPS;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const auto kernel = kk <= 32 ? pcc_topk_merge_kernel<1>
                               : pcc_topk_merge_kernel<KK_MAX / 32>;
  kernel<<<(unsigned)blocks, MERGE_WARPS * 32, 0, (cudaStream_t)stream>>>(
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
