// Merge-sort Kendall tiles for NVIDIA Hopper (sm_90a): Knight's O(l log l)
// concordant-minus-discordant count per pair of rows.
//
// Replaces repro/kernels/kendall_merge.py::kendall_merge_tiles (plain JAX,
// not a Pallas kernel: its per-pair lexsort and explicit merge levels are
// what this kernel computes).  For each pair (i, j) of a launch's tiles it
// counts, exactly as the reference's _pair_terms defines them,
//   n3 = the sample pairs tied in both row i and column j,
//   S  = the strict inversions of column j's values after a lexsort of the
//        samples by (row value, column value),
// and writes float32(n0 - n1_i - n2_j + n3 - 2 S) (int32 arithmetic, one
// round-to-nearest conversion), for tau-b times (s_i * s_j), the product
// first, then the fused EpilogueSpec (pcc_accum.cuh finalize, as every pcc
// kernel does).  Tile ids: the triangle (grid_cols == 0) or the grid;
// output slot b holds tile min(j_start + b, total - 1).
//
// Inputs (kernels/kendall_merge.py rank_structure, int16 rows of stride ld,
// a multiple of 8): the row operand's `order` (each row's stable argsort)
// and `runs` (the run index of each sorted position: equal values share
// one), its rows' longest runs, the column operand's `codes` (each value's
// dense rank, so ties and order are kept), and each side's tie pairs
// n1 / n2 and tau-b scales.  A row whose tie pairs are n0 is constant: by
// Knight's identity (n1 = n0, n3 = n2, S = 0) its every pair is exactly 0,
// and so is every pair of a constant column; those pairs skip the count
// (the padding rows are such rows).
//
// One sort a pair.  Lay q = codes_j[order_i] out in row i's order.  The
// lexsort only reorders q inside each tie run of row i, so
//   S = inv(q) - I_w,   I_w = the strict inversions of q inside row i's runs,
// and n3 is the pairs of equal q inside row i's runs.  A row whose longest
// run is at most SHORT_RUN_MAX takes I_w and n3 by direct compares, each
// tied position against the earlier ones of its run (one compare for a run
// of 2), read from the staged codes before the sort; then one sort of the
// uint16 keys q counts inv(q).  A row with a longer run sorts the uint32
// keys (run << 16) | q first (the lexsort; n3 from the runs of equal keys),
// then the q of that order, whose strict inversions are S: two sorts.
//
// What bounds it: the count is integer compares and shared-memory traffic,
// no floating point.  The least work the data needs is a sort of the l
// keys of each pair of distinct non-constant rows, l log2(l) compares,
// counted once where a pair sits twice in a diagonal tile, plus the sort
// of each tie run of the row whose order is taken (c log2(c) a run of c;
// on a diagonal tile the cheaper row's), over the card's 32-bit integer
// rate (64 lanes an SM, 132 SMs); its bytes
// (ranks in once, tiles out once) are ~1,000x fewer at l = 5,072.
//
// Design: a group of P threads sorts a pair, E = the keys a thread holds (a
// template constant, from a small set, P E >= l: no power-of-two pad; the
// P E - l tail holds sentinels above every key, which only ever meet
// all-sentinel right blocks and add nothing).  Each thread gathers its E
// keys into registers, sorts them by odd-even transposition (E rounds of
// adjacent compare-exchanges, ties kept in place) and counts the swaps,
// which are exactly their strict inversions; then log2(P) merge levels over
// blocks of E 2^k keys in shared memory (two ping-pong buffers).  A merge
// level is a merge-path merge: each thread finds where its E outputs start
// in the left and right blocks by one binary search (the co-rank) and
// merges them in turn, ties to the left, so each right key taken adds the
// left keys still waiting, all strictly greater (the reference's
// searchsorted side="right"); the last level stores nothing.  The merge
// steps pointers into the two blocks; a buffer holds a pad key every 32
// only where a thread's store stride would put 8 or more threads of a warp
// on one bank (padded()), and steps indices there.  The first five levels
// merge within a warp and wait on __syncwarp; only log2(P / 32) levels
// wait on the group.
//   l <= 1,024: P = 32, a warp a pair, eight warps a CTA on eight columns
//     of one row at once, no CTA barrier in the count.
//   l <= 6,144: P = 256 (one CTA a pair, three CTA barriers a sort);
//   l <= 16,384: P = 512.
// A CTA holds its row's order and runs (uint16) and its tile's column tie
// pairs and scales, and walks the tile's t columns; on a diagonal tile of
// a symmetric launch (columns = rows) only columns c >= its row, each
// value written to both cells.  Each group copies its next column's codes
// with cp.async into a second buffer while it sorts the current one, when
// that buffer costs no CTA an SM (code_buffers).  Counts add up per thread
// (mod 2^32: the totals are exact), across a warp by shuffles, and across a
// CTA group through shared memory, summed after the next column's barrier.
// At l = 5,072 (P 256, E 20; registers ~80, three CTAs an SM): uint16 keys
// 63,104 bytes of shared memory with the prefetch buffer; a launch whose
// rows have a run longer than SHORT_RUN_MAX keeps uint32 keys, 73,440 bytes
// with one code buffer.  At l = 16,384 with uint32 keys the codes share the
// second key buffer (no prefetch): 202,784 bytes.  On the H100 the TF
// triangle (1,639 rows, l = 5,072, tau-a) takes about 87 ms; leaving out
// one part at a time saves about 27 ms for the three CTA-level merge
// levels, 16 for the co-rank searches, 10 for the leaf and 4 for the
// merge stores; the five warp-level levels were not measured apart
// (scripts/kendall_ablation.py).  kendall_merge_instantiations lists the
// instantiations; kendall_merge_occupancy reports the shape, shared
// memory, registers and CTAs an SM of a launch.

#include "cp_async.cuh"
#include "pcc_accum.cuh"

namespace {

using namespace pcc;

// the longest tie run of a row on the one-sort path (kernels/
// kendall_merge.py SHORT_RUN_MAX)
constexpr int SHORT_RUN_MAX = 32;
constexpr int MAX_L = 16384;
// dynamic shared memory a CTA may take, the static `red` sums kept aside;
// an SM's shared memory
constexpr int MAX_SMEM = 232448 - 1024;
constexpr size_t SM_SMEM = 233472;
// an exhausted block's head: above every key and sentinel
constexpr uint32_t EXH = 0xffffffffu;
constexpr uint32_t SENT16 = 0xffffu;
constexpr uint32_t SENT32 = 0x7fffffffu;

template <int P>
__device__ __forceinline__ void group_sync() {
  if (P == 32) __syncwarp(); else __syncthreads();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copies n int16 (n a multiple of 8, both ends 16-byte aligned) from
// global to shared memory, 16 bytes a copy, thread g of `threads`.
__device__ __forceinline__ void stage16(uint16_t* dst, const int16_t* src,
                                        int n, int g, int threads) {
  for (int c = g; c < (n >> 3); c += threads)
    cp_async16(smem_addr(dst + 8 * c),
               reinterpret_cast<const float*>(src + 8 * c));
}

// Sorts v ascending in place by odd-even transposition (E rounds of
// adjacent compare-exchanges; equal keys never swap) and returns the swaps:
// each removes exactly one strict inversion, so they count them all.
template <int E>
__device__ __forceinline__ unsigned leaf_sort(uint32_t (&v)[E]) {
  unsigned inv = 0;
#pragma unroll
  for (int r = 0; r < E; ++r) {
#pragma unroll
    for (int x = r & 1; x + 1 < E; x += 2) {
      const uint32_t a = v[x], b = v[x + 1];
      inv += a > b;
      v[x] = min(a, b);
      v[x + 1] = max(a, b);
    }
  }
  return inv;
}

// Whether a buffer of keys of key_bytes, E a thread, holds a pad key every
// 32: when the E consecutive outputs of neighbouring threads would
// otherwise start 8 or more threads of a warp on one bank (a store stride
// of a multiple of 8 words: uint16 E = 16, 32; uint32 E = 8, 16, 24, 32).
// The pad costs address arithmetic on every access, so it is kept only
// there.
__host__ __device__ constexpr bool padded(int e, int key_bytes) {
  return e * key_bytes % 32 == 0;
}

// The buffer index of key x.
template <typename K, int E>
__device__ __forceinline__ int at(int x) {
  return padded(E, sizeof(K)) ? x + (x >> 5) : x;
}

// One merge level of a group's keys, sorted in blocks of blk = E << k: the
// pairs of blocks (L, R) at [p, p + blk) and [p + blk, p + 2 blk) merge
// into dst, ties to L.  Group thread g writes outputs [g E, g E + E) when
// STORE.  Returns the strict inversions its outputs close: each R key
// taken adds the L keys not yet taken, all strictly greater.  Unpadded
// buffers step pointers into L and R; padded ones step indices.
template <typename K, int E, bool STORE>
__device__ __forceinline__ unsigned merge_level(const K* src, K* dst, int k,
                                                int g) {
  const int blk = E << k;
  const int d = (g & ((2 << k) - 1)) * E;
  const int p = (g >> (k + 1) << (k + 1)) * E;
  // co-rank: how many of the first d outputs come from L
  int lo = max(0, d - blk), n = min(d, blk) - lo;
  while (n > 0) {
    const int half = n >> 1, mid = lo + half;
    if ((uint32_t)src[at<K, E>(p + mid)] <=
        (uint32_t)src[at<K, E>(p + blk + d - mid - 1)]) {
      lo = mid + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  unsigned inv = 0;
  if constexpr (padded(E, sizeof(K))) {
    int i = lo, j = d - lo;
    uint32_t a = i < blk ? (uint32_t)src[at<K, E>(p + i)] : EXH;
    uint32_t b = j < blk ? (uint32_t)src[at<K, E>(p + blk + j)] : EXH;
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const bool tl = a <= b;
      if (STORE) dst[at<K, E>(p + d + s)] = (K)min(a, b);
      if (!tl) inv += blk - i;
      if (s + 1 < E) {
        i += tl;
        j += !tl;
        const bool more = tl ? i < blk : j < blk;
        const uint32_t nx =
            more ? (uint32_t)src[at<K, E>(tl ? p + i : p + blk + j)] : EXH;
        a = tl ? nx : a;
        b = tl ? b : nx;
      }
    }
  } else {
    const K* pa = src + p + lo;           // the next L key
    const K* pb = src + p + blk + d - lo;  // the next R key
    const K* R = src + p + blk;
    uint32_t a = pa < R ? (uint32_t)*pa : EXH;
    uint32_t b = pb < R + blk ? (uint32_t)*pb : EXH;
    K* out = dst + p + d;
#pragma unroll
    for (int s = 0; s < E; ++s) {
      const bool tl = a <= b;
      if (STORE) out[s] = (K)min(a, b);
      if (!tl) inv += (unsigned)(R - pa);
      if (s + 1 < E) {
        pa += tl;
        pb += !tl;
        const K* next = tl ? pa : pb;
        const uint32_t nx =
            next < (tl ? R : R + blk) ? (uint32_t)*next : EXH;
        a = tl ? nx : a;
        b = tl ? b : nx;
      }
    }
  }
  return inv;
}

// Sorts the group's P E keys, group thread g holding v = keys [g E, g E +
// E): the leaf in registers, stored to *src, then the merge levels,
// ping-ponging src and dst.  STORE_LAST: the last level stores too, and the
// sorted keys end in *src (read them after a group barrier).  alias: dst
// holds the column's codes, which other warps may still read, so the first
// level waits on the whole group.  Returns the strict inversions of the
// keys this thread closed (0 unless COUNT).
template <typename K, int P, int E, bool COUNT, bool STORE_LAST>
__device__ __forceinline__ unsigned sort_keys(uint32_t (&v)[E], K*& src,
                                              K*& dst, int g, bool alias) {
  constexpr int LEVELS = P == 32 ? 5 : P == 256 ? 8 : 9;
  unsigned inv = leaf_sort<E>(v);
#pragma unroll
  for (int e = 0; e < E; ++e) src[at<K, E>(g * E + e)] = (K)v[e];
  if (alias) group_sync<P>(); else __syncwarp();
#pragma unroll 1
  for (int k = 0; k < LEVELS - 1; ++k) {
    inv += merge_level<K, E, true>(src, dst, k, g);
    K* tmp = src;
    src = dst;
    dst = tmp;
    // level k + 1 merges 4 << k threads' keys
    if ((4 << k) <= 32) __syncwarp(); else group_sync<P>();
  }
  if (STORE_LAST) {
    inv += merge_level<K, E, true>(src, dst, LEVELS - 1, g);
    K* tmp = src;
    src = dst;
    dst = tmp;
  } else {
    inv += merge_level<K, E, false>(src, dst, LEVELS - 1, g);
  }
  return COUNT ? inv : 0u;
}

// (S, n3) of one pair, this thread's share (mod 2^32): row i's order and
// runs in ord_s / run_s, column j's codes in code_s, two key buffers of
// P E uint32 (wide) or uint16 keys.
template <int P, int E>
__device__ __forceinline__ void pair_counts(
    const uint16_t* ord_s, const uint16_t* run_s, const uint16_t* code_s,
    void* key_a, void* key_b, int l, int g, bool row_ties, bool long_runs,
    bool alias, unsigned& s_out, unsigned& n3_out) {
  uint32_t v[E];
  unsigned n3 = 0;
  if (!long_runs) {
    unsigned iw = 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = g * E + e;
      v[e] = k < l ? code_s[ord_s[k]] : SENT16;
      // I_w and n3: the earlier positions of k's tie run in row i
      if (row_ties && k < l && k > 0) {
        const uint16_t r = run_s[k];
        for (int b = k - 1; b >= 0 && run_s[b] == r; --b) {
          const uint32_t c = code_s[ord_s[b]];
          iw += c > v[e];
          n3 += c == v[e];
        }
      }
    }
    uint16_t* src = static_cast<uint16_t*>(key_a);
    uint16_t* dst = static_cast<uint16_t*>(key_b);
    s_out = sort_keys<uint16_t, P, E, true, false>(v, src, dst, g, alias) - iw;
    n3_out = n3;
    return;
  }
  // the lexsort: keys (run << 16) | q, sorted
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = g * E + e;
    v[e] = k < l ? ((uint32_t)run_s[k] << 16) | code_s[ord_s[k]] : SENT32;
  }
  uint32_t* src = static_cast<uint32_t*>(key_a);
  uint32_t* dst = static_cast<uint32_t*>(key_b);
  sort_keys<uint32_t, P, E, false, true>(v, src, dst, g, alias);
  group_sync<P>();
  // n3: each sorted position adds the equal keys before it
  const int k0 = g * E;
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = src[at<uint32_t, E>(k0 + e)];
  int start = k0;
  if (k0 > 0 && k0 < l && src[at<uint32_t, E>(k0 - 1)] == v[0]) {
    int a = 0, b = k0 - 1;  // the first position of v[0]'s equal keys
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (src[at<uint32_t, E>(mid)] < v[0]) a = mid + 1; else b = mid;
    }
    start = a;
  }
  uint32_t prev = v[0];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int k = k0 + e;
    if (v[e] != prev) start = k;
    prev = v[e];
    if (k < l) n3 += k - start;
    // then S: the strict inversions of q in the lexsort's order
    v[e] = k < l ? (v[e] & 0xffffu) : SENT16;
  }
  group_sync<P>();
  uint16_t* src16 = reinterpret_cast<uint16_t*>(src);
  uint16_t* dst16 = reinterpret_cast<uint16_t*>(dst);
  s_out = sort_keys<uint16_t, P, E, true, false>(v, src16, dst16, g, false);
  n3_out = n3;
}

__device__ __forceinline__ void warp_sum2(unsigned& a, unsigned& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
}

struct Args {
  const int16_t* order;
  const int16_t* runs;
  const int* longest;
  const int* ties_r;
  const float* scale_r;
  const int16_t* codes;
  const int* ties_c;
  const float* scale_c;
  float* out;
  long long j_start;
  // wide: uint32 key buffers; symmetric: the column operand is the row
  // operand; ncode: code buffers a group (0: in its second key buffer);
  // col_smem: the tile's column ties and scales staged in shared memory
  int m, grid_cols, t, l, ld, tau_b, wide, symmetric, ncode, col_smem,
      has_div;
  float recip;
  int has_clip;
  float lo, hi;
};

__device__ __forceinline__ float result(const Args& a, int cmd, float sr,
                                       float sc) {
  return a.tau_b ? finalize<true>((float)cmd, sr, sc, a.has_div, a.recip,
                                  a.has_clip, a.lo, a.hi)
                 : finalize<false>((float)cmd, sr, sc, a.has_div, a.recip,
                                   a.has_clip, a.lo, a.hi);
}

// Writes column c's value, and its mirror (mirror[c t]) on a diagonal
// tile of a symmetric launch.
__device__ __forceinline__ void put(float* dst_row, float* mirror, int t,
                                    int c, float v) {
  dst_row[c] = v;
  if (mirror != nullptr) mirror[(size_t)c * t] = v;
}

// Column c's value from its counts (n2, sc: its tie pairs and tau-b scale).
__device__ __forceinline__ float value(const Args& a, unsigned s,
                                       unsigned n3, int n2, float sc, int n0,
                                       int n1, float sr) {
  return result(a, n0 - n1 - n2 + (int)n3 - 2 * (int)s, sr, sc);
}

// The same from the warps' partial (S, n3) sums of a CTA group.
template <int WARPS>
__device__ __forceinline__ float value_warps(const Args& a,
                                             unsigned (&part)[WARPS][2],
                                             int n2, float sc, int n0,
                                             int n1, float sr) {
  unsigned s = 0, n3 = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    s += part[w][0];
    n3 += part[w][1];
  }
  return value(a, s, n3, n2, sc, n0, n1, sr);
}

// Bytes of the tile's column ties and tau-b scales in shared memory.
__host__ __device__ constexpr size_t col_bytes(int t) {
  return ((size_t)t * 8 + 15) / 16 * 16;
}

// Bytes of one of a group's two key buffers of n keys, E a thread, uint32
// keys (wide, which also hold the second sort's uint16 keys) or uint16.
__host__ __device__ constexpr size_t key_buf_bytes(int n, int e, int wide) {
  return ((size_t)(n + (padded(e, wide ? 4 : 2) ? n / 32 + 1 : 0)) *
              (wide ? 4 : 2) + 15) / 16 * 16;
}

// CTAs an SM the register budget aims at: three for 256 threads, what
// their shared memory allows up to E = 24; two at a warp a pair with E =
// 32 and at P = 512, E = 16 (80 and 64 registers spill there); one above.
__host__ __device__ constexpr int min_ctas(int p, int e, int groups) {
  return p * groups >= 512 ? (e <= 16 ? 2 : 1) : (e >= 32 ? 2 : 3);
}

// One CTA per (tile, tile row); G groups of P threads walk the tile's
// columns g, g + G, ...  On a diagonal tile of a symmetric launch the pairs
// are symmetric (C - D, the scale product and the epilogue commute), so the
// CTA of row r takes only columns c >= r and writes each value twice.
template <int P, int E, int G>
__global__ void __launch_bounds__(P * G, min_ctas(P, E, G))
kendall_merge_kernel(const Args a) {
  constexpr int T = P * G;
  constexpr int WARPS = P / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned red[2][WARPS][2];
  const int tid = threadIdx.x;
  long long jt = a.j_start + (long long)blockIdx.x;
  const long long total = tile_total(a.m, a.grid_cols);
  if (jt > total - 1) jt = total - 1;
  int yt, xt;
  tile_coord(a.m, a.grid_cols, jt, &yt, &xt);
  const int t = a.t, l = a.l, ld = a.ld;
  const size_t gi = (size_t)yt * t + blockIdx.y;
  float* dst_row = a.out + ((size_t)blockIdx.x * t + blockIdx.y) * t;
  const size_t col0 = (size_t)xt * t;
  const int n0 = l * (l - 1) / 2;
  const int n1 = a.ties_r[gi];
  const float sr = a.tau_b ? a.scale_r[gi] : 0.f;
  const bool diag = a.symmetric && a.grid_cols == 0 && yt == xt;
  float* mirror = diag ? a.out + (size_t)blockIdx.x * t * t + blockIdx.y
                       : nullptr;
  const int c0 = diag ? (int)blockIdx.y : 0;  // the first column

  if (n1 == n0) {  // a constant row: every pair is exactly 0
    for (int c = c0 + tid; c < t; c += T)
      put(dst_row, mirror, t, c,
          result(a, 0, sr, a.tau_b ? a.scale_c[col0 + c] : 0.f));
    return;
  }
  const bool row_ties = n1 > 0;
  const bool long_runs = row_ties && a.longest[gi] > SHORT_RUN_MAX;
  uint16_t* ord_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* run_s = ord_s + ld;
  // the tile's column ties and scales, read once when they fit
  int* tie_s = reinterpret_cast<int*>(smem + 4 * (size_t)ld);
  float* scl_s = reinterpret_cast<float*>(tie_s + t);
  const int* ties_c = a.col_smem ? tie_s : a.ties_c + col0;
  const float* scale_c = a.col_smem ? scl_s : a.scale_c + col0;
  stage16(ord_s, a.order + gi * ld, ld, tid, T);
  if (row_ties) stage16(run_s, a.runs + gi * ld, ld, tid, T);
  cp_async_commit();
  for (int c = tid; a.col_smem && c < t; c += T) {
    tie_s[c] = a.ties_c[col0 + c];
    scl_s[c] = a.tau_b ? a.scale_c[col0 + c] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int gw = tid / P, g = tid % P;
  const size_t kb = key_buf_bytes(P * E, E, a.wide);
  unsigned char* base = smem + 4 * (size_t)ld + col_bytes(a.col_smem ? t : 0) +
                        (size_t)gw * (2 * kb + (size_t)a.ncode * 2 * ld);
  void* key_a = base;
  void* key_b = base + kb;
  // code buffer b of the group (0: in the second key buffer)
  uint16_t* const cbuf = a.ncode == 0
                             ? static_cast<uint16_t*>(key_b)
                             : reinterpret_cast<uint16_t*>(base + 2 * kb);
  const int16_t* codes = a.codes + col0 * ld;
  if (a.ncode == 2 && c0 + gw < t) {
    stage16(cbuf, codes + (size_t)(c0 + gw) * ld, ld, g, P);
    cp_async_commit();
  }
  int pending = -1;  // a column whose partial sums wait in red (P > 32)
  for (int c = c0 + gw, it = 0; c < t; c += G, ++it) {
    uint16_t* code_s = cbuf + (a.ncode == 2 ? (it & 1) * ld : 0);
    if (a.ncode == 2) {
      if (c + G < t)
        stage16(cbuf + ((it + 1) & 1) * ld, codes + (size_t)(c + G) * ld,
                ld, g, P);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      group_sync<P>();  // the last column's reads of code_s are done
      stage16(code_s, codes + (size_t)c * ld, ld, g, P);
      cp_async_commit();
      cp_async_wait<0>();
    }
    group_sync<P>();
    if (P > 32 && pending >= 0 && tid == 0)
      put(dst_row, mirror, t, pending,
          value_warps<WARPS>(a, red[pending & 1], ties_c[pending],
                             a.tau_b ? scale_c[pending] : 0.f, n0, n1, sr));
    pending = -1;
    const int n2 = ties_c[c];
    const float sc = a.tau_b ? scale_c[c] : 0.f;
    if (n2 == n0) {  // a constant column
      if (g == 0) put(dst_row, mirror, t, c, result(a, 0, sr, sc));
      continue;
    }
    unsigned s, n3;
    pair_counts<P, E>(ord_s, run_s, code_s, key_a, key_b, l, g, row_ties,
                      long_runs, a.ncode == 0, s, n3);
    warp_sum2(s, n3);
    if (P == 32) {
      if (g == 0)
        put(dst_row, mirror, t, c, value(a, s, n3, n2, sc, n0, n1, sr));
    } else {
      if ((g & 31) == 0) {
        red[c & 1][g >> 5][0] = s;
        red[c & 1][g >> 5][1] = n3;
      }
      pending = c;
    }
  }
  if (P > 32 && pending >= 0) {
    __syncthreads();
    if (tid == 0)
      put(dst_row, mirror, t, pending,
          value_warps<WARPS>(a, red[pending & 1], ties_c[pending],
                             a.tau_b ? scale_c[pending] : 0.f, n0, n1, sr));
  }
}

struct Shape {
  int p, e, groups;
};

// Every instantiation (P, E, groups), in the order geometry() tries them:
// a warp a pair, eight a CTA, up to l = 1,024; then a CTA of 256 threads,
// then of 512 a pair.
#define KM_SHAPES(X)                                                      \
  X(32, 2, 8) X(32, 3, 8) X(32, 4, 8) X(32, 6, 8) X(32, 8, 8)             \
  X(32, 12, 8) X(32, 16, 8) X(32, 24, 8) X(32, 32, 8)                     \
  X(256, 6, 1) X(256, 8, 1) X(256, 10, 1) X(256, 12, 1) X(256, 16, 1)     \
  X(256, 20, 1) X(256, 24, 1)                                             \
  X(512, 16, 1) X(512, 20, 1) X(512, 24, 1) X(512, 28, 1) X(512, 32, 1)
#define KM_SHAPE(P, E, G) {P, E, G},
constexpr Shape SHAPES[] = {KM_SHAPES(KM_SHAPE)};
#undef KM_SHAPE
constexpr int N_SHAPES = sizeof(SHAPES) / sizeof(SHAPES[0]);
static_assert(SHAPES[N_SHAPES - 1].p * SHAPES[N_SHAPES - 1].e == MAX_L,
              "the last instantiation must cover MAX_L");

// The launch at l: the first instantiation with P E >= l, so the smallest
// E of the smallest group that covers l; {0, 0, 0} above MAX_L.
Shape geometry(int l) {
  for (const Shape& s : SHAPES)
    if (s.p * s.e >= l) return s;
  return {0, 0, 0};
}

// (t = 0: the column ties and scales stay in global memory)
size_t smem_bytes(Shape s, int ld, int t, int wide, int ncode) {
  return 4 * (size_t)ld + col_bytes(t) +
         (size_t)s.groups *
             (2 * key_buf_bytes(s.p * s.e, s.e, wide) + (size_t)ncode * 2 * ld);
}

// CTAs an SM whose dynamic shared memory fits (each with its static `red`
// sums and the 1 KB the runtime keeps a CTA).
int ctas_by_smem(size_t smem, int p) {
  return (int)(SM_SMEM / (smem + (size_t)p / 32 * 16 + 1024));
}

// The code buffers (2, 1, then 0: in the second key buffer) of a launch
// beside the columns' t ties and scales: the most that still let the CTAs
// an SM of its register budget fit, else the most that fit at all.
int code_buffers(Shape s, int ld, int t, int wide) {
  for (int n = 2; n >= 0; --n)
    if (ctas_by_smem(smem_bytes(s, ld, t, wide, n), s.p) >=
        min_ctas(s.p, s.e, s.groups))
      return n;
  for (int n = 2; n > 0; --n)
    if (smem_bytes(s, ld, t, wide, n) <= (size_t)MAX_SMEM) return n;
  return 0;
}

// The launch's layout: {code buffers, t staged (0: none)}, the columns'
// arrays staged only when they fit with at least one code buffer or with
// the layout of no buffer at all.
void layout(Shape s, int ld, int t, int wide, int* ncode, int* tcols) {
  *tcols = smem_bytes(s, ld, t, wide, 0) <= (size_t)MAX_SMEM ? t : 0;
  *ncode = code_buffers(s, ld, *tcols, wide);
}

using Kernel = void (*)(const Args);

template <int P, int E, int G>
Kernel pick() {
  return kendall_merge_kernel<P, E, G>;
}

Kernel kernel_of(Shape s) {
#define KM_CASE(P, E, G) \
  if (s.p == P && s.e == E) return pick<P, E, G>();
  KM_SHAPES(KM_CASE)
#undef KM_CASE
  return nullptr;
}

int ld_of(int l) { return (l + 7) / 8 * 8; }

}  // namespace

// order, runs: the row operand's (rows, ld) int16 structure; longest its
// rows' longest runs; codes: the column operand's (rows, ld) int16 codes;
// ties_r / ties_c their tie pairs; scale_r / scale_c their tau-b scales
// (read only when tau_b); wide: some row has a run longer than
// SHORT_RUN_MAX (uint32 keys); symmetric: codes / ties_c / scale_c are the
// row operand's own.  grid_cols == 0 selects the triangle.  Returns the
// launch's cudaError_t.
extern "C" int kendall_merge_tiles_launch(
    const int16_t* order, const int16_t* runs, const int* longest,
    const int* ties_r, const float* scale_r, const int16_t* codes,
    const int* ties_c, const float* scale_c, float* out, long long j_start,
    int pass_tiles, int m, int grid_cols, int t, int l, int ld, int tau_b,
    int wide, int symmetric, int has_div, float recip, int has_clip,
    float lo, float hi, void* stream) {
  const Shape s = geometry(l);
  if (pass_tiles <= 0 || m <= 0 || grid_cols < 0 || t <= 0 || t > 65535 ||
      l < 2 || l > MAX_L || ld != ld_of(l) || j_start < 0 || s.p == 0 ||
      (tau_b && (scale_r == nullptr || scale_c == nullptr)))
    return (int)cudaErrorInvalidValue;
  int ncode, tcols;
  layout(s, ld, t, wide, &ncode, &tcols);
  const size_t smem = smem_bytes(s, ld, tcols, wide, ncode);
  const Kernel kernel = kernel_of(s);
  if (kernel == nullptr || smem > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Args a{order,   runs,      longest, ties_r,    scale_r, codes,
               ties_c,  scale_c,   out,     j_start,   m,       grid_cols,
               t,       l,         ld,      tau_b,     wide,    symmetric,
               ncode,   tcols > 0, has_div, recip,     has_clip, lo,
               hi};
  const dim3 grid((unsigned)pass_tiles, (unsigned)t);
  kernel<<<grid, s.p * s.groups, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The shape a launch at l with tiles of t takes: out[0..7] = P, E, groups,
// code buffers, dynamic shared memory bytes, CTAs an SM (the occupancy
// calculator), registers a thread, static shared memory bytes.  Returns a
// cudaError_t.
extern "C" int kendall_merge_occupancy(int l, int t, int wide, int* out) {
  const Shape s = geometry(l);
  const Kernel kernel = l >= 2 && t > 0 ? kernel_of(s) : nullptr;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int ld = ld_of(l);
  int ncode, tcols;
  layout(s, ld, t, wide, &ncode, &tcols);
  const size_t smem = smem_bytes(s, ld, tcols, wide, ncode);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    s.p * s.groups, smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = s.p;
  out[1] = s.e;
  out[2] = s.groups;
  out[3] = ncode;
  out[4] = (int)smem;
  out[5] = blocks;
  out[6] = attr.numRegs;
  out[7] = (int)attr.sharedSizeBytes;
  return 0;
}

// The kernel's instantiations: out[3 k], out[3 k + 1], out[3 k + 2] = P, E
// and groups of the k-th, in the order a launch tries them, for the first
// `cap`.  Returns how many there are.
extern "C" int kendall_merge_instantiations(int* out, int cap) {
  for (int k = 0; k < N_SHAPES && k < cap; ++k) {
    out[3 * k] = SHAPES[k].p;
    out[3 * k + 1] = SHAPES[k].e;
    out[3 * k + 2] = SHAPES[k].groups;
  }
  return N_SHAPES;
}

extern "C" const char* kendall_merge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
