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
// Inputs (kernels/kendall_merge.py rank_structure, int32, (rows, l)): the
// row operand's `order` (each row's stable argsort) and `runs` (the run
// index of each sorted position: equal values share one), the column
// operand's `codes` (each value's dense rank, so ties and order are kept),
// and each side's tie pairs n1 / n2 and tau-b scales.  A row whose tie
// pairs are n0 is constant: by Knight's identity (n1 = n0, n3 = n2, S = 0)
// its every pair is exactly 0, and so is every pair of a constant column;
// those pairs skip the count (the padding rows are such rows).
//
// What bounds it: the count is integer compares and shared-memory traffic,
// no floating point.  The least work the data needs is a sort of the l
// keys of each pair of non-constant rows, l log2(l) compares, plus for a
// row with ties the sort of each of its tie runs (c log2(c) a run of c),
// over the card's 32-bit integer rate (64 lanes an SM, 132 SMs); its bytes
// (ranks in once, tiles out once) are ~1,000x fewer at l = 5,072.  This
// kernel does more than that: its merge levels span the power-of-two pad,
// l_p2 log2(l_p2) a pair (l_p2 the next power of two of l), and a row with
// ties runs them twice, the lexsort over all l keys and then the count.
//
// Design: one CTA of 256 threads per (tile, tile row i) holds row i's order
// and runs in shared memory as uint16 and walks the tile's t columns.  For
// column j it stages the column's codes, then gathers the keys in row i's
// order: the code q, or (run << 16) | q when row i has ties.  A row with
// ties first sorts those keys (bottom-up merge levels, below): that is the
// lexsort by (x, y); n3 is then the sum over runs of equal keys of C(c, 2)
// (each element counts the equal keys before it, found by a binary search
// in the sorted keys), and the keys drop to q.  Then the same merge levels
// sort q and count inversions.  A merge level is a merge-path merge: the
// 256 threads each write E = l_p2 / 256 consecutive outputs, find where
// their run starts in the left and right blocks by one binary search (the
// co-rank), and merge sequentially with ties to the left, so that each
// right element taken adds the left elements still waiting, all strictly
// greater (the reference's searchsorted side="right").  The tail past l
// holds sentinels (0xffffffff, above every key), which only ever meet
// all-sentinel right blocks and add nothing.  Buffers hold one pad word
// every 32 keys, so the threads' consecutive outputs fall in distinct
// banks.  Counts add up per thread, then across the CTA by warp shuffles.
// Shared memory at l = 5,072 (l_p2 = 8,192): 87,884 bytes, two CTAs an SM;
// the limit is l <= 16,384 (200,716 bytes), which the wrapper enforces.

#include "pcc_accum.cuh"

namespace {

using namespace pcc;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr uint32_t SENTINEL = 0xffffffffu;
constexpr int MAX_LP2 = 16384;

// A buffer index with one pad word every 32: consecutive runs of E outputs
// a thread start in distinct banks.
__device__ __forceinline__ int phys(int x) { return x + (x >> 5); }

// One bottom-up merge level over keys sorted in blocks of `blk`: the pairs
// of blocks (L, R) at [p, p + blk) and [p + blk, p + 2 blk) merge into dst,
// ties to L.  This thread writes outputs [o, end).  Returns, when COUNT, the
// number of strict inversions its outputs close: each R element taken adds
// the L elements not yet taken, all of them strictly greater.  Reads may
// touch one word past a block pair's end (a value then unused), which the
// allocation holds.
template <bool COUNT>
__device__ __forceinline__ unsigned merge_level(const uint32_t* src,
                                                uint32_t* dst, int blk, int o,
                                                int end) {
  unsigned inv = 0;
  const int span = blk << 1;
  while (o < end) {
    const int p = o & ~(span - 1);
    const int d = o - p;
    const int stop = min(end, p + span);
    // co-rank: how many of the first d outputs come from L
    int lo = max(0, d - blk), hi = min(d, blk);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (src[phys(p + mid)] <= src[phys(p + blk + d - mid - 1)])
        lo = mid + 1;
      else
        hi = mid;
    }
    int i = lo, j = d - lo;
    uint32_t a = src[phys(p + i)];
    uint32_t b = src[phys(p + blk + j)];
    for (; o < stop; ++o) {
      const bool take_l = j >= blk || (i < blk && a <= b);
      dst[phys(o)] = take_l ? a : b;
      if (COUNT && !take_l) inv += blk - i;
      if (take_l) ++i; else ++j;
      const uint32_t next = src[phys(take_l ? p + i : p + blk + j)];
      if (take_l) a = next; else b = next;
    }
  }
  return inv;
}

// Every level, 1 .. lp2 / 2: the sorted keys end in *src.
template <bool COUNT>
__device__ __forceinline__ unsigned merge_sort(uint32_t*& src, uint32_t*& dst,
                                               int lp2, int o, int e) {
  unsigned inv = 0;
  for (int blk = 1; blk < lp2; blk <<= 1) {
    if (o < lp2) inv += merge_level<COUNT>(src, dst, blk, o, o + e);
    __syncthreads();
    uint32_t* tmp = src;
    src = dst;
    dst = tmp;
  }
  return inv;
}

// CTA sums of a and b, valid in thread 0.
__device__ __forceinline__ void block_sum2(unsigned& a, unsigned& b,
                                           unsigned* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red[2 * (threadIdx.x >> 5)] = a;
    red[2 * (threadIdx.x >> 5) + 1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = b = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += red[2 * w];
      b += red[2 * w + 1];
    }
  }
}

template <bool TAU_B>
__global__ void __launch_bounds__(THREADS, 2)
kendall_merge_kernel(const int* __restrict__ order,
                     const int* __restrict__ runs,
                     const int* __restrict__ ties_r,
                     const float* __restrict__ scale_r,
                     const int* __restrict__ codes,
                     const int* __restrict__ ties_c,
                     const float* __restrict__ scale_c,
                     float* __restrict__ out, long long j_start, int m,
                     int grid_cols, int t, int l, int lp2, int has_div,
                     float recip, int has_clip, float lo, float hi) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ unsigned red[2 * WARPS];
  const int bufw = phys(lp2) + 1;
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + bufw;
  uint16_t* ord_s = reinterpret_cast<uint16_t*>(smem + 2 * bufw + 1);
  uint16_t* run_s = ord_s + l;

  long long jt = j_start + (long long)blockIdx.x;
  const long long total = tile_total(m, grid_cols);
  if (jt > total - 1) jt = total - 1;
  int yt, xt;
  tile_coord(m, grid_cols, jt, &yt, &xt);
  const size_t gi = (size_t)yt * t + blockIdx.y;
  float* dst_row = out + ((size_t)blockIdx.x * t + blockIdx.y) * t;
  const size_t col0 = (size_t)xt * t;
  const int n0 = l * (l - 1) / 2;
  const int n1 = ties_r[gi];
  const float sr = TAU_B ? scale_r[gi] : 0.f;

  if (n1 == n0) {  // a constant row: every pair is exactly 0
    for (int c = threadIdx.x; c < t; c += THREADS)
      dst_row[c] = finalize<TAU_B>(0.f, sr, TAU_B ? scale_c[col0 + c] : 0.f,
                                   has_div, recip, has_clip, lo, hi);
    return;
  }
  const bool row_ties = n1 > 0;
  for (int k = threadIdx.x; k < l; k += THREADS) {
    ord_s[k] = (uint16_t)order[gi * l + k];
    if (row_ties) run_s[k] = (uint16_t)runs[gi * l + k];
  }
  const int e = lp2 >= THREADS ? lp2 / THREADS : 1;
  const int o = threadIdx.x * e;
  // the column's codes are staged in buf1, which the first level then
  // overwrites
  uint16_t* code_s = reinterpret_cast<uint16_t*>(buf1);

  for (int c = 0; c < t; ++c) {
    const int n2 = ties_c[col0 + c];
    const float sc = TAU_B ? scale_c[col0 + c] : 0.f;
    if (n2 == n0) {  // a constant column
      if (threadIdx.x == 0)
        dst_row[c] = finalize<TAU_B>(0.f, sr, sc, has_div, recip, has_clip,
                                     lo, hi);
      continue;
    }
    const int* col = codes + (col0 + c) * l;
    for (int k = threadIdx.x; k < l; k += THREADS) code_s[k] = (uint16_t)col[k];
    __syncthreads();
    for (int k = threadIdx.x; k < lp2; k += THREADS) {
      uint32_t key = SENTINEL;
      if (k < l) {
        key = code_s[ord_s[k]];
        if (row_ties) key |= (uint32_t)run_s[k] << 16;
      }
      buf0[phys(k)] = key;
    }
    __syncthreads();
    uint32_t* src = buf0;
    uint32_t* dst = buf1;
    unsigned n3 = 0;
    if (row_ties) {
      // the lexsort by (x, y): keys (run, q) sorted, so q ascends within
      // each run of x
      merge_sort<false>(src, dst, lp2, o, e);
      for (int k = threadIdx.x; k < lp2; k += THREADS) {
        const uint32_t key = src[phys(k)];
        if (k > 0 && k < l && key == src[phys(k - 1)]) {
          // the equal keys before k: k minus the first position of its run
          int a = 0, b = k - 1;
          while (a < b) {
            const int mid = (a + b) >> 1;
            if (src[phys(mid)] < key) a = mid + 1; else b = mid;
          }
          n3 += k - a;
        }
        dst[phys(k)] = k < l ? (key & 0xffffu) : SENTINEL;
      }
      __syncthreads();
      uint32_t* tmp = src;
      src = dst;
      dst = tmp;
    }
    unsigned s = merge_sort<true>(src, dst, lp2, o, e);
    block_sum2(n3, s, red);
    if (threadIdx.x == 0) {
      const int cmd = n0 - n1 - n2 + (int)n3 - 2 * (int)s;
      dst_row[c] = finalize<TAU_B>((float)cmd, sr, sc, has_div, recip,
                                   has_clip, lo, hi);
    }
  }
}

size_t smem_bytes(int l, int lp2) {
  return sizeof(uint32_t) * (2 * (size_t)(lp2 + (lp2 >> 5) + 1) + 1) +
         2 * sizeof(uint16_t) * (size_t)l;
}

}  // namespace

// order, runs: the row operand's (rows, l) int32 structure; codes: the
// column operand's; ties_r / ties_c their tie pairs; scale_r / scale_c their
// tau-b scales (read only when tau_b).  grid_cols == 0 selects the
// triangle.  Returns the launch's cudaError_t.
extern "C" int kendall_merge_tiles_launch(
    const int* order, const int* runs, const int* ties_r,
    const float* scale_r, const int* codes, const int* ties_c,
    const float* scale_c, float* out, long long j_start, int pass_tiles,
    int m, int grid_cols, int t, int l, int tau_b, int has_div, float recip,
    int has_clip, float lo, float hi, void* stream) {
  int lp2 = 1;
  while (lp2 < l) lp2 <<= 1;
  if (pass_tiles <= 0 || m <= 0 || grid_cols < 0 || t <= 0 || t > 65535 ||
      l < 2 || lp2 > MAX_LP2 || j_start < 0 ||
      (tau_b && (scale_r == nullptr || scale_c == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(l, lp2);
  const auto kernel = tau_b ? kendall_merge_kernel<true>
                            : kendall_merge_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)pass_tiles, (unsigned)t);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      order, runs, ties_r, scale_r, codes, ties_c, scale_c, out, j_start, m,
      grid_cols, t, l, lp2, has_div, recip, has_clip, lo, hi);
  return (int)cudaGetLastError();
}

extern "C" const char* kendall_merge_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
