// Hopper (sm_90a) building blocks shared by the tensor-core kernels: TMA
// tensor maps and loads, mbarriers and their rings, wgmma shared-memory
// descriptors and the wgmma instructions (bf16 / fp16 k16, fp8 e4m3 / e5m2
// and int8 k32) with their fence / commit / wait.
//
// Layout these helpers assume.  A tile of 16-bit values with a head (or
// depth) dimension DP is kept in shared memory as DP / 64 panels (8-bit
// values: DP / 128 panels of 128 columns); panel p
// holds columns 64 p .. 64 p + 63 of every row, one row per 128 bytes, in
// the 128-byte swizzle that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B (the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8)).  Every panel starts
// on a 1024-byte boundary, the swizzle's period, so a descriptor may start
// 32 bytes (16 values of depth) into a row and the hardware still finds the
// swizzled chunks by their absolute address.
//   * K-major operand (rows = M or N, depth contiguous: Q and K of
//     attention, both operands of the correlation tiles): descriptor at
//     panel + 32 kk bytes for depth step kk (16 values of 16 bits, or 32 of
//     8 bits), SBO = 1024 (eight rows), LBO unused.  fp8 and int8 wgmma
//     take only K-major operands.
//   * MN-major operand (rows = depth, N contiguous: V of attention, where
//     the product runs over keys): descriptor at panel 0 + 2048 kk bytes for
//     the 16-key step kk, SBO = 1024 (eight keys), LBO = the panel stride
//     (the next 64 columns of N).
// Accumulators of wgmma.m64nNk16 (float32): thread t of the warpgroup, warp
// w = t / 32, lane g = (t % 32) / 4, c = t % 4, holds for each 8-column
// chunk j: d[4 j] and d[4 j + 1] at row 16 w + g, columns 8 j + 2 c and
// 8 j + 2 c + 1, and d[4 j + 2], d[4 j + 3] at row 16 w + g + 8.  A
// register A operand (16-bit) for depth step kk is the four 32-bit pairs
// (d[8 kk], d[8 kk + 1]) .. (d[8 kk + 6], d[8 kk + 7]) of such a layout,
// so a product's accumulator feeds the next product without moving.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so that a
// library needs no -lcuda.  Null if the driver does not offer it.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map over an array of `elem`-byte values, d0 contiguous, d1 rows
// of d0 values, d2 planes `stride2` values apart, read in boxes of one
// 128-byte swizzle row (128 / elem values) x box1 rows x 1 plane; elements
// outside the array read as zero.  d0 * elem and stride2 * elem must be
// multiples of 16 and base 16-byte aligned.  Returns the CUresult of
// cuTensorMapEncodeTiled, or CUDA_ERROR_NOT_FOUND without the entry point.
inline CUresult encode_3d(CUtensorMap* map, CUtensorMapDataType type,
                          uint32_t elem, const void* base, uint64_t d0,
                          uint64_t d1, uint64_t d2, uint64_t stride2,
                          uint32_t box1) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem, stride2 * elem};
  const cuuint32_t box[3] = {128 / elem, box1, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The same over a contiguous row-major (d2, d1, d0) array of 16-bit values,
// in boxes of 64 x box1 x 1.
inline CUresult encode_3d_sw128(CUtensorMap* map, CUtensorMapDataType type,
                                const void* base, uint64_t d0, uint64_t d1,
                                uint64_t d2, uint32_t box1) {
  return encode_3d(map, type, 2, base, d0, d1, d2, d0 * d1, box1);
}

template <typename T>
struct MapType;
template <>
struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct MapType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};
// TMA moves fp8 codes as bytes; only wgmma reads them as e4m3 / e5m2.
template <>
struct MapType<__nv_fp8_e4m3> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
template <>
struct MapType<__nv_fp8_e5m2> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
// int8 moves as bytes too; wgmma reads it as s8.
template <>
struct MapType<int8_t> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// ---- device: mbarriers and TMA --------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive once and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D map at (c0, c1, c2) into dst; completes on bar.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// A ring of STAGES shared-memory slots, each with a full barrier (the
// producer's TMA bytes arrived) and an empty barrier (every consumer thread
// released it): slot i % STAGES and the parity of round i / STAGES for the
// i-th load.
template <int STAGES>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ void wait_full(int i) const {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
  }
  __device__ __forceinline__ void wait_empty(int i) const {
    mbar_wait(&empty[i % STAGES], ((i / STAGES) & 1) ^ 1);
  }
  __device__ __forceinline__ void release(int i) const {
    mbar_arrive(&empty[i % STAGES]);
  }
};

// Named barrier `id` (1 .. 15; 0 is __syncthreads) over n threads: sync
// waits for the phase to complete, arrive counts without waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Move registers between warpgroups: every warp of a warpgroup executes one
// of these at the same point; the counts are multiples of 8 in [24, 256].
template <int R>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- device: wgmma --------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Register lists of an m64nN float32 accumulator d[0 .. N/2 - 1].
#define SM90_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define SM90_D64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define SM90_D128                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "      \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "      \
  "%122, %123, %124, %125, %126, %127}"
#define SM90_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SM90_F16(i) SM90_F4(i), SM90_F4(i + 4), SM90_F4(i + 8), SM90_F4(i + 12)
#define SM90_F32(i) SM90_F16(i), SM90_F16(i + 16)
#define SM90_F64(i) SM90_F32(i), SM90_F32(i + 32)
#define SM90_F128(i) SM90_F64(i), SM90_F64(i + 64)

// Wgmma<N, T>::ss: d (64 x N) (+)= A (64 x K) B (K x N), A and B from
// shared memory, both K-major; K = 16 for bf16 / fp16, 32 for fp8.  ::rs
// (16-bit types): the same with A from registers (16-bit pairs, layout
// above) and B MN-major.  acc == 0 overwrites d.
template <int N, typename T>
struct Wgmma;

#define SM90_WGMMA(N, T, TY, DREGS, DCONS, SS_OPS, SS_P, RS_OPS, RS_P)       \
  template <>                                                              \
  struct Wgmma<N, T> {                                                     \
    static constexpr int K = 16;                                           \
    __device__ __forceinline__ static void ss(float* d, uint64_t a,        \
                                              uint64_t b, int acc) {       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_P ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY     \
                   "." TY " " DREGS ", " SS_OPS ", p, 1, 1, 0, 0;\n}\n"     \
                   : DCONS                                                 \
                   : "l"(a), "l"(b), "r"(acc));                            \
    }                                                                      \
    __device__ __forceinline__ static void rs(float* d, const uint32_t* a, \
                                              uint64_t b, int acc) {       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_P ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY     \
                   "." TY " " DREGS ", " RS_OPS ", p, 1, 1, 1;\n}\n"        \
                   : DCONS                                                 \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),   \
                     "r"(acc));                                            \
    }                                                                      \
  };

SM90_WGMMA(64, __nv_bfloat16, "bf16", SM90_D32, SM90_F32(0), "%32, %33",
           "%34", "{%32, %33, %34, %35}, %36", "%37")
SM90_WGMMA(64, __half, "f16", SM90_D32, SM90_F32(0), "%32, %33", "%34",
           "{%32, %33, %34, %35}, %36", "%37")
SM90_WGMMA(128, __nv_bfloat16, "bf16", SM90_D64, SM90_F64(0), "%64, %65",
           "%66", "{%64, %65, %66, %67}, %68", "%69")
SM90_WGMMA(128, __half, "f16", SM90_D64, SM90_F64(0), "%64, %65", "%66",
           "{%64, %65, %66, %67}, %68", "%69")
SM90_WGMMA(256, __nv_bfloat16, "bf16", SM90_D128, SM90_F128(0),
           "%128, %129", "%130", "{%128, %129, %130, %131}, %132", "%133")
SM90_WGMMA(256, __half, "f16", SM90_D128, SM90_F128(0), "%128, %129",
           "%130", "{%128, %129, %130, %131}, %132", "%133")

#undef SM90_WGMMA

// fp8: k32, both operands K-major from shared memory (no transpose or
// register-A form).
#define SM90_WGMMA_F8(N, T, TY, DREGS, DCONS, SS_OPS, SS_P)                 \
  template <>                                                              \
  struct Wgmma<N, T> {                                                     \
    static constexpr int K = 32;                                           \
    __device__ __forceinline__ static void ss(float* d, uint64_t a,        \
                                              uint64_t b, int acc) {       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_P ", 0;\n"       \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k32.f32." TY     \
                   "." TY " " DREGS ", " SS_OPS ", p, 1, 1;\n}\n"           \
                   : DCONS                                                 \
                   : "l"(a), "l"(b), "r"(acc));                            \
    }                                                                      \
  };

SM90_WGMMA_F8(128, __nv_fp8_e4m3, "e4m3", SM90_D64, SM90_F64(0), "%64, %65",
              "%66")
SM90_WGMMA_F8(128, __nv_fp8_e5m2, "e5m2", SM90_D64, SM90_F64(0), "%64, %65",
              "%66")

#undef SM90_WGMMA_F8

// int8: k32, both operands K-major from shared memory, int32 accumulators
// (s32 sums of s8 products: exact while they stay inside int32).
#define SM90_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define SM90_R16(i) SM90_R4(i), SM90_R4(i + 4), SM90_R4(i + 8), SM90_R4(i + 12)
#define SM90_R64(i) SM90_R16(i), SM90_R16(i + 16), SM90_R16(i + 32), \
                    SM90_R16(i + 48)

template <>
struct Wgmma<128, int8_t> {
  static constexpr int K = 32;
  __device__ __forceinline__ static void ss(int* d, uint64_t a, uint64_t b,
                                            int acc) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " SM90_D64
                 ", %64, %65, p;\n}\n"
                 : SM90_R64(0)
                 : "l"(a), "l"(b), "r"(acc));
  }
};

// Two float32 values as one 32-bit pair of T, the first in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace sm90
