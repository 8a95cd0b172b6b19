// cp.async (sm_80+) copies from global into shared memory, shared by the
// SIMT mainloops (pcc_sgemm.cuh, flash_attention.cu): a copy lands in
// shared memory without passing through registers, and a thread waits for
// its own groups of copies with cp_async_wait.  A src-size of 0 copies
// nothing and zero-fills the destination (the source address is not read,
// but must still be a valid global address).

#pragma once

#include <stdint.h>

namespace pcc {

// 4-byte copies: the second zero-fills (src-size 0) when `in` is false.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// 16-byte copies (dst and src 16-byte aligned), bypassing L1; the second
// zero-fills when `in` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace pcc
