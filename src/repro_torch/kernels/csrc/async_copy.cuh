// Asynchronous global -> shared copies (cp.async, sm_80 and later) shared
// by the port's kernels (paged_attention.cu, kv_sketch.cu,
// count_sketch.cu).  A thread
// issues copies, closes them into a group with cp_async_commit, and
// cp_async_wait<N> returns once all but its N most recent groups have
// landed; a __syncthreads after it makes every thread's copies visible.
#pragma once

#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only; both addresses 16-byte aligned.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// N = 4, 8 or 16 bytes, both addresses N-byte aligned; when ``ok`` is
// false nothing is read and the N bytes of dst are zero-filled.
template <int N>
__device__ __forceinline__ void copy_or_zero(void* dst, const void* src,
                                             bool ok) {
  static_assert(N == 4 || N == 8 || N == 16, "cp.async copies 4, 8 or 16 B");
  const int n = ok ? N : 0;
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(n));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace async_copy
