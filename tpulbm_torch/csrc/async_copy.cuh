// Asynchronous global-to-shared copies (cp.async, sm_80 and later), for the
// window loads of K4 (kstep_tile.cu). A thread's copies land in groups:
// commit closes the group of the copies issued since the last commit, and
// wait<N> returns once at most N of this thread's groups are in flight.
// Other threads see the data only after a barrier that follows the wait.
#pragma once

#include <cuda_runtime.h>

namespace tpulbm {

// 16 bytes, both addresses 16-byte aligned; cached in L2 only.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4 bytes, both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tpulbm
