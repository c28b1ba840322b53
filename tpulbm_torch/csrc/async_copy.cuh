// Asynchronous global-to-shared copies (cp.async, sm_80 and later), for the
// window loads of K4 (kstep_tile.cu) and K6 (ring_p2p.cu). A thread's copies
// land in groups: commit closes the group of the copies issued since the
// last commit, and wait<N> returns once at most N of this thread's groups
// are in flight. Other threads see the data only after a barrier that
// follows the wait, or after the phase of an mbarrier (below) that the
// copies arrive on.
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

// Shared-memory mbarriers (sm_90): a phase completes once its count of
// arrivals is in; waiters name the phase by its parity.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(
          smem_u32(b))
      : "memory");
}

// An arrive on b once every cp.async this thread issued before has landed
// (the pending count is raised now and lowered then).
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* b) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ bool mbar_test(unsigned long long* b, int parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], "
      "%2;\n selp.u32 %0, 1, 0, p;\n}"
      : "=r"(ok)
      : "r"(smem_u32(b)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(unsigned long long* b, int parity) {
  unsigned ok;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, "
        "[%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!ok);
}

}  // namespace tpulbm
