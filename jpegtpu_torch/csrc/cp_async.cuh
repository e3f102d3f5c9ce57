// Asynchronous copies from global to shared memory (cp.async, sm_80+): a
// thread issues a tile's loads without holding them in registers, and
// waits for them when it needs the tile. A copy of fewer source bytes
// than its size fills the rest with zeros (and reads nothing at 0).
#pragma once

// 4 bytes, both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
