// Thread-block cluster helpers for kernels that hand partial results from
// every block of a cluster to every other (quantize.cu, histogram.cu).
//
// The exchange used there: each block sets up an mbarrier that completes
// once a known number of bytes has been stored into its shared memory,
// arrives at a cluster barrier (so its mbarrier is ready before any other
// block stores to it), and much later waits on that barrier before it
// stores its partials into the other blocks with st.async (each store
// counts its bytes on the receiver's mbarrier). A block then waits only on
// its own mbarrier: no second cluster barrier, and no block reads another's
// shared memory, so none has to outlive the others.
#pragma once
#include <stdint.h>

namespace dsm {

__device__ __forceinline__ void arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// This block's shared-memory address of p, for the instructions below.
__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The same shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ uint32_t remote(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// One thread, before the block arrives at the cluster barrier: `bar`
// completes its phase 0 once `bytes` have been stored into this block.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  const uint32_t b = smem(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b) : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Store 4 or 16 bytes at the cluster address `to`, counted on the
// receiver's mbarrier at the cluster address `bar`.
__device__ __forceinline__ void st_async(uint32_t to, uint32_t v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
      :: "r"(to), "r"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t to, int4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(to), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// Wait until every expected byte has arrived. A store that never comes is
// a fault in the kernel: trap after about a second rather than hang.
__device__ __forceinline__ void wait_bytes(uint64_t* bar) {
  const uint32_t b = smem(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 31)) __trap();
  }
}

}  // namespace dsm
