// Hopper's bulk copies for the streaming kernels: cp.async.bulk (the TMA's
// one-dimensional form) from device memory into shared memory, its completion
// counted in bytes on an mbarrier in shared memory. K10c (hbm_stream.cu) and
// K9b's first pass over A's row bands (bcsr_matvec.cu) keep a ring of such
// copies in flight a CTA.
//
// The protocol, for a ring of `depth` slots each with its own barrier:
//   * one thread initialises the barriers (an arrival count of 1 each), then
//     bulk_init_fence() makes that visible to the copy engine;
//   * bulk_load() arrives on the slot's barrier announcing `bytes` and starts
//     the copy; the barrier's phase completes when all the bytes have landed;
//   * every thread that reads the slot waits with bulk_wait() on the phase's
//     parity (use t / depth & 1 for the t-th copy into a slot);
//   * after a __syncthreads() that ends the last read of the slot, the thread
//     that refills it calls bulk_reuse_fence() first, so the generic-proxy
//     reads are ordered before the async-proxy write of the next copy.
// A copy needs 16-byte aligned source and destination and a byte count that is
// a multiple of 16.

#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1)
               : "memory");
}

__device__ __forceinline__ void bulk_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.b32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_reuse_fence() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace
