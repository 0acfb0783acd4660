// Hopper's bulk asynchronous copies (TMA, cp.async.bulk) into shared memory
// and the mbarriers that report them, shared by Kbw (bw_probe.cu), K1
// (khat_matvec.cu), K1m (khat_matmat.cu) and K8's ring (segment_sum.cu).
//
// One thread announces the bytes a copy will deliver to an mbarrier
// (expect_tx) and issues the copy; the copy engine moves them and completes
// the barrier's phase when they have landed.  Waiting threads spin on the
// phase's parity.  Sizes and addresses are multiples of 16 bytes.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace fcvm_bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Make the initialised barriers visible to the asynchronous proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of asynchronous copy to the slot.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One plain arrival.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// Order this thread's earlier generic-proxy accesses to shared memory before
// its later asynchronous copies into it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// An L2 policy that evicts the lines it covers first: for a stream read
// once, so it does not push out data that is read again.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// bulk_copy_g2s with an L2 cache policy.
__device__ __forceinline__ void bulk_copy_g2s_hint(void* dst, const void* src, uint32_t bytes,
                                                   uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// A 2-D box of a tensor (TMA's tiled mode) into shared memory, rows one
// after the other: `tmap` is the generic address of a CUtensorMap (a
// __grid_constant__ kernel parameter), (x, y) the box's first column and
// row.  One request, however many rows the box has.
__device__ __forceinline__ void tensor_copy_2d_g2s(void* dst, const void* tmap, int x, int y,
                                                   uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(tmap), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// tensor_copy_2d_g2s with an L2 cache policy.
__device__ __forceinline__ void tensor_copy_2d_g2s_hint(void* dst, const void* tmap, int x,
                                                        int y, uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n"
      :: "r"(smem_addr(dst)), "l"(tmap), "r"(x), "r"(y), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

}  // namespace fcvm_bulk
