// Asynchronous copies into a shared-memory ring, shared by K0
// (block_matvec.cu) and K0m (block_matmat.cu), and the persistent grid,
// which K1 (khat_matvec.cu) and K8 (segment_sum.cu) use as well.
//
// A ring is S slots of shared memory.  Each thread issues its share of a
// stage's copies with cp.async (global -> shared without passing through
// registers), commits them as one group, and before computing on stage k
// waits until at most S - 2 of its groups are pending; a __syncthreads then
// makes every thread's copies of stage k visible to the block and tells the
// block that the slot of stage k - 1 is free to refill.  So S - 1 stages are
// in flight while the block computes on one.
//
// A copy is 16 bytes where the source rows are 16-byte aligned, else one
// value (4 or 8 bytes).  A copy past the last element is issued with a
// source size of 0, which fills its destination with zeros and reads
// nothing.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace fcvm_ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy kBytes (4, 8 or 16) from src to the shared address dst; when !valid
// nothing is read (src must still be a valid address) and dst is zeroed.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "cp.async copies 4, 8 or 16 bytes");
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(kBytes), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

constexpr int kMaxDevices = 64;

// Blocks of `kernel` resident on the current device at once, with `threads`
// threads and `smem` bytes of dynamic shared memory (the kernel's limit is
// set to `smem` first): its SM count times the blocks an SM holds by the
// kernel's registers and shared memory.  Returns a cudaError_t (0 = ok).
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = sms * per_sm;
  return 0;
}

// Blocks of a persistent launch of `kernel`: as many as fit on the current
// device at once (resident_blocks), and no more than `units` of work.  The
// first launch on a device keeps the count in resident[device] (the
// caller's, one array a kernel of fixed threads and shared memory).
// Returns a cudaError_t (0 = ok).
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, int smem, long long units, int* resident,
                    int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    const int failed = resident_blocks(kernel, threads, smem, resident + dev);
    if (failed != 0) return failed;
  }
  *grid = static_cast<int>(units < resident[dev] ? units : resident[dev]);
  return 0;
}

}  // namespace fcvm_ring
