// K0p and Kbw: the bandwidth probe's two kernels, for Hopper (sm_90a).
//
// K0p, soa_matvec, replaces the Pallas TPU kernel tools/bw_probe.py::soa_matvec
// (body _kern, tools/bw_probe.py:99-119).  It computes
//
//     out[i, e] = sum_j esm_t[i, j, e] * ue_t[j, e]
//
// with esm_t (30, 30, ne), ue_t (30, ne), out (30, ne), float32, contiguous,
// ne a multiple of the tile.  It is K0's contraction in the probe's own tiling.
// What bounds it: like K0, reading esm_t once (two flops per eight bytes), so
// device-memory bandwidth.  The design mirrors the Pallas grid: one thread
// block per tile of `tile` elements (ne / tile blocks; 128 at the probe's
// ne = 131072 and tile 1024), neighbouring threads on neighbouring elements,
// so every (i, j) row of a tile is a coalesced load; a thread keeps its
// element's 30 ue values in registers.  The probe asks whether this grid, with
// fewer and larger blocks than K0's flat one, reads the same bytes faster.
//
// Kbw, bw_read, replaces the Pallas TPU kernel tools/bw_probe.py::make_bw_kernel
// (its run and body kern, tools/bw_probe.py:137-178): a read of x (rows, 128)
// float32 in chunks of chunk_rows rows with k copies in flight, returning
// (8, 128) filled with sum_c x[c * chunk_rows, 0].
// What bounds it: nothing but device-memory reads; it exists to measure them.
// Every byte of x is copied into shared memory with 1-D bulk asynchronous
// copies (cp.async.bulk ... mbarrier::complete_tx::bytes, the counterpart of
// pltpu.make_async_copy and a DMA semaphore) into a ring of k slots, one
// mbarrier per slot.  The TPU kernel is one program on one core; one block
// cannot fill an H100, so a grid of persistent blocks (one per SM) each takes a
// contiguous range of the copies.  A 1 MiB chunk does not fit in 227 KB of
// shared memory, so chunks are cut into sub-copies of at most 16 KiB; k counts
// the sub-copies each block keeps in flight.  After the wait on a sub-copy that
// starts a chunk, the block adds the slot's first value.  The per-block
// partial sums are added in block order by a second small kernel: no float
// atomics, so the result does not depend on the order in which blocks run.
//
// C interface: each launcher returns cudaGetLastError() after its launches
// (0 = launched).  The caller owns all memory and the stream; nothing here
// synchronises.  csrc/ops.cpp binds them as torch.ops.fcvm.soa_matvec and
// torch.ops.fcvm.bw_read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDofs = 30;
constexpr int kMaxThreads = 1024;     // soa_matvec: threads per block
constexpr int kRowBytes = 128 * 4;    // one row of x
constexpr int kSubRowsMax = 32;       // 32 rows = 16 KiB, the largest sub-copy
constexpr int kMaxBufs = 8;           // slots of the ring
constexpr int kFinishThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
soa_matvec_kernel(const float* __restrict__ esm_t, const float* __restrict__ ue_t,
                  float* __restrict__ out, long long ne, int tile) {
  const long long base = static_cast<long long>(blockIdx.x) * tile;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    const long long e = base + t;
    float u[kDofs];
#pragma unroll
    for (int j = 0; j < kDofs; ++j) u[j] = ue_t[j * ne + e];
    for (int i = 0; i < kDofs; ++i) {
      const float* row = esm_t + static_cast<long long>(i) * kDofs * ne + e;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kDofs; ++j) acc += row[j * ne] * u[j];
      out[i * ne + e] = acc;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// One arrival that also announces `bytes` of asynchronous copy to the slot.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
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

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread per block issues and waits; the copy engine moves the bytes.
__global__ void __launch_bounds__(32)
bw_read_kernel(const float* __restrict__ x, float* __restrict__ partial,
               long long nsub_total, int subs_per_chunk, int sub_bytes, int k) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kMaxBufs];
  if (threadIdx.x != 0) return;
  const long long s0 = nsub_total * blockIdx.x / gridDim.x;
  const long long s1 = nsub_total * (blockIdx.x + 1) / gridDim.x;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(x);
  for (int s = 0; s < k; ++s) mbar_init(&bars[s], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  for (long long j = s0; j < s1 && j < s0 + k; ++j) {
    const int s = static_cast<int>((j - s0) % k);
    mbar_expect_tx(&bars[s], sub_bytes);
    bulk_copy_g2s(ring + s * sub_bytes, src + j * sub_bytes, sub_bytes, &bars[s]);
  }
  float acc = 0.0f;
  for (long long j = s0; j < s1; ++j) {
    const long long n = j - s0;
    const int s = static_cast<int>(n % k);
    mbar_wait(&bars[s], static_cast<uint32_t>((n / k) & 1));
    const bool chunk_start = (j % subs_per_chunk) == 0;
    if (chunk_start) acc += *reinterpret_cast<const float*>(ring + s * sub_bytes);
    if (j + k < s1) {
      // the slot was read through the generic proxy; order that read before
      // the asynchronous copy that refills it
      if (chunk_start) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(&bars[s], sub_bytes);
      bulk_copy_g2s(ring + s * sub_bytes, src + (j + k) * sub_bytes, sub_bytes, &bars[s]);
    }
  }
  partial[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kFinishThreads)
bw_read_finish(const float* __restrict__ partial, int nblocks, float* __restrict__ out) {
  __shared__ float total;
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b) s += partial[b];
    total = s;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 8 * 128; t += blockDim.x) out[t] = total;
}

long long gcd_ll(long long a, long long b) {
  while (b != 0) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

extern "C" int fcvm_soa_matvec_f32(const float* esm_t, const float* ue_t, float* out,
                                   long long ne, int tile, void* stream) {
  if (ne <= 0) return 0;
  if (tile <= 0 || ne % tile != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nblk = ne / tile;
  if (nblk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = tile < kMaxThreads ? tile : kMaxThreads;
  soa_matvec_kernel<<<static_cast<unsigned>(nblk), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(esm_t, ue_t, out, ne, tile);
  return static_cast<int>(cudaGetLastError());
}

// Blocks bw_read launches on `device`: one per SM, and no more than sub-copies.
extern "C" int fcvm_bw_read_blocks(long long rows, long long chunk_rows, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return -1;
  const long long nsub = rows / gcd_ll(chunk_rows, kSubRowsMax);
  return static_cast<int>(nsub < sms ? nsub : sms);
}

extern "C" int fcvm_bw_read_f32(const float* x, float* partial, float* out, long long rows,
                                long long chunk_rows, int k, int nblocks, void* stream) {
  if (rows <= 0 || chunk_rows <= 0 || rows % chunk_rows != 0 || k < 1 || k > kMaxBufs ||
      nblocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long sub_rows = gcd_ll(chunk_rows, kSubRowsMax);
  const int sub_bytes = static_cast<int>(sub_rows * kRowBytes);
  const int subs_per_chunk = static_cast<int>(chunk_rows / sub_rows);
  const long long nsub_total = rows / sub_rows;
  const int smem = k * sub_bytes;
  cudaError_t err = cudaFuncSetAttribute(bw_read_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bw_read_kernel<<<nblocks, 32, smem, s>>>(x, partial, nsub_total, subs_per_chunk, sub_bytes, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bw_read_finish<<<1, kFinishThreads, 0, s>>>(partial, nblocks, out);
  return static_cast<int>(cudaGetLastError());
}
