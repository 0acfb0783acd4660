// K0: batched 30x30 element-block matvec, element-major, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fcvm_tpu/ops/pallas_kernels.py::block_matvec
// (body _block_matvec_kernel).  It computes
//
//     out[i, e] = sum_j esm_t[i, j, e] * ue_t[j, e]
//
// with esm_t (30, 30, ne), ue_t (30, ne) and out (30, ne), all contiguous.
//
// What bounds it: every block entry is read once and used once (two flops
// per eight bytes in f64, per four in f32), so reading esm_t from device
// memory.  The design keeps that stream in flight and out of the threads'
// way:
//   * a persistent grid (as many blocks as fit on the card at once) walks
//     tiles of 1 KB of each row: 256 elements of f32, 128 of f64, one a
//     thread;
//   * a stage is one output row i of one tile, the 30 rows
//     esm_t[i, :, e0:e0+E]; cp.async copies them into a ring of 3
//     shared-memory slots (csrc/ring.cuh), 16 bytes a copy where every row
//     starts 16-byte aligned (ne a multiple of 4 in f32, 2 in f64) and one
//     value a copy otherwise, so two stages are in flight while the threads
//     sum the third;
//   * a thread keeps its element's 30 ue values in registers for the whole
//     tile, so ue is read once (the earlier design, three blocks of ten rows
//     an element, read it three times);
//   * the blocks take the tiles in groups of gridDim.x, block b tile b of
//     each group, so neighbouring blocks read neighbouring spans of each row
//     at about the same time; the last, partial group is shared out by
//     stages, so no block has more than one stage more than another;
//   * the ragged last tile is zero-filled by the copies and its outputs
//     bounds-checked (the TPU kernel padded to 2048-element VMEM tiles).
// On the H100 it reads at 73-77% of 3.35 TB/s in f32 and 79-85% in f64 at
// the paths' element counts; rows of 2 or 4 KB a copy, 6 slots, or K0p's
// thread over all 30 rows read no faster (PERF.md).
// Each sum runs over j in order 0..29.  Sums accumulate in the input type,
// with FMA; nothing is lowered in precision.
//
// C interface: returns cudaGetLastError() after the launch (0 = launched).
// The caller owns all memory and the stream; the kernel does not synchronise.
// csrc/ops.cpp binds it to PyTorch as torch.ops.fcvm.block_matvec.

#include <cstdint>

#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int kDofs = 30;  // 10 nodes x 3 components per tet10 element

// The ring.  E elements a tile, one a thread; a stage is one output row i of
// one tile, the 30 rows esm_t[i, :, e0:e0+E]; S slots; V elements a copy.
// The blocks take the tiles in groups of gridDim.x, block b tile b of each
// group, so they read neighbouring spans of each row at about the same
// time; the stages of the last, partial group are shared out in contiguous
// ranges, so every block has the same number of stages to within one.
template <typename T, int E, int S, int V>
__global__ void __launch_bounds__(E)
block_matvec_ring_kernel(const T* __restrict__ esm_t, const T* __restrict__ ue_t,
                         T* __restrict__ out, long long ne, long long ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  constexpr int kSlot = kDofs * E;       // one stage: 30 rows of E elements
  constexpr int kCopies = kSlot / V;     // copies a stage
  constexpr int kPerThread = (kCopies + E - 1) / E;
  const long long groups = ntiles / gridDim.x;
  const long long rest = (ntiles - groups * gridDim.x) * kDofs;  // stages after the groups
  const long long r0 = rest * blockIdx.x / gridDim.x;
  const long long nk = groups * kDofs + rest * (blockIdx.x + 1) / gridDim.x - r0;
  const long long rbase = groups * gridDim.x * kDofs + r0 - groups * kDofs;
  // the block's stage k -> tile t, output row i
  auto locate = [&](long long k, long long& t, int& i) {
    if (k < groups * kDofs) {
      const long long g = k / kDofs;
      t = g * gridDim.x + blockIdx.x;
      i = static_cast<int>(k - g * kDofs);
    } else {
      const long long n = rbase + k;
      t = n / kDofs;
      i = static_cast<int>(n - t * kDofs);
    }
  };

  auto issue = [&](long long k) {
    long long t;
    int i;
    locate(k, t, i);
    const long long e0 = t * E;
    const T* rows = esm_t + static_cast<long long>(i) * kDofs * ne + e0;
    T* slot = ring + static_cast<int>(k % S) * kSlot;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int q = threadIdx.x + r * E;
      if (kCopies % E == 0 || q < kCopies) {
        const int j = q / (E / V), c = (q % (E / V)) * V;
        const bool valid = e0 + c < ne;  // V > 1 only when ne % V == 0
        fcvm_ring::cp_async<V * sizeof(T)>(slot + j * E + c,
                                           valid ? rows + j * ne + c : esm_t, valid);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < nk) issue(k);
    fcvm_ring::cp_async_commit();
  }
  T u[kDofs];
  long long tile = -1;
  for (long long k = 0; k < nk; ++k) {
    fcvm_ring::cp_async_wait<S - 2>();
    __syncthreads();
    if (k + S - 1 < nk) issue(k + S - 1);
    fcvm_ring::cp_async_commit();
    long long t;
    int i;
    locate(k, t, i);
    const long long e = t * E + threadIdx.x;
    if (t != tile) {
      tile = t;
      if (e < ne) {
#pragma unroll
        for (int j = 0; j < kDofs; ++j) u[j] = ue_t[j * ne + e];
      }
    }
    const T* slot = ring + static_cast<int>(k % S) * kSlot + threadIdx.x;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kDofs; ++j) acc += slot[j * E] * u[j];
    if (e < ne) out[i * ne + e] = acc;
  }
}

// 1 KB rows a stage (256 elements of f32, 128 of f64), 3 slots; 16-byte
// copies where every row starts 16-byte aligned, else one value a copy.
template <typename T>
int launch(const T* esm_t, const T* ue_t, T* out, long long ne, void* stream) {
  if (ne <= 0) return 0;
  constexpr int kE = 1024 / sizeof(T), kS = 3, kV = 16 / sizeof(T);
  const bool vec = ne % kV == 0 && reinterpret_cast<uintptr_t>(esm_t) % 16 == 0;
  const auto kernel = vec ? block_matvec_ring_kernel<T, kE, kS, kV>
                          : block_matvec_ring_kernel<T, kE, kS, 1>;
  static int resident[2][fcvm_ring::kMaxDevices];
  constexpr int kSmem = kS * kDofs * kE * static_cast<int>(sizeof(T));
  const long long ntiles = (ne + kE - 1) / kE;
  int grid = 0;
  const int err = fcvm_ring::persistent_grid(kernel, kE, kSmem, ntiles * kDofs, resident[vec],
                                             &grid);
  if (err != 0) return err;
  kernel<<<grid, kE, kSmem, static_cast<cudaStream_t>(stream)>>>(esm_t, ue_t, out, ne, ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fcvm_block_matvec_f32(const float* esm_t, const float* ue_t,
                                     float* out, long long ne, void* stream) {
  return launch<float>(esm_t, ue_t, out, ne, stream);
}

extern "C" int fcvm_block_matvec_f64(const double* esm_t, const double* ue_t,
                                     double* out, long long ne, void* stream) {
  return launch<double>(esm_t, ue_t, out, ne, stream);
}
