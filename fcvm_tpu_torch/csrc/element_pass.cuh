// The element pass of K0 (block_matvec.cu) and K1 (khat_matvec.cu): the
// batched 30x30 element-block matvec, element-major,
//
//     out[i, e] = sum_j esm_t[i, j, e] * u_e[j]
//
// with esm_t (30, 30, ne) contiguous.  Where the element's 30 values u_e
// come from is the caller's: K0 reads them from a dense (30, ne) array, K1
// gathers them from a dof vector at the element's nodes.  The LoadU functor
// fills them: load_u(e, ne, u).  The Store functor takes each sum:
// store(i, e, ne, sum); DenseStore writes out (30, ne), as K0 and K1 do.
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
//   * a thread keeps its element's 30 values u_e in registers for the whole
//     tile, so they are loaded once;
//   * the blocks take the tiles in groups of gridDim.x, block b tile b of
//     each group, so neighbouring blocks read neighbouring spans of each row
//     at about the same time; the last, partial group is shared out by
//     stages, so no block has more than one stage more than another;
//   * the ragged last tile is zero-filled by the copies and its outputs
//     bounds-checked (the TPU kernel padded to 2048-element VMEM tiles).
// Each sum runs over j in order 0..29.  Sums accumulate in the input type,
// with FMA; nothing is lowered in precision.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "ring.cuh"

namespace fcvm_element {

constexpr int kDofs = 30;  // 10 nodes x 3 components per tet10 element

// out[i, e] = v: the (30, ne) element output of K0 and K1.
template <typename T>
struct DenseStore {
  T* __restrict__ out;

  __device__ __forceinline__ void operator()(int i, long long e, long long ne, T v) const {
    out[i * ne + e] = v;
  }
};

// The ring.  E elements a tile, one a thread; a stage is one output row i of
// one tile, the 30 rows esm_t[i, :, e0:e0+E]; S slots; V elements a copy.
// The blocks take the tiles in groups of gridDim.x, block b tile b of each
// group, so they read neighbouring spans of each row at about the same
// time; the stages of the last, partial group are shared out in contiguous
// ranges, so every block has the same number of stages to within one.
template <typename T, int E, int S, int V, typename LoadU, typename Store>
__global__ void __launch_bounds__(E)
ring_kernel(const T* __restrict__ esm_t, const LoadU load_u, const Store store, long long ne,
            long long ntiles) {
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
      if (e < ne) load_u(e, ne, u);
    }
    const T* slot = ring + static_cast<int>(k % S) * kSlot + threadIdx.x;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kDofs; ++j) acc += slot[j * E] * u[j];
    if (e < ne) store(i, e, ne, acc);
  }
}

// 1 KB rows a stage (256 elements of f32, 128 of f64), 3 slots; 16-byte
// copies where every row starts 16-byte aligned, else one value a copy.
// Returns a cudaError_t (0 = launched).
template <typename T, typename LoadU, typename Store>
int launch(const T* esm_t, const LoadU& load_u, const Store& store, long long ne,
           void* stream) {
  if (ne <= 0) return 0;
  constexpr int kE = 1024 / sizeof(T), kS = 3, kV = 16 / sizeof(T);
  const bool vec = ne % kV == 0 && reinterpret_cast<uintptr_t>(esm_t) % 16 == 0;
  const auto kernel = vec ? ring_kernel<T, kE, kS, kV, LoadU, Store>
                          : ring_kernel<T, kE, kS, 1, LoadU, Store>;
  static int resident[2][fcvm_ring::kMaxDevices];
  constexpr int kSmem = kS * kDofs * kE * static_cast<int>(sizeof(T));
  const long long ntiles = (ne + kE - 1) / kE;
  int grid = 0;
  const int err = fcvm_ring::persistent_grid(kernel, kE, kSmem, ntiles * kDofs, resident[vec],
                                             &grid);
  if (err != 0) return err;
  kernel<<<grid, kE, kSmem, static_cast<cudaStream_t>(stream)>>>(esm_t, load_u, store, ne,
                                                                 ntiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fcvm_element
