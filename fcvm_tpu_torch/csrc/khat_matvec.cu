// K1: the fused K_hat·v of the matrix-free CG solver, for Hopper (sm_90a).
//
// Replaces the XLA-lowered chain of the JAX package's
// fcvm_tpu/ops/assembly.py::make_matvec and make_bc_matvec (gather ->
// block product -> node reduction -> Dirichlet mask), with the node
// reduction of its ScatterPlan (scatter_node_rows: a gather of each node's
// incident element rows, summed in a fixed order).  It computes
//
//     masked:  y = P K (P x) + (I - P) x,   P = diag(fixmask)
//     raw:     y = K x
//
// for K given by its symmetric element blocks, packed: the upper triangle
// i <= j of each 30x30 block, 465 values in row-major order, tile-major
// (ntiles, 465, E) with E elements a tile (256 in f32, 128 in f64: 1 KB a
// packed row; ops/kernels.py::pack_blocks), the last tile zero-padded; and
// the element node table elnodes_t (10, ne) int32, element-major.
//
// What bounds it: reading the blocks.  The packed copy halves them (465 of
// 900 values: 1860 bytes an element in f32, 3720 in f64); the rest is the
// node table, x and the mask at the elements' nodes, the incidence table,
// and fe written once and read once (14 MB in f32 on the 502,599-dof plate,
// mostly out of the 50 MB L2).  Each tile is one contiguous span, so the
// blocks stream in large bulk asynchronous copies:
//   1. the element pass: a persistent grid; in each block one producer
//      thread copies stages of 31 packed rows (31 KB, 15 stages a tile) with
//      cp.async.bulk into a ring of 3 shared-memory slots, each with a full
//      mbarrier (the copy's bytes landed) and an empty one (every consumer
//      warp is done with the slot), and with an L2 evict-first hint, so the
//      stream does not push x, the mask, fe and the tables out of the L2.
//      Each consumer thread owns one element of the tile: it gathers its 30
//      values of P x (x) at the 10 nodes while the first stages are in
//      flight, keeps them and 30 sums in registers, and for each packed
//      entry k = K[i][j] adds k u_j to y_i and, off the diagonal, k u_i to
//      y_j; the entry indices are compile-time, so the 60 values never leave
//      the registers (csrc/packed.cuh, which K1m shares).  It writes fe
//      (30, ne) once per tile;
//   2. the node pass: one thread a node sums the node's incident rows of fe
//      in the fixed order of the incidence table, a CSR over nodes
//      (offsets (nn + 1), and pos: each incidence's offset 3 slot ne + e of
//      its first component in fe; fcvm_segment::gather_sum, K8's sum), then
//      applies the mask and the identity on fixed dofs.  A node with no
//      incident element (the padding) gets (1 - P) x, which is 0 there.
// No atomics and a fixed order everywhere (each element's entries in packed
// order, each node's incidences in table order), so two calls on the same
// inputs give the same bits.  Sums accumulate in the input type, with FMA;
// nothing is lowered in precision.
//
// C interface: returns cudaGetLastError() after the launches (0 = launched);
// fixmask == nullptr selects the raw form.  The caller owns all memory (fe is
// its scratch) and the stream; the kernels do not synchronise.  csrc/ops.cpp
// binds it to PyTorch as torch.ops.fcvm.khat_matvec.

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "bulk.cuh"
#include "packed.cuh"
#include "ring.cuh"
#include "segment.cuh"

namespace {

using fcvm_packed::kDofs;
using fcvm_packed::kNodes;
using fcvm_packed::kPacked;
using fcvm_packed::kRows;
using fcvm_packed::kStages;
constexpr int kNodeThreads = 256;
constexpr int kSlots = 3;  // the ring

// The element's 30 values of P x (kMasked) or x, gathered at its nodes.
template <typename T, bool kMasked>
struct GatherU {
  const int* __restrict__ elnodes_t;
  const T* __restrict__ x;
  const T* __restrict__ fixmask;

  __device__ __forceinline__ void operator()(long long e, long long ne, T (&u)[kDofs]) const {
#pragma unroll
    for (int n = 0; n < kNodes; ++n) {
      const long long d = 3LL * elnodes_t[n * ne + e];
#pragma unroll
      for (int c = 0; c < 3; ++c) u[3 * n + c] = kMasked ? fixmask[d + c] * x[d + c] : x[d + c];
    }
  }
};

// The element pass: kE consumer threads (one element each) and one producer
// warp; block b takes tiles b, b + gridDim.x, ...
template <typename T, int kE, typename LoadU>
__global__ void __launch_bounds__(kE + 32)
packed_kernel(const T* __restrict__ packed, const LoadU load_u, T* __restrict__ fe,
              long long ne, long long ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots];
  T* const ring = reinterpret_cast<T*>(smem);
  constexpr int kStageBytes = kRows * kE * static_cast<int>(sizeof(T));
  const long long my_tiles =
      ntiles > blockIdx.x ? (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      fcvm_bulk::mbar_init(full + s, 1);
      fcvm_bulk::mbar_init(empty + s, kE / 32);
    }
    fcvm_bulk::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kE) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == kE) {
      const uint64_t policy = fcvm_bulk::evict_first_policy();
      const long long nk = my_tiles * kStages;
      for (long long k = 0; k < nk; ++k) {
        const int slot = static_cast<int>(k % kSlots);
        if (k >= kSlots) {
          fcvm_bulk::mbar_wait(empty + slot, static_cast<uint32_t>((k / kSlots - 1) & 1));
          fcvm_bulk::fence_proxy_async();  // the consumers' reads before the refill
        }
        const long long t = blockIdx.x + (k / kStages) * gridDim.x;
        const T* src = packed + (t * kPacked + (k % kStages) * kRows) * kE;
        fcvm_bulk::mbar_expect_tx(full + slot, kStageBytes);
        fcvm_bulk::bulk_copy_g2s_hint(ring + slot * kRows * kE, src, kStageBytes, full + slot,
                                      policy);
      }
    }
    return;
  }

  const fcvm_packed::Ring bars{full, empty};
  for (long long n = 0; n < my_tiles; ++n) {
    const long long e = (blockIdx.x + n * gridDim.x) * kE + threadIdx.x;
    T u[kDofs], y[kDofs];
#pragma unroll
    for (int i = 0; i < kDofs; ++i) u[i] = y[i] = T(0);
    if (e < ne) load_u(e, ne, u);
    fcvm_packed::block_sum<kE, kSlots>(ring, bars, n * kStages, threadIdx.x, y, u,
                                       std::make_integer_sequence<int, kStages>{});
    if (e < ne) {
#pragma unroll
      for (int i = 0; i < kDofs; ++i) fe[i * ne + e] = y[i];
    }
  }
}

// One thread a node: y[3n + c] = sum over the node's incidences p of
// fe[pos[p] + c ne], masked.
template <typename T, bool kMasked>
__global__ void __launch_bounds__(kNodeThreads)
node_sum_kernel(const T* __restrict__ fe, const int* __restrict__ offsets,
                const int* __restrict__ pos, const T* __restrict__ x,
                const T* __restrict__ fixmask, T* __restrict__ y, long long nn, long long ne) {
  const long long n = static_cast<long long>(blockIdx.x) * kNodeThreads + threadIdx.x;
  if (n >= nn) return;
  T s[3] = {T(0), T(0), T(0)};
  fcvm_segment::gather_sum<T, 3>(s, fe, pos, offsets[n], offsets[n + 1], 1, ne);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const long long d = 3 * n + c;
    y[d] = kMasked ? fixmask[d] * s[c] + (T(1) - fixmask[d]) * x[d] : s[c];
  }
}

template <typename T, bool kMasked>
int run(const T* packed, const int* elnodes_t, const int* offsets, const int* pos, const T* x,
        const T* fixmask, T* fe, T* y, long long ne, long long nn, long long ntiles,
        void* stream) {
  constexpr int kE = 1024 / sizeof(T);
  const auto s = static_cast<cudaStream_t>(stream);
  if (ne > 0) {
    const auto kernel = packed_kernel<T, kE, GatherU<T, kMasked>>;
    constexpr int kSmem = kSlots * kRows * kE * static_cast<int>(sizeof(T));
    static int resident[fcvm_ring::kMaxDevices];
    int grid = 0;
    const int err = fcvm_ring::persistent_grid(kernel, kE + 32, kSmem, ntiles, resident, &grid);
    if (err != 0) return err;
    kernel<<<grid, kE + 32, kSmem, s>>>(packed, GatherU<T, kMasked>{elnodes_t, x, fixmask}, fe,
                                        ne, ntiles);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
  }
  if (nn <= 0) return 0;
  const long long blocks = (nn + kNodeThreads - 1) / kNodeThreads;
  node_sum_kernel<T, kMasked><<<static_cast<unsigned>(blocks), kNodeThreads, 0, s>>>(
      fe, offsets, pos, x, fixmask, y, nn, ne);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* packed, const int* elnodes_t, const int* offsets, const int* pos,
             const T* x, const T* fixmask, T* fe, T* y, long long ne, long long nn,
             long long ntiles, void* stream) {
  return fixmask != nullptr
             ? run<T, true>(packed, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, ntiles,
                            stream)
             : run<T, false>(packed, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, ntiles,
                             stream);
}

}  // namespace

extern "C" int fcvm_khat_matvec_f32(const float* packed, const int* elnodes_t,
                                    const int* offsets, const int* pos, const float* x,
                                    const float* fixmask, float* fe, float* y, long long ne,
                                    long long nn, long long ntiles, void* stream) {
  return dispatch<float>(packed, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, ntiles,
                         stream);
}

extern "C" int fcvm_khat_matvec_f64(const double* packed, const int* elnodes_t,
                                    const int* offsets, const int* pos, const double* x,
                                    const double* fixmask, double* fe, double* y, long long ne,
                                    long long nn, long long ntiles, void* stream) {
  return dispatch<double>(packed, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, ntiles,
                          stream);
}
