// K0m: batched 30x30 element-block products with m columns, for Hopper (sm_90a).
//
// The multi-column form of K0 (csrc/block_matvec.cu).  It replaces what the
// JAX package computes with K0 under vmap (fcvm_tpu/ops/pallas_kernels.py::
// block_matvec, one launch per column of the buckling eigensolve's column
// solves) and the block einsum of fcvm_tpu/runtime/buckling.py:318 (K_hat·V
// and -G_hat·V) and of ops/deflation.block_khat_matvec.  It computes
//
//     out[e, i, c] = sum_j esm_t[i, j, e] * ue[e, j, c]
//
// with esm_t (30, 30, ne) element-major (the operator's layout, shared with
// K0), ue and out (ne, 30, m): the node-row gather of an (ndof, m) block
// yields ue in this layout with no copy, and out reshapes to (10 ne, 3, m)
// node rows for the scatter-add, again with no copy.
//
// What bounds it: device-memory bytes, the blocks (3600 bytes an element in
// f32, 7200 in f64) plus 240 m (f32) or 480 m (f64) bytes of columns in and
// out; every block entry feeds 2 m flops, which stays below the f32 and f64
// rates at every m the paths use (PERF.md).  Two designs, by m:
//   * Narrow ring (m <= 8: the eigensolve's block of 8 and the tails of its
//     block solves).  A persistent grid, each block walking tiles of 32
//     elements through a ring of 3 shared-memory slots filled by cp.async
//     (csrc/ring.cuh).  A stage is a slice of J values of j: the block rows
//     esm_t[:, j0:j0+J, e0:e0+32] in 16-byte copies (one value a copy where
//     ne leaves the rows unaligned), and the column slice
//     ue[e0:e0+32, j0:j0+J, :] stored transposed, element fastest (one value
//     a copy), so a warp reads 32 consecutive elements from both without
//     bank conflicts.  A thread owns one element and 5 output rows and keeps
//     all 5 x m sums in registers across the 30 / J stages of its tile: each
//     block value read from shared memory feeds m products, each column
//     value 5.  The last stage stages the tile's outputs in shared memory
//     and writes them as contiguous runs (the tile's out rows are one span
//     of 32 x 30 x m values), where per-thread stores of 5 m values at a
//     stride of 30 m were slow at every m that leaves 5 m not a multiple
//     of 4.  f32: J = 5,
//     the outputs in one pass; f64: J = 2, two passes of 15 rows, which
//     keeps two blocks on each SM.
//   * Wide (m > 8: the deflation builds' m = 32, 64).  A thread block per 8
//     elements (f32) or 4 (f64), one warp per element and one lane per
//     column, so the column rows ue[e, j, c0:c0+32] and out[e, i, c0:c0+32]
//     are contiguous warp accesses.  The blocks are copied asynchronously,
//     one value a copy, into the padded layout [element][i][32] while each
//     lane loads its column's 30 entries; a lane then sums each output row
//     from the staged block row, read as 16-byte broadcasts.  A persistent
//     ring of this design held too few warps an SM to hide the column loads
//     and ran slower; in f64 it reaches 82-86% of its bound where torch.bmm,
//     on blocks stored element by element, reaches 89-90%, and wider tiles
//     or more rows summed at once did not close that (PERF.md).
// Each sum runs over j in order 0..29.  Sums accumulate in the input type,
// with FMA; nothing is lowered in precision.
//
// C interface: returns cudaGetLastError() after the launch (0 = launched).
// The caller owns all memory and the stream; the kernel does not synchronise.
// csrc/ops.cpp binds it to PyTorch as torch.ops.fcvm.block_matmat.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int kDofs = 30;     // 10 nodes x 3 components per tet10 element
constexpr int kRows = 5;      // output rows a thread (narrow ring)
constexpr int kGroups = kDofs / kRows;
constexpr int kWarp = 32;

// Narrow ring (m = M <= 8): a tile of E elements; thread (el, g) owns element
// e0 + el and output rows g kRows .. g kRows + kRows - 1, all M columns, in
// registers.  A stage is one slice of J values of j: the block rows
// esm_t[i, j0:j0+J, e0:e0+E] for every i (V elements a copy), and the column
// slice ue[e0:e0+E, j0:j0+J, :] stored transposed, element fastest, with the
// element pitch padded to E + 1 (one value a copy).  30 / J stages make a
// tile; the sums carry across them, and the last one stages the outputs in
// NP passes.  Each block walks the tiles blockIdx.x, blockIdx.x + gridDim.x,
// ... (neighbouring blocks on neighbouring tiles).
template <typename T, int M, int E, int J, int S, int NP>
struct NarrowRing {
  static constexpr int kThreads = E * kGroups;
  static constexpr int kEP = E + 1;
  static constexpr int kVecN = 16 / sizeof(T);
  static constexpr int kB = kDofs * J * E;  // block slice, J x 30 rows of E
  static constexpr int kU = (J * M * kEP + kVecN - 1) / kVecN * kVecN;  // 16-byte multiple
  static constexpr int kSlot = kB + kU;
  static constexpr int kChunks = kDofs / J;
  // the outputs leave in NP passes of kPassRows rows, staged element by
  // element at an odd pitch (no bank conflicts on the staging stores)
  static constexpr int kPassRows = kDofs / NP;
  static constexpr int kOP = kPassRows * M + 1;
  static constexpr int kSmem = (S * kSlot + E * kOP) * static_cast<int>(sizeof(T));
  static_assert(kDofs % J == 0 && E % kWarp == 0, "J divides 30; warps of whole elements");
  static_assert(kGroups % NP == 0, "a pass takes whole row groups");
};

template <typename T, int M, int E, int J, int S, int NP, int V>
__global__ void __launch_bounds__(E * kGroups)
block_matmat_narrow_ring(const T* __restrict__ esm_t, const T* __restrict__ ue,
                         T* __restrict__ out, long long ne, long long ntiles) {
  using P = NarrowRing<T, M, E, J, S, NP>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  const int el = threadIdx.x % E, g = threadIdx.x / E;
  const long long ntb = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long long nk = ntb * P::kChunks;

  auto issue = [&](long long k) {
    const long long e0 = (blockIdx.x + k / P::kChunks * gridDim.x) * E;
    const int j0 = static_cast<int>(k % P::kChunks) * J;
    T* bs = ring + static_cast<int>(k % S) * P::kSlot;
    T* us = bs + P::kB;
    constexpr int kBC = kDofs * J * (E / V);
#pragma unroll
    for (int r = 0; r < (kBC + P::kThreads - 1) / P::kThreads; ++r) {
      const int q = threadIdx.x + r * P::kThreads;
      if (kBC % P::kThreads == 0 || q < kBC) {
        const int row = q / (E / V), c = (q % (E / V)) * V;  // row = i J + jj
        const int i = row / J, jj = row - i * J;
        const bool valid = e0 + c < ne;  // V > 1 only when ne % V == 0
        fcvm_ring::cp_async<V * sizeof(T)>(
            bs + row * E + c,
            valid ? esm_t + static_cast<long long>(i * kDofs + j0 + jj) * ne + e0 + c : esm_t,
            valid);
      }
    }
    constexpr int kUC = E * J * M;
#pragma unroll
    for (int r = 0; r < (kUC + P::kThreads - 1) / P::kThreads; ++r) {
      const int q = threadIdx.x + r * P::kThreads;
      if (kUC % P::kThreads == 0 || q < kUC) {
        const int e = q / (J * M), jc = q - e * (J * M);  // jc = jj M + c
        const bool valid = e0 + e < ne;
        fcvm_ring::cp_async<sizeof(T)>(
            us + jc * P::kEP + e, valid ? ue + (e0 + e) * kDofs * M + j0 * M + jc : ue, valid);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    if (k < nk) issue(k);
    fcvm_ring::cp_async_commit();
  }
  T acc[kRows][M];
  for (long long k = 0; k < nk; ++k) {
    fcvm_ring::cp_async_wait<S - 2>();
    __syncthreads();
    if (k + S - 1 < nk) issue(k + S - 1);
    fcvm_ring::cp_async_commit();
    const int q = static_cast<int>(k % P::kChunks);
    if (q == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < M; ++c) acc[r][c] = T(0);
    }
    const T* bs = ring + static_cast<int>(k % S) * P::kSlot;
    const T* us = bs + P::kB;
#pragma unroll
    for (int jj = 0; jj < J; ++jj) {
      T u[M];
#pragma unroll
      for (int c = 0; c < M; ++c) u[c] = us[(jj * M + c) * P::kEP + el];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const T b = bs[((g * kRows + r) * J + jj) * E + el];
#pragma unroll
        for (int c = 0; c < M; ++c) acc[r][c] += b * u[c];
      }
    }
    if (q == P::kChunks - 1) {
      const long long e0 = (blockIdx.x + k / P::kChunks * gridDim.x) * E;
      T* stage = ring + S * P::kSlot;
      constexpr int kPassGroups = kGroups / NP, kN = P::kPassRows * M;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        if (p > 0) __syncthreads();
        if (g / kPassGroups == p) {
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int c = 0; c < M; ++c)
              stage[el * P::kOP + ((g - p * kPassGroups) * kRows + r) * M + c] = acc[r][c];
        }
        __syncthreads();
        // out[e0 + el, p kPassRows .. , :] is kN contiguous values an element
        for (int x = threadIdx.x; x < E * kN; x += P::kThreads) {
          const int el2 = x / kN, rc = x - el2 * kN;
          if (e0 + el2 < ne) out[(e0 + el2) * kDofs * M + p * kN + rc] = stage[el2 * P::kOP + rc];
        }
      }
    }
  }
}

template <typename T, int M, int E, int J, int S, int NP>
int launch_narrow_ring(const T* esm_t, const T* ue, T* out, long long ne, cudaStream_t s) {
  using P = NarrowRing<T, M, E, J, S, NP>;
  constexpr int kV = 16 / sizeof(T);
  const bool vec_rows = ne % kV == 0 && reinterpret_cast<uintptr_t>(esm_t) % 16 == 0;
  const auto kernel = vec_rows ? block_matmat_narrow_ring<T, M, E, J, S, NP, kV>
                               : block_matmat_narrow_ring<T, M, E, J, S, NP, 1>;
  static int resident[2][fcvm_ring::kMaxDevices];
  const long long ntiles = (ne + E - 1) / E;
  int grid = 0;
  const int err = fcvm_ring::persistent_grid(kernel, P::kThreads, P::kSmem, ntiles,
                                             resident[vec_rows], &grid);
  if (err != 0) return err;
  kernel<<<grid, P::kThreads, P::kSmem, s>>>(esm_t, ue, out, ne, ntiles);
  return static_cast<int>(cudaGetLastError());
}

// Wide (m > 8): one thread block per kEls elements, warp w = element e0 + w,
// lane = column within a chunk of 32.  The blocks are copied asynchronously,
// one value a copy, into the padded layout [element][i][32]; meanwhile each
// lane loads its first column's 30 entries.
template <typename T, int kEls>
struct Wide {
  static constexpr int kVecN = 16 / sizeof(T);
  // element pitch: 30 rows of 32 and one 16-byte vector, which puts the
  // elements of one copy instruction on different banks
  static constexpr int kES = kDofs * kWarp + kVecN;
};

template <typename T, int kEls>
__global__ void __launch_bounds__(kWarp * kEls)
block_matmat_wide_async(const T* __restrict__ esm_t, const T* __restrict__ ue,
                        T* __restrict__ out, long long ne, int m) {
  using P = Wide<T, kEls>;
  __shared__ __align__(16) T bs[kEls * P::kES];
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const long long e0 = static_cast<long long>(blockIdx.x) * kEls;
  for (int p = threadIdx.x; p < kEls * kDofs * (kWarp - kDofs); p += kWarp * kEls) {
    const int row = p / (kWarp - kDofs);  // element row*: el kDofs + i
    bs[(row / kDofs) * P::kES + (row % kDofs) * kWarp + kDofs + p % (kWarp - kDofs)] = T(0);
  }
#pragma unroll 4
  for (int p = threadIdx.x; p < kDofs * kDofs * kEls; p += kWarp * kEls) {
    const int el = p % kEls, ij = p / kEls;
    const int i = ij / kDofs, j = ij - i * kDofs;
    const bool valid = e0 + el < ne;
    fcvm_ring::cp_async<sizeof(T)>(
        bs + el * P::kES + i * kWarp + j,
        valid ? esm_t + static_cast<long long>(ij) * ne + e0 + el : esm_t, valid);
  }
  fcvm_ring::cp_async_commit();
  const long long e = e0 + w;
  T uj[kWarp];  // a column's 30 entries; the 2 pad entries stay 0
#pragma unroll
  for (int j = 0; j < kWarp; ++j)
    uj[j] = j < kDofs && e < ne && lane < m ? ue[(e * kDofs + j) * m + lane] : T(0);
  fcvm_ring::cp_async_wait<0>();
  __syncthreads();
  if (e >= ne) return;
  using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
  const T* b = bs + w * P::kES;
  for (int c0 = 0; c0 < m; c0 += kWarp) {
    const int c = c0 + lane;
    if (c >= m) break;
    if (c0 > 0) {
#pragma unroll
      for (int j = 0; j < kDofs; ++j) uj[j] = ue[(e * kDofs + j) * m + c];
    }
#pragma unroll 2
    for (int i = 0; i < kDofs; ++i) {
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < kWarp / P::kVecN; ++q) {
        const V bq = reinterpret_cast<const V*>(b + i * kWarp)[q];
        const T* bv = reinterpret_cast<const T*>(&bq);
#pragma unroll
        for (int x = 0; x < P::kVecN; ++x) acc += bv[x] * uj[q * P::kVecN + x];
      }
      out[(e * kDofs + i) * m + c] = acc;
    }
  }
}

template <typename T, int kEls>
int launch_wide_async(const T* esm_t, const T* ue, T* out, long long ne, int m, cudaStream_t s) {
  const long long nblocks = (ne + kEls - 1) / kEls;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  block_matmat_wide_async<T, kEls><<<static_cast<unsigned>(nblocks), kWarp * kEls, 0, s>>>(
      esm_t, ue, out, ne, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int E, int J, int S, int NP>
int launch_narrow(const T* esm_t, const T* ue, T* out, long long ne, int m, cudaStream_t s) {
  switch (m) {
    case 1: return launch_narrow_ring<T, 1, E, J, S, NP>(esm_t, ue, out, ne, s);
    case 2: return launch_narrow_ring<T, 2, E, J, S, NP>(esm_t, ue, out, ne, s);
    case 3: return launch_narrow_ring<T, 3, E, J, S, NP>(esm_t, ue, out, ne, s);
    case 4: return launch_narrow_ring<T, 4, E, J, S, NP>(esm_t, ue, out, ne, s);
    case 5: return launch_narrow_ring<T, 5, E, J, S, NP>(esm_t, ue, out, ne, s);
    case 6: return launch_narrow_ring<T, 6, E, J, S, NP>(esm_t, ue, out, ne, s);
    case 7: return launch_narrow_ring<T, 7, E, J, S, NP>(esm_t, ue, out, ne, s);
    case 8: return launch_narrow_ring<T, 8, E, J, S, NP>(esm_t, ue, out, ne, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// m <= 8: the narrow ring, tiles of 32 elements (f32: 5 j a stage, 3 slots,
// the outputs in one pass; f64: 2 j, 3 slots, two passes); m > 8: the wide
// design, 8 elements a block in f32, 4 in f64.
template <typename T>
int launch(const T* esm_t, const T* ue, T* out, long long ne, int m, void* stream) {
  if (ne <= 0 || m <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr bool f32 = sizeof(T) == 4;
  if (m <= 8)
    return f32 ? launch_narrow<T, 32, 5, 3, 1>(esm_t, ue, out, ne, m, s)
               : launch_narrow<T, 32, 2, 3, 2>(esm_t, ue, out, ne, m, s);
  return launch_wide_async<T, f32 ? 8 : 4>(esm_t, ue, out, ne, m, s);
}

}  // namespace

extern "C" int fcvm_block_matmat_f32(const float* esm_t, const float* ue, float* out,
                                     long long ne, int m, void* stream) {
  return launch<float>(esm_t, ue, out, ne, m, stream);
}

extern "C" int fcvm_block_matmat_f64(const double* esm_t, const double* ue, double* out,
                                     long long ne, int m, void* stream) {
  return launch<double>(esm_t, ue, out, ne, m, stream);
}
