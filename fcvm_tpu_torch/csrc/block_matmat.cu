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
// What bounds it: the blocks, 3600 bytes an element in f32, against 240 m
// bytes of columns in and out; every block entry feeds 2 m flops.  At m <= 8
// the block reads dominate and the kernel is bound by device-memory reads.
// Two designs.  The narrow one costs a fixed part plus a part per column;
// the wide one costs the same at every m <= 32, since a warp computes its
// products on all 32 lanes however many columns are live.  On the H100 at
// 103,680 elements (PERF.md, K0m at every m from 1 to 8) the narrow design
// is faster at m = CT, the columns of one 32-byte sector (8 in f32, 4 in
// f64), and at m <= kNarrowMax; the wide one is faster at the widths between
// and above.
//   * Narrow (m = CT: the eigensolve's block of 8 in f32; m <= kNarrowMax:
//     the last columns of a block solve): a thread owns one element and
//     kRows = 5 output rows, and keeps the kRows x CT sums in registers.
//     Neighbouring threads take neighbouring elements, so each block row
//     esm_t[i, j, :] is read as contiguous warp loads, as in K0; a thread
//     reads its element's column row ue[e, j, :] as one sector, two 16-byte
//     vector loads where m = CT and the tensors are 16-byte aligned.  The
//     grid is one-dimensional, (elements / 128) x (30 / kRows) blocks with
//     the row group fastest, so the blocks that read the same column rows run
//     side by side and the re-reads come from the L2 cache.  Five rows a
//     thread (not K0's ten) halve the registers and double the warps in
//     flight.
//   * Wide (the other widths: the eigensolve's block of 8 in f64, the
//     deflation builds' m = 32, 64): a thread block takes kEls consecutive
//     elements (8 in f32, 4 in f64) and stages their 30 x 30 blocks in shared
//     memory (each read esm_t[i, j, e0:e0+kEls] is one 32-byte sector); one
//     warp per element, one lane per column, so the column rows
//     ue[e, j, c0:c0+32] and out[e, i, c0:c0+32] are read and written as
//     contiguous warp accesses, and the blocks, the columns and the output
//     each cross device memory once.  A lane keeps its column's 30 entries in
//     registers and sums each output row from the staged block row, read as
//     a broadcast.
// Each sum runs over j in order 0..29, as K0's does.  Sums accumulate in the
// input type; nothing is lowered in precision.
//
// C interface: returns cudaGetLastError() after the launch (0 = launched).
// The caller owns all memory and the stream; the kernel does not synchronise.
// csrc/ops.cpp binds it to PyTorch as torch.ops.fcvm.block_matmat.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kDofs = 30;     // 10 nodes x 3 components per tet10 element
constexpr int kRows = 5;      // output rows per thread
constexpr int kGroups = kDofs / kRows;
constexpr int kThreads = 128;
constexpr int kWarp = 32;
// the narrow design's scalar variant serves m <= kNarrowMax: on the H100 its
// time grows by ~0.05 ms a column from ~0.24 ms (f32) and ~0.47 ms (f64) at
// m = 1, and passes the wide design's flat ~0.39 / ~0.62 ms at m = 4
constexpr int kNarrowMax = 3;

// CT = 8 columns of f32 or 4 of f64: 32 bytes, two 16-byte vectors
__device__ __forceinline__ void load_cols(const float* p, float (&d)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
}

__device__ __forceinline__ void load_cols(const double* p, double (&d)[4]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  d[0] = a.x; d[1] = a.y; d[2] = b.x; d[3] = b.y;
}

__device__ __forceinline__ void store_cols(float* p, const float (&d)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(d[0], d[1], d[2], d[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(d[4], d[5], d[6], d[7]);
}

__device__ __forceinline__ void store_cols(double* p, const double (&d)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(d[0], d[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(d[2], d[3]);
}

// Narrow (m = CT, or m <= kNarrowMax < CT): thread = (element, row group).
template <typename T, int CT, bool kVec>
__global__ void __launch_bounds__(kThreads)
block_matmat_kernel(const T* __restrict__ esm_t, const T* __restrict__ ue,
                    T* __restrict__ out, long long ne, int m) {
  const int i0 = static_cast<int>(blockIdx.x % kGroups) * kRows;
  const long long e = static_cast<long long>(blockIdx.x / kGroups) * kThreads + threadIdx.x;
  if (e >= ne) return;
  const T* u = ue + e * kDofs * m;

  T acc[kRows][CT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[r][c] = T(0);

#pragma unroll 6
  for (int j = 0; j < kDofs; ++j) {
    T uj[CT];
    if (kVec) {
      load_cols(u + j * m, uj);
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c) uj[c] = c < m ? u[j * m + c] : T(0);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const T b = esm_t[(static_cast<long long>(i0 + r) * kDofs + j) * ne + e];
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[r][c] += b * uj[c];
    }
  }

  T* o = out + e * kDofs * m;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kVec) {
      store_cols(o + (i0 + r) * m, acc[r]);
    } else {
#pragma unroll
      for (int c = 0; c < CT; ++c)
        if (c < m) o[(i0 + r) * m + c] = acc[r][c];
    }
  }
}

// Wide (every other m): one thread block per kEls elements, warp w =
// element e0 + w, lane = column within a chunk of 32.
template <typename T, int kEls>
__global__ void __launch_bounds__(kWarp * kEls)
block_matmat_wide_kernel(const T* __restrict__ esm_t, const T* __restrict__ ue,
                         T* __restrict__ out, long long ne, int m) {
  // rows padded to 32 entries: 16-byte aligned for the vector reads below
  __shared__ __align__(16) T bs[kEls][kDofs][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const long long e0 = static_cast<long long>(blockIdx.x) * kEls;
  for (int p = threadIdx.x; p < kDofs * kDofs * kEls; p += kWarp * kEls) {
    const int el = p % kEls, ij = p / kEls;
    bs[el][ij / kDofs][ij % kDofs] =
        e0 + el < ne ? esm_t[static_cast<long long>(ij) * ne + e0 + el] : T(0);
  }
  for (int p = threadIdx.x; p < kEls * kDofs * (kWarp - kDofs); p += kWarp * kEls) {
    const int pad = p % (kWarp - kDofs), row = p / (kWarp - kDofs);
    bs[row / kDofs][row % kDofs][kDofs + pad] = T(0);
  }
  __syncthreads();
  const long long e = e0 + w;
  if (e >= ne) return;
  constexpr int kVecN = 16 / sizeof(T);  // entries of one 16-byte vector
  using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
  for (int c0 = 0; c0 < m; c0 += kWarp) {
    const int c = c0 + lane;
    if (c >= m) break;
    T uj[kWarp];  // the column's 30 entries; the 2 pad entries stay 0
#pragma unroll
    for (int j = 0; j < kWarp; ++j) uj[j] = j < kDofs ? ue[(e * kDofs + j) * m + c] : T(0);
#pragma unroll 2
    for (int i = 0; i < kDofs; ++i) {
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < kWarp / kVecN; ++q) {
        const V b = reinterpret_cast<const V*>(&bs[w][i][0])[q];
        const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
        for (int k = 0; k < kVecN; ++k) acc += bv[k] * uj[q * kVecN + k];
      }
      out[(e * kDofs + i) * m + c] = acc;
    }
  }
}

template <typename T, int CT>
int launch(const T* esm_t, const T* ue, T* out, long long ne, int m, void* stream) {
  if (ne <= 0 || m <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (m == CT || m <= kNarrowMax) {
    const long long nblocks = (ne + kThreads - 1) / kThreads * kGroups;
    if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const auto grid = static_cast<unsigned>(nblocks);
    if (m == CT && reinterpret_cast<uintptr_t>(ue) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0)
      block_matmat_kernel<T, CT, true><<<grid, kThreads, 0, s>>>(esm_t, ue, out, ne, m);
    else
      block_matmat_kernel<T, CT, false><<<grid, kThreads, 0, s>>>(esm_t, ue, out, ne, m);
  } else {
    constexpr int kEls = CT;  // 8 elements in f32, 4 in f64: one sector a block entry
    const long long nblocks = (ne + kEls - 1) / kEls;
    if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    block_matmat_wide_kernel<T, kEls><<<static_cast<unsigned>(nblocks), kWarp * kEls, 0, s>>>(
        esm_t, ue, out, ne, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fcvm_block_matmat_f32(const float* esm_t, const float* ue, float* out,
                                     long long ne, int m, void* stream) {
  return launch<float, 8>(esm_t, ue, out, ne, m, stream);
}

extern "C" int fcvm_block_matmat_f64(const double* esm_t, const double* ue, double* out,
                                     long long ne, int m, void* stream) {
  return launch<double, 4>(esm_t, ue, out, ne, m, stream);
}
