// K4: the fused two-level preconditioner apply on a vector, and K4m, its
// block form on m columns at once, for Hopper (sm_90a).
//
// Replaces the XLA-lowered fcvm_tpu/ops/precond.py::TwoLevelPrecond.apply
// (block Jacobi, the projection onto the cluster modes, the cluster sum, the
// coarse product, the prolongation and the masks).  It computes
//
//     z = z_fine + P Q Kc^-1 Q^T (P r),   P = diag(fixmask)
//
// with z_fine = pinv r per node (block Jacobi, pinv (nn, 3, 3)) or the
// caller's (the cluster smoother's output), Q = qmat (nn_cl, 3, nm), nm 6 or
// 12 modes a cluster of cs = nn_cl / ncl index-contiguous nodes, and Kc^-1
// the symmetric (n, n) coarse inverse, n = nm ncl, in mode-major order
// (k ncl + i), given by its packed upper tiles (below).  The nodes past nn
// (nn_cl >= nn) carry r = 0 and are cut off the output.
//
// Three steps:
//   1. restrict: one thread block a cluster reads r, fixmask, qmat and (for
//      block Jacobi) pinv once; it writes z = pinv r at its nodes and the
//      cluster's nm mode sums of Q^T (P r) into their mode-major slots of rc,
//      each a fixed-order reduction (per thread over its nodes, then a warp
//      shuffle tree, then over the warps in order) with no atomics;
//   2. zc = Kc^-1 rc, the symmetric coarse product (K4c, below);
//   3. prolong: one thread a node adds fixmask Q zc at its cluster to z.
// What bounds it: reading the coarse inverse (its upper triangle, 300.8 MB
// in f32 on the 502,599-dof plate's 12,264 coarse dofs) in step 2; steps 1
// and 3 move qmat twice (24.1 MB), pinv (6.0 MB) and six vectors of 2 MB.
//
// K4m replaces the same apply under the vmap of the eigensolve's block
// solves (fcvm_tpu/runtime/buckling.py::_kinv): r, z and z_fine are (3 nn,
// m), row-major with the column axis last.  The same three steps, widened:
//   1. restrict: one thread block a (cluster, chunk of kC columns: the least
//      power of two >= m, at most 32); a thread takes one column at every
//      (128 / kC)-th node of the cluster, so a warp's reads of r and writes
//      of z are runs of kC values; each (mode, column) sum is the vector's
//      fixed-order reduction (per thread, a shuffle tree over the lanes of
//      its column, the warps in order) into rc (nm ncl, m), mode-major rows;
//   2. zc = Kc^-1 rc on all m columns (up to 8 a pass over the tiles);
//   3. prolong: one thread a (node, column).
//
// K4c, the symmetric coarse product zc = Kc^-1 rc (rc (n, m), m >= 1),
// replaces the dense product coarse_inv @ rc of
// fcvm_tpu/ops/precond.py:137 (a plain product in HIGHEST precision, left
// to XLA).  The inverse is symmetric, so only its upper triangle is stored
// (ops/kernels.py::pack_coarse): the (n, n) matrix cut into 128 x 128 tiles,
// the upper ones (bi <= bj) in row-major tile order, each tile contiguous
// and row-major, the last tile row and column zero-padded; a diagonal tile
// is stored whole, its lower half the mirror of its upper half.  What bounds
// it: reading the tiles, 64 KB each in f32 (4,656 tiles, 305 MB on the
// plate: the triangle and 1.5% of padding and mirrored halves); at m = 8 in
// f32 its 4 m flops a stored value ask 40% of the card's FMA rate.
//   1. the tile pass: a persistent grid; block b takes the b-th of gridDim
//      equal runs of the tile list.  One producer thread copies each tile in
//      4 stages of 32 rows (16 KB in f32, 32 KB in f64) with cp.async.bulk
//      into a ring of shared-memory slots (6 in f32 up to 2 columns of x, else
//      3; two blocks an SM in f32 from 4 columns) with an L2
//      evict-first hint; 8 consumer warps take 4 rows of a stage each, a lane
//      4 columns of a row (one 16-byte load in f32, two in f64).  From one
//      read of A = tile (bi, bj), a lane adds A[r][j] x[bj, j] over its
//      columns into the row's product (a shuffle reduction over the warp's
//      lanes, halving the columns of x a lane carries at each step, so each
//      (row, column) total lands in one lane) and A[r][j] x[bi, r] into its
//      columns' transposed product, kept in registers over the tile.  The
//      row products of a run of tiles in one tile row add up in shared
//      memory (one owner lane an entry, tile after tile) and leave as one
//      partial when the tile row or the run ends (scratch su); the
//      transposed products of an off-diagonal tile are summed over the 8
//      warps in order and leave as the tile's partial (scratch sv, a slot a
//      tile: 2.4 MB a column in f32 on the plate, mostly L2);
//      x at the tile's rows and columns is loaded a tile ahead, into
//      registers, so its latency hides behind the tile before;
//   2. the sum pass: 8 warps a block of 32 outputs (row, column): warp w
//      adds the transposed partials of the tiles (a, bi), a < bi, a = w mod
//      8, in ascending a; the first adds the 8 sums in a fixed tree and the
//      tile row's run partials, in run order, to that.
// More than 8 columns take one tile pass a chunk of 8.  At 5 to 8 columns
// in f64 the tile pass runs on the tensor cores instead (DMMA,
// coarse_tiles_mma_kernel: the same tiles, ring, runs and scratch, the
// products as 8 x 8 x 4 f64 MMAs, no shuffle reductions).  Measured
// (PERF.md): at 1 and 2 columns the bytes bound it (the tile pass streams at
// ~2.9 TB/s); from 5 columns in f32 the latency of the per-row shuffle
// reductions does, with two blocks an SM; in f64, where one block an SM
// holds the CUDA-core pass, it spilled at 8 columns and was slower than
// cuBLAS's dense GEMM.
// No float atomics and a fixed order everywhere, so two calls on the same
// inputs give the same bits.  f32 stays on the CUDA cores with FMA (no TF32;
// the precision rule of the coarse solve); f64 uses DFMA up to 4 columns
// and DMMA (f64 in and out) from 5.  Sums accumulate in the input type;
// nothing is lowered in precision.
//
// C interface: returns cudaGetLastError() after each launch (0 = launched);
// pinv == nullptr selects the caller's fine level (z_fine, read by prolong).
// The caller owns all memory (rc, zc, sv and su are its scratch, sized by
// fcvm_coarse_plan) and the stream; the kernels do not synchronise.
// csrc/ops.cpp binds restrict, K4c and prolong to PyTorch as one operator,
// torch.ops.fcvm.two_level_apply, the block passes around K4c as
// torch.ops.fcvm.two_level_apply_block, and K4c alone as
// torch.ops.fcvm.coarse_product.

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk.cuh"
#include "ring.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kRestrictThreads = 128;
constexpr int kWarps = kRestrictThreads / kWarp;
constexpr int kProlongThreads = 256;

template <typename T, int kNm, bool kJacobi>
__global__ void __launch_bounds__(kRestrictThreads)
restrict_kernel(const T* __restrict__ r, const T* __restrict__ fixmask,
                const T* __restrict__ qmat, const T* __restrict__ pinv, T* __restrict__ z,
                T* __restrict__ rc, long long nn, int cs, int ncl) {
  __shared__ T part[kWarps][kNm];
  const int cl = blockIdx.x;
  T acc[kNm];
#pragma unroll
  for (int k = 0; k < kNm; ++k) acc[k] = T(0);
  for (int t = threadIdx.x; t < cs; t += kRestrictThreads) {
    const long long n = static_cast<long long>(cl) * cs + t;
    if (n >= nn) break;
    const T r3[3] = {r[3 * n], r[3 * n + 1], r[3 * n + 2]};
    if constexpr (kJacobi) {
      const T* p = pinv + 9 * n;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        z[3 * n + a] = p[3 * a] * r3[0] + p[3 * a + 1] * r3[1] + p[3 * a + 2] * r3[2];
    }
    const T rm[3] = {fixmask[3 * n] * r3[0], fixmask[3 * n + 1] * r3[1],
                     fixmask[3 * n + 2] * r3[2]};
    const T* q = qmat + 3 * kNm * n;
#pragma unroll
    for (int k = 0; k < kNm; ++k)
      acc[k] += q[k] * rm[0] + q[kNm + k] * rm[1] + q[2 * kNm + k] * rm[2];
  }
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < kNm; ++k) {
    T v = acc[k];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kNm) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    rc[static_cast<long long>(threadIdx.x) * ncl + cl] = s;
  }
}

template <typename T, int kNm>
__global__ void __launch_bounds__(kProlongThreads)
prolong_kernel(const T* __restrict__ qmat, const T* __restrict__ zc,
               const T* __restrict__ fixmask, const T* z_fine, T* z, long long nn, int cs,
               int ncl) {
  const long long n = static_cast<long long>(blockIdx.x) * kProlongThreads + threadIdx.x;
  if (n >= nn) return;
  const long long cl = n / cs;
  T c[kNm];
#pragma unroll
  for (int k = 0; k < kNm; ++k) c[k] = zc[k * ncl + cl];
  const T* q = qmat + 3 * kNm * n;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < kNm; ++k) s += q[a * kNm + k] * c[k];
    z[3 * n + a] = z_fine[3 * n + a] + fixmask[3 * n + a] * s;
  }
}

template <typename T, int kNm>
int restrict_nm(const T* r, const T* fixmask, const T* qmat, const T* pinv, T* z, T* rc,
                long long nn, int cs, int ncl, cudaStream_t stream) {
  if (pinv != nullptr)
    restrict_kernel<T, kNm, true><<<ncl, kRestrictThreads, 0, stream>>>(r, fixmask, qmat, pinv,
                                                                        z, rc, nn, cs, ncl);
  else
    restrict_kernel<T, kNm, false><<<ncl, kRestrictThreads, 0, stream>>>(r, fixmask, qmat,
                                                                         pinv, z, rc, nn, cs,
                                                                         ncl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int restrict_(const T* r, const T* fixmask, const T* qmat, const T* pinv, T* z, T* rc,
              long long nn, int cs, int ncl, int nm, void* stream) {
  if (ncl <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (nm == 12) return restrict_nm<T, 12>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, s);
  if (nm == 6) return restrict_nm<T, 6>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int prolong(const T* qmat, const T* zc, const T* fixmask, const T* z_fine, T* z, long long nn,
            int cs, int ncl, int nm, void* stream) {
  if (nn <= 0) return 0;
  const auto blocks = static_cast<unsigned>((nn + kProlongThreads - 1) / kProlongThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nm == 12)
    prolong_kernel<T, 12><<<blocks, kProlongThreads, 0, s>>>(qmat, zc, fixmask, z_fine, z, nn,
                                                             cs, ncl);
  else if (nm == 6)
    prolong_kernel<T, 6><<<blocks, kProlongThreads, 0, s>>>(qmat, zc, fixmask, z_fine, z, nn,
                                                            cs, ncl);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K4m, the block form: the restrict pass over m columns.  Block (cl, q)
// takes cluster cl and columns q kC .. q kC + kC - 1; thread t works on
// column t % kC of the chunk at the cluster's nodes t / kC, t / kC + kLanes,
// ..., and each (mode, column) sum is the same fixed-order reduction as the
// vector's: per thread, then a shuffle tree over the lanes of its column,
// then over the warps in order.
template <typename T, int kNm, int kC, bool kJacobi>
__global__ void __launch_bounds__(kRestrictThreads)
restrict_block_kernel(const T* __restrict__ r, const T* __restrict__ fixmask,
                      const T* __restrict__ qmat, const T* __restrict__ pinv,
                      T* __restrict__ z, T* __restrict__ rc, long long nn, int cs, int ncl,
                      int m) {
  static_assert(kC >= 1 && kC <= kWarp && kWarp % kC == 0, "a chunk divides a warp");
  constexpr int kLanes = kRestrictThreads / kC;
  __shared__ T part[kWarps][kNm][kC];
  const int cl = blockIdx.x;
  const int c = threadIdx.x % kC;
  const int col = blockIdx.y * kC + c;
  T acc[kNm];
#pragma unroll
  for (int k = 0; k < kNm; ++k) acc[k] = T(0);
  if (col < m) {
    for (int t = threadIdx.x / kC; t < cs; t += kLanes) {
      const long long n = static_cast<long long>(cl) * cs + t;
      if (n >= nn) break;
      const T* rn = r + 3 * n * m + col;
      const T r3[3] = {rn[0], rn[m], rn[2 * m]};
      if constexpr (kJacobi) {
        const T* p = pinv + 9 * n;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          z[(3 * n + a) * m + col] = p[3 * a] * r3[0] + p[3 * a + 1] * r3[1] + p[3 * a + 2] * r3[2];
      }
      const T rm[3] = {fixmask[3 * n] * r3[0], fixmask[3 * n + 1] * r3[1],
                       fixmask[3 * n + 2] * r3[2]};
      const T* q = qmat + 3 * kNm * n;
#pragma unroll
      for (int k = 0; k < kNm; ++k)
        acc[k] += q[k] * rm[0] + q[kNm + k] * rm[1] + q[2 * kNm + k] * rm[2];
    }
  }
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < kNm; ++k) {
    T v = acc[k];
#pragma unroll
    for (int off = kWarp / 2; off >= kC; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane < kC) part[warp][k][lane] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kNm * kC; i += kRestrictThreads) {
    const int k = i / kC, cc = i % kC, out = blockIdx.y * kC + cc;
    if (out >= m) continue;
    T s = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][k][cc];
    rc[(static_cast<long long>(k) * ncl + cl) * m + out] = s;
  }
}

// K4m's prolong pass: one thread a (node, column) adds fixmask Q zc at its
// cluster to the fine level.
template <typename T, int kNm>
__global__ void __launch_bounds__(kProlongThreads)
prolong_block_kernel(const T* __restrict__ qmat, const T* __restrict__ zc,
                     const T* __restrict__ fixmask, const T* z_fine, T* z, long long nn, int cs,
                     int ncl, int m) {
  const long long i = static_cast<long long>(blockIdx.x) * kProlongThreads + threadIdx.x;
  if (i >= nn * m) return;
  const long long n = i / m;
  const int col = static_cast<int>(i % m);
  const long long cl = n / cs;
  T c[kNm];
#pragma unroll
  for (int k = 0; k < kNm; ++k) c[k] = zc[(k * ncl + cl) * m + col];
  const T* q = qmat + 3 * kNm * n;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T s = T(0);
#pragma unroll
    for (int k = 0; k < kNm; ++k) s += q[a * kNm + k] * c[k];
    const long long d = (3 * n + a) * m + col;
    z[d] = z_fine[d] + fixmask[3 * n + a] * s;
  }
}

template <typename T, int kNm, int kC>
int restrict_block_c(const T* r, const T* fixmask, const T* qmat, const T* pinv, T* z, T* rc,
                     long long nn, int cs, int ncl, int m, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(ncl), static_cast<unsigned>((m + kC - 1) / kC));
  if (pinv != nullptr)
    restrict_block_kernel<T, kNm, kC, true><<<grid, kRestrictThreads, 0, stream>>>(
        r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m);
  else
    restrict_block_kernel<T, kNm, kC, false><<<grid, kRestrictThreads, 0, stream>>>(
        r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m);
  return static_cast<int>(cudaGetLastError());
}

// The chunk of columns a restrict block takes: the least power of two at
// least m, at most a warp.
template <typename T, int kNm>
int restrict_block_nm(const T* r, const T* fixmask, const T* qmat, const T* pinv, T* z, T* rc,
                      long long nn, int cs, int ncl, int m, cudaStream_t s) {
  if (m <= 1) return restrict_block_c<T, kNm, 1>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m, s);
  if (m <= 2) return restrict_block_c<T, kNm, 2>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m, s);
  if (m <= 4) return restrict_block_c<T, kNm, 4>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m, s);
  if (m <= 8) return restrict_block_c<T, kNm, 8>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m, s);
  if (m <= 16)
    return restrict_block_c<T, kNm, 16>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m, s);
  return restrict_block_c<T, kNm, 32>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m, s);
}

template <typename T>
int restrict_block(const T* r, const T* fixmask, const T* qmat, const T* pinv, T* z, T* rc,
                   long long nn, int cs, int ncl, int nm, int m, void* stream) {
  if (ncl <= 0 || m <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (nm == 12) return restrict_block_nm<T, 12>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m, s);
  if (nm == 6) return restrict_block_nm<T, 6>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int prolong_block(const T* qmat, const T* zc, const T* fixmask, const T* z_fine, T* z,
                  long long nn, int cs, int ncl, int nm, int m, void* stream) {
  if (nn <= 0 || m <= 0) return 0;
  const auto blocks = static_cast<unsigned>((nn * m + kProlongThreads - 1) / kProlongThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  if (nm == 12)
    prolong_block_kernel<T, 12><<<blocks, kProlongThreads, 0, s>>>(qmat, zc, fixmask, z_fine, z,
                                                                   nn, cs, ncl, m);
  else if (nm == 6)
    prolong_block_kernel<T, 6><<<blocks, kProlongThreads, 0, s>>>(qmat, zc, fixmask, z_fine, z,
                                                                  nn, cs, ncl, m);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K4c, the symmetric coarse product on the packed upper tiles.

constexpr int kTile = 128;                              // a tile's rows and columns
constexpr int kStageRows = 32;                          // rows a ring stage
constexpr int kTileStages = kTile / kStageRows;         // 4
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * kWarp;      // 256
constexpr int kWarpRows = kStageRows / kConsumerWarps;  // 4 rows of a stage a warp
constexpr int kLaneCols = kTile / kWarp;                // 4 columns of a row a lane
constexpr int kMaxChunk = 8;                            // columns of x a tile pass
constexpr int kSumParts = 8;                            // warps a block of the sum pass
constexpr int kSumThreads = kSumParts * kWarp;

// Ring slots: 6 of 16 KB in f32 up to 2 columns; 3 where x's columns and
// the transposed products take more room (f32 from 4 columns: two blocks
// an SM; f64: 32 KB slots).
template <typename T, int kMC>
__host__ __device__ constexpr int coarse_slots() {
  return sizeof(T) == 4 && kMC <= 2 ? 6 : 3;
}

// Blocks of the tile pass an SM: two where the f32 block's arithmetic at 4
// and 8 columns needs a second block's warps to hide its latency.
template <typename T, int kMC>
__host__ __device__ constexpr int coarse_min_blocks() {
  return sizeof(T) == 4 && kMC >= 4 ? 2 : 1;
}

// log2 of the columns a tile pass takes (1, 2, 4 or 8).
template <int kMC>
__host__ __device__ constexpr int log2_chunk() {
  return kMC == 1 ? 0 : kMC == 2 ? 1 : kMC == 4 ? 2 : 3;
}

// Shared memory of the tile pass: the ring, the warps' transposed products,
// x at the tile's rows and columns (two buffers: this tile's, the next's),
// the tile row's running row products.
template <typename T, int kMC>
__host__ __device__ constexpr int coarse_smem() {
  return static_cast<int>(sizeof(T)) *
         (coarse_slots<T, kMC>() * kStageRows * kTile + kConsumerWarps * kTile * kMC +
          5 * kTile * kMC);
}

// x at a tile's rows (block bi) and columns (block bj), columns c0 ..
// c0 + kMC - 1, zero past n and m: this thread's entries p = threadIdx.x +
// q kConsumers of the [i][c] layout, loaded into registers a tile ahead.
template <typename T, int kMC>
struct XAhead {
  static constexpr int kPer = (kTile * kMC + kConsumers - 1) / kConsumers;
  T row[kPer], col[kPer];

  __device__ __forceinline__ void load(const T* __restrict__ x, int bi, int bj, int n, int m,
                                       int c0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int p = threadIdx.x + q * kConsumers;
      const int i = p / kMC, col_ = c0 + p % kMC;
      const long long gr = static_cast<long long>(bi) * kTile + i;
      const long long gc = static_cast<long long>(bj) * kTile + i;
      const bool ok = p < kTile * kMC && col_ < m;
      row[q] = ok && gr < n ? x[gr * m + col_] : T(0);
      col[q] = ok && gc < n ? x[gc * m + col_] : T(0);
    }
  }

  __device__ __forceinline__ void store(T* xs_row, T* xs_col) const {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int p = threadIdx.x + q * kConsumers;
      if (p < kTile * kMC) {
        xs_row[p] = row[q];
        xs_col[p] = col[q];
      }
    }
  }
};

// The first tile of tile row b in the row-major list of upper tiles.
__host__ __device__ __forceinline__ long long row_start(long long b, long long nb) {
  return b * nb - b * (b - 1) / 2;
}

// The tile row of tile t.
__host__ __device__ __forceinline__ int tile_row(long long t, int nb) {
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (row_start(mid, nb) <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Run k of nruns over ntiles tiles is [run_start(k), run_start(k + 1)).
__host__ __device__ __forceinline__ long long run_start(long long k, long long ntiles,
                                                        long long nruns) {
  return k * ntiles / nruns;
}

// The run that holds tile t.
__host__ __device__ __forceinline__ long long run_of(long long t, long long ntiles,
                                                     long long nruns) {
  return ((t + 1) * nruns + ntiles - 1) / ntiles - 1;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// A tile pass's ring: slot s is full once its stage has landed (one
// arrival, the producer's, and the copy's bytes) and empty once each
// consumer warp has arrived.
template <int kSlots>
__device__ __forceinline__ void coarse_ring_init(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      fcvm_bulk::mbar_init(full + s, 1);
      fcvm_bulk::mbar_init(empty + s, kConsumerWarps);
    }
    fcvm_bulk::fence_barrier_init();
  }
  __syncthreads();
}

// The producer of a tile pass (one thread): the stages of tiles lo .. hi - 1
// in order, each into the next slot once the consumers have emptied it.
template <typename T, int kSlots>
__device__ __forceinline__ void coarse_produce(const T* __restrict__ tiles, T* ring,
                                               uint64_t* full, uint64_t* empty, long long lo,
                                               long long hi) {
  constexpr int kStageElems = kStageRows * kTile;
  constexpr uint32_t kBytes = kStageElems * sizeof(T);
  const uint64_t policy = fcvm_bulk::evict_first_policy();
  const long long nk = (hi - lo) * kTileStages;
  for (long long k = 0; k < nk; ++k) {
    const int slot = static_cast<int>(k % kSlots);
    if (k >= kSlots) {
      fcvm_bulk::mbar_wait(empty + slot, static_cast<uint32_t>((k / kSlots - 1) & 1));
      fcvm_bulk::fence_proxy_async();  // the consumers' reads before the refill
    }
    const T* src = tiles + (lo * kTileStages + k) * kStageElems;
    fcvm_bulk::mbar_expect_tx(full + slot, kBytes);
    fcvm_bulk::bulk_copy_g2s_hint(ring + slot * kStageElems, src, kBytes, full + slot, policy);
  }
}

// 16 bytes of shared memory as values.
template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

// The warp's sum of u over its lanes, for each of the kMC columns: the first
// log2(kMC) shuffle steps halve the columns a lane carries (a lane keeps the
// half its offset bit selects and adds its partner's copy of that half), the
// rest add whole values.  Returns the total of column lane >> (5 - log2 kMC);
// lanes that share it hold the same bits.
template <int kMC, typename T>
__device__ __forceinline__ T lane_sum(T (&u)[kMC], int lane) {
  constexpr int kHalvings = log2_chunk<kMC>();
#pragma unroll
  for (int j = 0; j < kHalvings; ++j) {
    const int off = 16 >> j, h = kMC >> (j + 1);
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const T send = up ? u[i] : u[i + h];
      const T keep = up ? u[i + h] : u[i];
      u[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  T v = u[0];
#pragma unroll
  for (int off = 16 >> kHalvings; off >= 1; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The tile pass over columns c0 .. c0 + kMC - 1 of x (n, m): block b walks
// run b of the tile list.  sv (ntiles, kTile, m): an off-diagonal tile's
// transposed product, its contribution to its column block; su (nruns,
// maxseg, kTile, m): the row products of a run's tiles in each tile row it
// touches (segment = the tile row - the run's first), their contribution to
// that row block.
template <typename T, int kMC>
__global__ void __launch_bounds__(kConsumers + kWarp, coarse_min_blocks<T, kMC>())
coarse_tiles_kernel(const T* __restrict__ tiles, const T* __restrict__ x, T* __restrict__ sv,
                    T* __restrict__ su, int n, int nb, long long ntiles, int m, int c0,
                    int maxseg) {
  constexpr int kSlots = coarse_slots<T, kMC>();
  constexpr int kStageElems = kStageRows * kTile;
  constexpr int kW = 16 / static_cast<int>(sizeof(T));  // values a 16-byte load
  constexpr int kVecs = kLaneCols / kW;                   // loads a row a lane
  constexpr int kHalvings = log2_chunk<kMC>();
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots];
  T* const ring = reinterpret_cast<T*>(smem);
  T* const red = ring + kSlots * kStageElems;            // [warp][column][c]
  T* const xs = red + kConsumerWarps * kTile * kMC;  // x [buffer][rows, columns][i][c]
  T* const us = xs + 4 * kTile * kMC;                 // the tile row's row products [i][c]
  const long long lo = run_start(blockIdx.x, ntiles, gridDim.x);
  const long long hi = run_start(blockIdx.x + 1LL, ntiles, gridDim.x);
  coarse_ring_init<kSlots>(full, empty);
  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == kConsumers) coarse_produce<T, kSlots>(tiles, ring, full, empty, lo, hi);
    return;
  }

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int my_c = lane >> (5 - kHalvings);  // the column whose row totals this lane holds
  const bool owner = (lane & ((1 << (5 - kHalvings)) - 1)) == 0;
  for (int p = threadIdx.x; p < kTile * kMC; p += kConsumers) us[p] = T(0);
  const int b_first = tile_row(lo, nb);
  int bi = b_first;
  int bj = bi + static_cast<int>(lo - row_start(bi, nb));
  XAhead<T, kMC> ahead;
  ahead.load(x, bi, bj, n, m, c0);
  ahead.store(xs, xs + kTile * kMC);
  consumers_sync();
  long long k = 0;  // stages consumed
  for (long long t = lo; t < hi; ++t) {
    const bool diag = bi == bj;
    const int nbi = bj + 1 == nb ? bi + 1 : bi, nbj = bj + 1 == nb ? nbi : bj + 1;
    if (t + 1 < hi) ahead.load(x, nbi, nbj, n, m, c0);  // lands while this tile is summed
    const T* const xs_row = xs + static_cast<int>((t - lo) & 1) * 2 * kTile * kMC;
    const T* const xs_col = xs_row + kTile * kMC;
    T xc[kLaneCols][kMC], vacc[kLaneCols][kMC];
#pragma unroll
    for (int v = 0; v < kVecs; ++v)
#pragma unroll
      for (int e = 0; e < kW; ++e)
#pragma unroll
        for (int c = 0; c < kMC; ++c) {
          xc[v * kW + e][c] = xs_col[(v * kWarp * kW + lane * kW + e) * kMC + c];
          vacc[v * kW + e][c] = T(0);
        }
#pragma unroll
    for (int s = 0; s < kTileStages; ++s, ++k) {
      const int slot = static_cast<int>(k % kSlots);
      fcvm_bulk::mbar_wait(full + slot, static_cast<uint32_t>((k / kSlots) & 1));
      const T* stage = ring + slot * kStageElems;
#pragma unroll
      for (int q = 0; q < kWarpRows; ++q) {
        const int r = warp * kWarpRows + q;  // the row in the stage
        const int rt = s * kStageRows + r;   // the row in the tile
        T a[kLaneCols];
#pragma unroll
        for (int v = 0; v < kVecs; ++v) {
          const Vec16<T> w =
              *reinterpret_cast<const Vec16<T>*>(stage + r * kTile + v * kWarp * kW + lane * kW);
#pragma unroll
          for (int e = 0; e < kW; ++e) a[v * kW + e] = w.v[e];
        }
        T xr[kMC], u[kMC];
#pragma unroll
        for (int c = 0; c < kMC; ++c) {
          xr[c] = xs_row[rt * kMC + c];
          u[c] = a[0] * xc[0][c];
#pragma unroll
          for (int e = 1; e < kLaneCols; ++e) u[c] = fma(a[e], xc[e][c], u[c]);
        }
        if (!diag) {
#pragma unroll
          for (int e = 0; e < kLaneCols; ++e)
#pragma unroll
            for (int c = 0; c < kMC; ++c) vacc[e][c] = fma(a[e], xr[c], vacc[e][c]);
        }
        const T total = lane_sum<kMC>(u, lane);
        if (owner) us[rt * kMC + my_c] += total;
      }
      __syncwarp();
      if (lane == 0) fcvm_bulk::mbar_arrive(empty + slot);
    }
    if (!diag) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v)
#pragma unroll
        for (int e = 0; e < kW; ++e)
#pragma unroll
          for (int c = 0; c < kMC; ++c)
            red[(warp * kTile + v * kWarp * kW + lane * kW + e) * kMC + c] = vacc[v * kW + e][c];
    }
    if (t + 1 < hi) {  // the other buffer was last read before the previous tile's sync
      T* const next = xs + static_cast<int>((t + 1 - lo) & 1) * 2 * kTile * kMC;
      ahead.store(next, next + kTile * kMC);
    }
    consumers_sync();
    if (!diag) {
      for (int p = threadIdx.x; p < kTile * kMC; p += kConsumers) {
        T sum = red[p];
#pragma unroll
        for (int w = 1; w < kConsumerWarps; ++w) sum += red[w * kTile * kMC + p];
        const int col = c0 + p % kMC;
        if (col < m) sv[(t * kTile + p / kMC) * m + col] = sum;
      }
    }
    if (t + 1 == hi || bj + 1 == nb) {  // the run leaves this tile row: its row products out
      const long long seg = static_cast<long long>(blockIdx.x) * maxseg + (bi - b_first);
      for (int p = threadIdx.x; p < kTile * kMC; p += kConsumers) {
        const int col = c0 + p % kMC;
        if (col < m) su[(seg * kTile + p / kMC) * m + col] = us[p];
        us[p] = T(0);
      }
    }
    consumers_sync();  // red and us free again
    bi = nbi;
    bj = nbj;
  }
}

// d += a b on the tensor cores in f64 (DMMA, mma.sync m8n8k4): of A (8 x 4),
// B (4 x 8) and D (8 x 8) a lane holds A[lane / 4][lane % 4],
// B[lane % 4][lane / 4] and D[lane / 4][2 (lane % 4) + i], i = 0, 1.
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// Ring slots of the f64 DMMA tile pass: 5 of 32 KB (it keeps no transposed
// products in shared memory).
constexpr int kMmaSlots = 5;

__host__ __device__ constexpr int coarse_mma_smem() {
  return static_cast<int>(sizeof(double)) *
         (kMmaSlots * kStageRows * kTile + 4 * kTile * kMaxChunk + kTile * kMaxChunk);
}

// The tile pass over 8 columns c0 .. c0 + 7 of x in f64, on the tensor
// cores: the same runs, ring, producer and scratch (sv, su) as
// coarse_tiles_kernel, whose CUDA-core form spills at 8 f64 columns and
// waits on its per-row shuffle reductions.  With g = lane / 4, q = lane % 4
// and h = warp / 4 (the warp's half of the tile's columns):
//   * the row products T x[bj]: at stage s, warp w takes the 8 rows
//     s 32 + (w % 4) 8 + g of the tile as an A operand and the columns of
//     its half in 8 pairs of k steps, one 16-byte load a pair (columns
//     64 h + 8 p + 2 q and the next), against x at those columns (a B
//     operand held in registers over the tile); each stage's 8 x 8 sum
//     stays in registers over the run's tiles in one tile row and leaves as
//     half 0 + half 1 (through shared memory) when the run leaves the row;
//   * the transposed products T^T x[bi] (off-diagonal tiles): warp w owns
//     the tile's columns 16 w .. 16 w + 15, its even and odd ones as two
//     8-row A operands, k over the stage's rows 4 at a time (one 16-byte
//     load a lane a step: 4 rows of 128 contiguous bytes, no bank
//     conflict), x at those rows the B operand; summed over the tile's 128
//     rows in order and written as the tile's partial, with no sum over
//     warps.
// Each (row, column) and (column, column) sum has one fixed order, so two
// calls give the same bits; double precision throughout.
__global__ void __launch_bounds__(kConsumers + kWarp, 1)
coarse_tiles_mma_kernel(const double* __restrict__ tiles, const double* __restrict__ x,
                        double* __restrict__ sv, double* __restrict__ su, int n, int nb,
                        long long ntiles, int m, int c0, int maxseg) {
  constexpr int kMC = kMaxChunk;
  constexpr int kStageElems = kStageRows * kTile;
  constexpr int kHalf = kTile / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMmaSlots], empty[kMmaSlots];
  double* const ring = reinterpret_cast<double*>(smem);
  double* const xs = ring + kMmaSlots * kStageElems;  // x [buffer][rows, columns][i][c]
  double* const us = xs + 4 * kTile * kMC;            // half 1's row products [i][c]
  const long long lo = run_start(blockIdx.x, ntiles, gridDim.x);
  const long long hi = run_start(blockIdx.x + 1LL, ntiles, gridDim.x);
  coarse_ring_init<kMmaSlots>(full, empty);
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers)
      coarse_produce<double, kMmaSlots>(tiles, ring, full, empty, lo, hi);
    return;
  }

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane >> 2, q = lane & 3, h = warp >> 2, rb = warp & 3;
  const int b_first = tile_row(lo, nb);
  int bi = b_first;
  int bj = bi + static_cast<int>(lo - row_start(bi, nb));
  XAhead<double, kMC> ahead;
  ahead.load(x, bi, bj, n, m, c0);
  ahead.store(xs, xs + kTile * kMC);
  consumers_sync();
  double acc_row[kTileStages][2];
#pragma unroll
  for (int s = 0; s < kTileStages; ++s) acc_row[s][0] = acc_row[s][1] = 0.0;
  long long k = 0;  // stages consumed
  for (long long t = lo; t < hi; ++t) {
    const bool diag = bi == bj;
    const int nbi = bj + 1 == nb ? bi + 1 : bi, nbj = bj + 1 == nb ? nbi : bj + 1;
    if (t + 1 < hi) ahead.load(x, nbi, nbj, n, m, c0);  // lands while this tile is summed
    const double* const xs_row = xs + static_cast<int>((t - lo) & 1) * 2 * kTile * kMC;
    const double* const xs_col = xs_row + kTile * kMC;
    double xb[8][2];  // x at this lane's columns of the warp's half
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int e = 0; e < 2; ++e) xb[p][e] = xs_col[(h * kHalf + 8 * p + 2 * q + e) * kMC + g];
    double acc_t[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
    for (int s = 0; s < kTileStages; ++s, ++k) {
      const int slot = static_cast<int>(k % kMmaSlots);
      fcvm_bulk::mbar_wait(full + slot, static_cast<uint32_t>((k / kMmaSlots) & 1));
      const double* const stage = ring + slot * kStageElems;
      const double* const arow = stage + (rb * 8 + g) * kTile + h * kHalf + 2 * q;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const Vec16<double> a = *reinterpret_cast<const Vec16<double>*>(arow + 8 * p);
        dmma(acc_row[s], a.v[0], xb[p][0]);
        dmma(acc_row[s], a.v[1], xb[p][1]);
      }
      if (!diag) {
#pragma unroll
        for (int kk = 0; kk < kStageRows / 4; ++kk) {
          const int r = 4 * kk + q;  // the row in the stage
          const Vec16<double> a =
              *reinterpret_cast<const Vec16<double>*>(stage + r * kTile + warp * 16 + 2 * g);
          const double b = xs_row[(s * kStageRows + r) * kMC + g];
          dmma(acc_t[0], a.v[0], b);
          dmma(acc_t[1], a.v[1], b);
        }
      }
      __syncwarp();
      if (lane == 0) fcvm_bulk::mbar_arrive(empty + slot);
    }
    if (!diag) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = c0 + 2 * q + i;
          if (col < m) sv[(t * kTile + warp * 16 + 2 * g + e) * m + col] = acc_t[e][i];
        }
    }
    if (t + 1 < hi) {  // the other buffer was last read before the previous tile's sync
      double* const next = xs + static_cast<int>((t + 1 - lo) & 1) * 2 * kTile * kMC;
      ahead.store(next, next + kTile * kMC);
    }
    if (t + 1 == hi || bj + 1 == nb) {  // the run leaves this tile row: its row products out
      if (h == 1) {
#pragma unroll
        for (int s = 0; s < kTileStages; ++s)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            us[(s * kStageRows + rb * 8 + g) * kMC + 2 * q + i] = acc_row[s][i];
      }
      consumers_sync();
      if (h == 0) {
        const long long seg = static_cast<long long>(blockIdx.x) * maxseg + (bi - b_first);
#pragma unroll
        for (int s = 0; s < kTileStages; ++s)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int rt = s * kStageRows + rb * 8 + g, col = c0 + 2 * q + i;
            if (col < m)
              su[(seg * kTile + rt) * m + col] = acc_row[s][i] + us[rt * kMC + 2 * q + i];
          }
      }
#pragma unroll
      for (int s = 0; s < kTileStages; ++s) acc_row[s][0] = acc_row[s][1] = 0.0;
    }
    consumers_sync();  // us and this tile's x buffer free again
    bi = nbi;
    bj = nbj;
  }
}

// The sum pass: y[g, c] for g < n, a block 32 outputs (consecutive (row,
// column) pairs) and a warp each of the kSumParts = 8 residues: warp w adds
// the transposed products of the tiles (a, b) above g's tile row b in its
// tile column, a = w mod 8, in ascending a (a warp's lanes read 32
// consecutive values of a tile's partial); the first warp adds the 8 sums
// in a fixed tree, ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7)), and the row
// products of the runs over tile row b, in run order, to that.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
coarse_sum_kernel(const T* __restrict__ sv, const T* __restrict__ su, T* __restrict__ y, int n,
                  int nb, long long ntiles, int m, int nruns, int maxseg) {
  __shared__ T part[kSumParts][kWarp];
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const long long idx = static_cast<long long>(blockIdx.x) * kWarp + lane;
  const bool valid = idx < static_cast<long long>(n) * m;
  const long long g = valid ? idx / m : 0;
  const int c = valid ? static_cast<int>(idx % m) : 0;
  const int b = static_cast<int>(g / kTile), i = static_cast<int>(g % kTile);
  T v = T(0);
  if (valid) {
    for (int a = w; a < b; a += kSumParts) {
      const long long t = row_start(a, nb) + (b - a);
      v += sv[(t * kTile + i) * m + c];
    }
  }
  part[w][lane] = v;
  __syncthreads();
  if (w != 0 || !valid) return;
  const T vs = ((part[0][lane] + part[4][lane]) + (part[2][lane] + part[6][lane])) +
               ((part[1][lane] + part[5][lane]) + (part[3][lane] + part[7][lane]));
  const long long t0 = row_start(b, nb);
  const long long k_hi = run_of(t0 + (nb - b) - 1, ntiles, nruns);
  T s = T(0);
  for (long long k = run_of(t0, ntiles, nruns); k <= k_hi; ++k) {
    const long long seg = k * maxseg + (b - tile_row(run_start(k, ntiles, nruns), nb));
    s += su[(seg * kTile + i) * m + c];
  }
  y[g * m + c] = s + vs;
}

// Columns a tile pass takes: m up to 8 rounded up to a power of two, else 8.
inline int coarse_chunk(int m) {
  return m >= kMaxChunk ? kMaxChunk : m > 4 ? 8 : m > 2 ? 4 : m;
}

// The tile pass of (T, kMC): on the tensor cores at 8 f64 columns, else on
// the CUDA cores.
template <typename T, int kMC>
constexpr bool coarse_on_mma() {
  return sizeof(T) == 8 && kMC == kMaxChunk;
}

template <typename T, int kMC>
int coarse_runs_mc(long long ntiles, int* nruns) {
  static int resident[fcvm_ring::kMaxDevices];
  if constexpr (coarse_on_mma<T, kMC>())
    return fcvm_ring::persistent_grid(coarse_tiles_mma_kernel, kConsumers + kWarp,
                                      coarse_mma_smem(), ntiles, resident, nruns);
  else
    return fcvm_ring::persistent_grid(coarse_tiles_kernel<T, kMC>, kConsumers + kWarp,
                                      coarse_smem<T, kMC>(), ntiles, resident, nruns);
}

// The tile pass's runs (its grid) and the most tile rows a run touches.
template <typename T>
int coarse_plan(int m, long long n, int* nruns, int* maxseg) {
  const int nb = static_cast<int>((n + kTile - 1) / kTile);
  const long long ntiles = row_start(nb, nb);
  int err = 0;
  switch (coarse_chunk(m)) {
    case 1: err = coarse_runs_mc<T, 1>(ntiles, nruns); break;
    case 2: err = coarse_runs_mc<T, 2>(ntiles, nruns); break;
    case 4: err = coarse_runs_mc<T, 4>(ntiles, nruns); break;
    default: err = coarse_runs_mc<T, 8>(ntiles, nruns); break;
  }
  if (err != 0) return err;
  int most = 1;
  for (long long k = 0; k < *nruns; ++k) {
    const int segs = tile_row(run_start(k + 1, ntiles, *nruns) - 1, nb) -
                     tile_row(run_start(k, ntiles, *nruns), nb) + 1;
    most = segs > most ? segs : most;
  }
  *maxseg = most;
  return 0;
}

template <typename T, int kMC>
int coarse_tiles(const T* tiles, const T* x, T* sv, T* su, int n, int nb, long long ntiles,
                 int m, int c0, int nruns, int maxseg, cudaStream_t s) {
  if constexpr (coarse_on_mma<T, kMC>())
    coarse_tiles_mma_kernel<<<nruns, kConsumers + kWarp, coarse_mma_smem(), s>>>(
        tiles, x, sv, su, n, nb, ntiles, m, c0, maxseg);
  else
    coarse_tiles_kernel<T, kMC><<<nruns, kConsumers + kWarp, coarse_smem<T, kMC>(), s>>>(
        tiles, x, sv, su, n, nb, ntiles, m, c0, maxseg);
  return static_cast<int>(cudaGetLastError());
}

// zc = Kc^-1 x on the packed tiles: the tile pass for each chunk of columns,
// then the sum pass; nruns and maxseg from coarse_plan for the same m.
template <typename T>
int coarse_product(const T* tiles, const T* x, T* y, T* sv, T* su, long long n, int m,
                   int nruns, int maxseg, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>((n + kTile - 1) / kTile);
  const long long ntiles = row_start(nb, nb);
  const int ni = static_cast<int>(n);
  const int mc = coarse_chunk(m);
  for (int c0 = 0; c0 < m; c0 += mc) {
    int err = 0;
    if (mc == 1)
      err = coarse_tiles<T, 1>(tiles, x, sv, su, ni, nb, ntiles, m, c0, nruns, maxseg, s);
    else if (mc == 2)
      err = coarse_tiles<T, 2>(tiles, x, sv, su, ni, nb, ntiles, m, c0, nruns, maxseg, s);
    else if (mc == 4)
      err = coarse_tiles<T, 4>(tiles, x, sv, su, ni, nb, ntiles, m, c0, nruns, maxseg, s);
    else
      err = coarse_tiles<T, 8>(tiles, x, sv, su, ni, nb, ntiles, m, c0, nruns, maxseg, s);
    if (err != 0) return err;
  }
  const long long outs = n * m;
  coarse_sum_kernel<T><<<static_cast<unsigned>((outs + kWarp - 1) / kWarp),
                         kSumThreads, 0, s>>>(sv, su, y, ni, nb, ntiles, m, nruns, maxseg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fcvm_two_level_restrict_f32(const float* r, const float* fixmask,
                                           const float* qmat, const float* pinv, float* z,
                                           float* rc, long long nn, int cs, int ncl, int nm,
                                           void* stream) {
  return restrict_<float>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, nm, stream);
}

extern "C" int fcvm_two_level_restrict_f64(const double* r, const double* fixmask,
                                           const double* qmat, const double* pinv, double* z,
                                           double* rc, long long nn, int cs, int ncl, int nm,
                                           void* stream) {
  return restrict_<double>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, nm, stream);
}

extern "C" int fcvm_two_level_prolong_f32(const float* qmat, const float* zc,
                                          const float* fixmask, const float* z_fine, float* z,
                                          long long nn, int cs, int ncl, int nm, void* stream) {
  return prolong<float>(qmat, zc, fixmask, z_fine, z, nn, cs, ncl, nm, stream);
}

extern "C" int fcvm_two_level_prolong_f64(const double* qmat, const double* zc,
                                          const double* fixmask, const double* z_fine,
                                          double* z, long long nn, int cs, int ncl, int nm,
                                          void* stream) {
  return prolong<double>(qmat, zc, fixmask, z_fine, z, nn, cs, ncl, nm, stream);
}

extern "C" int fcvm_two_level_restrict_block_f32(const float* r, const float* fixmask,
                                                 const float* qmat, const float* pinv, float* z,
                                                 float* rc, long long nn, int cs, int ncl,
                                                 int nm, int m, void* stream) {
  return restrict_block<float>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, nm, m, stream);
}

extern "C" int fcvm_two_level_restrict_block_f64(const double* r, const double* fixmask,
                                                 const double* qmat, const double* pinv,
                                                 double* z, double* rc, long long nn, int cs,
                                                 int ncl, int nm, int m, void* stream) {
  return restrict_block<double>(r, fixmask, qmat, pinv, z, rc, nn, cs, ncl, nm, m, stream);
}

extern "C" int fcvm_two_level_prolong_block_f32(const float* qmat, const float* zc,
                                                const float* fixmask, const float* z_fine,
                                                float* z, long long nn, int cs, int ncl, int nm,
                                                int m, void* stream) {
  return prolong_block<float>(qmat, zc, fixmask, z_fine, z, nn, cs, ncl, nm, m, stream);
}

extern "C" int fcvm_two_level_prolong_block_f64(const double* qmat, const double* zc,
                                                const double* fixmask, const double* z_fine,
                                                double* z, long long nn, int cs, int ncl, int nm,
                                                int m, void* stream) {
  return prolong_block<double>(qmat, zc, fixmask, z_fine, z, nn, cs, ncl, nm, m, stream);
}

extern "C" int fcvm_coarse_plan(int itemsize, int m, long long n, int* nruns, int* maxseg) {
  if (itemsize == 4) return coarse_plan<float>(m, n, nruns, maxseg);
  if (itemsize == 8) return coarse_plan<double>(m, n, nruns, maxseg);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fcvm_coarse_product_f32(const float* tiles, const float* x, float* y, float* sv,
                                       float* su, long long n, int m, int nruns, int maxseg,
                                       void* stream) {
  return coarse_product<float>(tiles, x, y, sv, su, n, m, nruns, maxseg, stream);
}

extern "C" int fcvm_coarse_product_f64(const double* tiles, const double* x, double* y,
                                       double* sv, double* su, long long n, int m, int nruns,
                                       int maxseg, void* stream) {
  return coarse_product<double>(tiles, x, y, sv, su, n, m, nruns, maxseg, stream);
}
