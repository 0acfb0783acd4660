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
// 12 modes a cluster of cs = nn_cl / ncl index-contiguous nodes, and Kc^-1 =
// coarse_inv (nm ncl, nm ncl) in mode-major order (k ncl + i).  The nodes
// past nn (nn_cl >= nn) carry r = 0 and are cut off the output.
//
// Two kernels around the coarse GEMV:
//   1. restrict: one thread block a cluster reads r, fixmask, qmat and (for
//      block Jacobi) pinv once; it writes z = pinv r at its nodes and the
//      cluster's nm mode sums of Q^T (P r) into their mode-major slots of rc,
//      each a fixed-order reduction (per thread over its nodes, then a warp
//      shuffle tree, then over the warps in order) with no atomics;
//   2. zc = coarse_inv rc, the dense GEMV (a plain product outside any
//      kernel in the JAX package too; csrc/ops.cpp calls at::mv, full fp32);
//   3. prolong: one thread a node adds fixmask Q zc at its cluster to z.
// What bounds it: reading coarse_inv (601.6 MB in f32 on the 502,599-dof
// plate's 12,264 coarse dofs) in the GEMV; the two kernels move qmat twice
// (24.1 MB), pinv (6.0 MB) and six vectors of 2 MB.
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
//   2. zc = coarse_inv rc, a dense GEMM (csrc/ops.cpp calls at::mm, full
//      fp32; cholesky_inverse's column-major inverse goes to cuBLAS as it
//      is, transposed, with no copy): coarse_inv is read once for all m
//      columns;
//   3. prolong: one thread a (node, column).
// What bounds it: the GEMM's read of coarse_inv (597 MB in f32 on the
// 451,875-dof beam-column's 12,216 coarse dofs), then qmat twice, pinv, r,
// z and z_fine once each.
// Sums accumulate in the input type, with FMA; nothing is lowered in
// precision.
//
// C interface: returns cudaGetLastError() after each launch (0 = launched);
// pinv == nullptr selects the caller's fine level (z_fine, read by prolong).
// The caller owns all memory (rc and zc are its scratch) and the stream; the
// kernels do not synchronise.  csrc/ops.cpp binds restrict, GEMV and prolong
// to PyTorch as one operator, torch.ops.fcvm.two_level_apply, and the block
// passes around the GEMM as torch.ops.fcvm.two_level_apply_block.

#include <cuda_runtime.h>

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
