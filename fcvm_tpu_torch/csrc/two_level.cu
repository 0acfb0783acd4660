// K4: the fused two-level preconditioner apply on a vector, for Hopper (sm_90a).
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
// Sums accumulate in the input type, with FMA; nothing is lowered in
// precision.
//
// C interface: returns cudaGetLastError() after each launch (0 = launched);
// pinv == nullptr selects the caller's fine level (z_fine, read by prolong).
// The caller owns all memory (rc and zc are its scratch) and the stream; the
// kernels do not synchronise.  csrc/ops.cpp binds restrict, GEMV and prolong
// to PyTorch as one operator, torch.ops.fcvm.two_level_apply.

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
