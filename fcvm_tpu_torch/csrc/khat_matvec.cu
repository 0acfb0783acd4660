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
// for K given by its element blocks esm_t (30, 30, ne), element-major, and
// the element node table elnodes_t (10, ne) int32, element-major.
//
// Two passes, no atomics, so two calls on the same inputs give the same bits:
//   1. the element pass (csrc/element_pass.cuh, K0's ring): each thread
//      gathers its element's 30 values of P x (x) at its 10 nodes and the
//      blocks stream through the cp.async ring; it writes fe (30, ne) in
//      K0's layout;
//   2. the node pass: one thread a node sums the node's incident rows of fe
//      in the fixed order of the incidence table, a CSR over nodes
//      (offsets (nn + 1), and pos: each incidence's offset 3 slot ne + e of
//      its first component in fe), then applies the mask and the identity
//      on fixed dofs.  A node with no incident element (the padding) gets
//      (1 - P) x, which is 0 there.
// What bounds it: reading the blocks (3600 bytes an element in f32, 7200 in
// f64), as K0; the rest is the node table, x and the mask at the elements'
// nodes, the incidence table, and fe written once and read once (14 MB in
// f32 on the 502,599-dof plate, mostly out of the 50 MB L2).
// Each element sum runs over j in order 0..29, each node sum over its
// incidences in table order.  Sums accumulate in the input type, with FMA;
// nothing is lowered in precision.
//
// C interface: returns cudaGetLastError() after the launches (0 = launched);
// fixmask == nullptr selects the raw form.  The caller owns all memory (fe is
// its scratch) and the stream; the kernels do not synchronise.  csrc/ops.cpp
// binds it to PyTorch as torch.ops.fcvm.khat_matvec.

#include <cuda_runtime.h>

#include "element_pass.cuh"

namespace {

constexpr int kNodes = 10;  // tet10
constexpr int kNodeThreads = 256;

// The element's 30 values of P x (kMasked) or x, gathered at its nodes.
template <typename T, bool kMasked>
struct GatherU {
  const int* __restrict__ elnodes_t;
  const T* __restrict__ x;
  const T* __restrict__ fixmask;

  __device__ __forceinline__ void operator()(long long e, long long ne,
                                             T (&u)[fcvm_element::kDofs]) const {
#pragma unroll
    for (int n = 0; n < kNodes; ++n) {
      const long long d = 3LL * elnodes_t[n * ne + e];
#pragma unroll
      for (int c = 0; c < 3; ++c) u[3 * n + c] = kMasked ? fixmask[d + c] * x[d + c] : x[d + c];
    }
  }
};

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
  const int end = offsets[n + 1];
  for (int p = offsets[n]; p < end; ++p) {
    const T* f = fe + pos[p];
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] += f[c * ne];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const long long d = 3 * n + c;
    y[d] = kMasked ? fixmask[d] * s[c] + (T(1) - fixmask[d]) * x[d] : s[c];
  }
}

template <typename T, bool kMasked>
int run(const T* esm_t, const int* elnodes_t, const int* offsets, const int* pos, const T* x,
        const T* fixmask, T* fe, T* y, long long ne, long long nn, void* stream) {
  const int err = fcvm_element::launch<T>(esm_t, GatherU<T, kMasked>{elnodes_t, x, fixmask},
                                          fcvm_element::DenseStore<T>{fe}, ne, stream);
  if (err != 0 || nn <= 0) return err;
  const long long blocks = (nn + kNodeThreads - 1) / kNodeThreads;
  node_sum_kernel<T, kMasked><<<static_cast<unsigned>(blocks), kNodeThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(fe, offsets, pos, x,
                                                                     fixmask, y, nn, ne);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* esm_t, const int* elnodes_t, const int* offsets, const int* pos,
             const T* x, const T* fixmask, T* fe, T* y, long long ne, long long nn,
             void* stream) {
  return fixmask != nullptr
             ? run<T, true>(esm_t, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, stream)
             : run<T, false>(esm_t, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, stream);
}

}  // namespace

extern "C" int fcvm_khat_matvec_f32(const float* esm_t, const int* elnodes_t,
                                    const int* offsets, const int* pos, const float* x,
                                    const float* fixmask, float* fe, float* y, long long ne,
                                    long long nn, void* stream) {
  return dispatch<float>(esm_t, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, stream);
}

extern "C" int fcvm_khat_matvec_f64(const double* esm_t, const int* elnodes_t,
                                    const int* offsets, const int* pos, const double* x,
                                    const double* fixmask, double* fe, double* y, long long ne,
                                    long long nn, void* stream) {
  return dispatch<double>(esm_t, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, stream);
}
