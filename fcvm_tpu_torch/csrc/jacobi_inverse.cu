// K5: the block-Jacobi rebuild, for Hopper (sm_90a): each node's 3x3
// diagonal block of K_hat summed from its elements' blocks, masked to the
// identity on fixed dofs and inverted, in one node pass.
//
// Replaces the XLA-lowered block_jacobi_inverse_blocks of the JAX package
// (fcvm_tpu/ops/assembly.py:614-633: the diagonal slice of the element
// blocks, its segment_sum, the mask and utils/linalg3.py's inv3); on the
// port's side the slice, K8's write form and the torch tail of
// ops/kernels.py:jacobi_inverse_ref.
//
// It reads K3's compact diagonal (csrc/form_blocks.cu, diag): for incidence
// k = slot ne + e the 6 upper values of element e's diagonal block (slot,
// slot), padded to 8, one 32-byte sector in float32 (64 bytes in float64).
// One thread a unit (a node row) of K8's write-form segment plan of the
// slot-major keys (ops/assembly.py:jacobi_plan), in row order, so a warp's
// neighbouring nodes share elements and their sectors' cache lines:
//   1. the node's incidences in the plan's order, each one sector read
//      (element e's at cols[e] when the diagonal comes in another element
//      order than the plan's, the solve space's, say);
//   2. summed from zero in that order, each add rounded on its own: K8's
//      write form's bits (the lower values the upper ones' mirror, as the
//      blocks are exactly symmetric; a node no key names sums nothing: 0);
//   3. masked, nodal (m_i m_j) + (1 - m_i) delta_ij, and inverted by the
//      adjugate, det by cofactors, each cofactor divided by det: every
//      product, sum and quotient rounded on its own in the torch tail's
//      order (utils/linalg3.py:det3, inv3), so its bits are the tail's.
// Three forms: fused (1 to 3, the inverses), sum (1 and 2, the nodal blocks,
// which the sharded backend all-reduces) and tail (3 on given nodal blocks).
//
// What bounds it: bytes.  On the plate about 28 MB of diagonal values (6
// of each of 1,179,360 (element, slot) blocks, in one sector each), the plan
// and the mask, and 6 MB of inverses written: 0.013 ms at 3.35 TB/s.  Each
// thread issues its incidences' loads in batches of kDepth before their
// adds, which keeps the order of the adds.  A warp runs as long as its
// busiest lane; taking the units longest first (the plan's walk) evens the
// lanes' counts but scatters their reads and writes, and was slower
// (csrc/jacobi_inverse_probe.cu, fcvm_tpu_torch/tools/k3_probe.py).
//
// C interface: each entry returns cudaGetLastError() after its launch (0 =
// launched).  The caller owns all memory and the stream; the kernel does
// not synchronise.  csrc/ops.cpp binds it as torch.ops.fcvm.jacobi_inverse.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 4;  // incidences a load batch
constexpr int kDiag = 8;   // the diagonal's values an incidence, padded

enum Form { kFused = 0, kSum = 1, kTail = 2 };

template <typename T>
struct Args {
  const T* diag;         // (10, ne, 8): K3's compact diagonal
  const int* order;      // the plan: (nsum,), (nu + 1,), (nu,), (nholes,)
  const int* offsets;
  const int* segs;
  const int* holes;
  const int* walk;       // kWalk: the units (3, nu), each one's begin, end and row
  long long nu, nholes;  // the tail form: nu the rows, no holes
  long long ne;
  const long long* cols; // (ne,): the diagonal's element of each plan element, or null
  const T* fixmask;      // (3 rows,): fused, tail
  const T* nodal;        // (rows, 3, 3): tail
  T* out;                // (rows, 3, 3): the nodal blocks (sum) or their inverses
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// the 6 upper values of incidence k's diagonal block (slot k / ne of element k % ne)
__device__ __forceinline__ void load_sector(const float* p, float (&v)[6]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  const float2 y = __ldg(reinterpret_cast<const float2*>(p + 4));
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w, v[4] = y.x, v[5] = y.y;
}
__device__ __forceinline__ void load_sector(const double* p, double (&v)[6]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const double2 x = __ldg(reinterpret_cast<const double2*>(p) + q);
    v[2 * q] = x.x, v[2 * q + 1] = x.y;
  }
}

template <typename T>
__device__ __forceinline__ void load_block(const Args<T>& a, int k, T (&v)[6]) {
  const long long slot = k / a.ne, pe = k - slot * a.ne;
  const long long e = a.cols ? __ldg(a.cols + pe) : pe;
  load_sector(a.diag + (slot * a.ne + e) * kDiag, v);
}

// the tail: mask, then the inverse by the adjugate (utils/linalg3.py)
template <typename T>
__device__ __forceinline__ void invert(const T (&s)[9], const T* fixmask, long long row,
                                       T* out) {
  T m[3], a[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) m[i] = fixmask[3 * row + i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      a[i][j] = add_rn(mul_rn(s[3 * i + j], mul_rn(m[i], m[j])),
                       mul_rn(sub_rn(T(1), m[i]), i == j ? T(1) : T(0)));
  auto p3 = [](T x, T y, T z) { return mul_rn(mul_rn(x, y), z); };
  auto cof = [](T x, T y, T z, T w) { return sub_rn(mul_rn(x, y), mul_rn(z, w)); };
  const T det = sub_rn(add_rn(sub_rn(add_rn(sub_rn(p3(a[0][0], a[1][1], a[2][2]),
                                                   p3(a[0][0], a[1][2], a[2][1])),
                                            p3(a[0][2], a[1][0], a[2][1])),
                                     p3(a[0][2], a[1][1], a[2][0])),
                              p3(a[0][1], a[1][2], a[2][0])),
                       p3(a[0][1], a[1][0], a[2][2]));
  const T c[9] = {
      cof(a[1][1], a[2][2], a[2][1], a[1][2]), cof(a[0][2], a[2][1], a[0][1], a[2][2]),
      cof(a[0][1], a[1][2], a[0][2], a[1][1]), cof(a[1][2], a[2][0], a[1][0], a[2][2]),
      cof(a[0][0], a[2][2], a[0][2], a[2][0]), cof(a[1][0], a[0][2], a[0][0], a[1][2]),
      cof(a[1][0], a[2][1], a[2][0], a[1][1]), cof(a[2][0], a[0][1], a[0][0], a[2][1]),
      cof(a[0][0], a[1][1], a[1][0], a[0][1])};
#pragma unroll
  for (int q = 0; q < 9; ++q) out[9 * row + q] = div_rn(c[q], det);
}

template <typename T, int kForm, bool kWalk>
__global__ void __launch_bounds__(kThreads) jacobi_kernel(const Args<T> a) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.nu + a.nholes) return;
  T s[9];
  long long row;
  if (kForm == kTail) {
    row = t;
#pragma unroll
    for (int q = 0; q < 9; ++q) s[q] = a.nodal[9 * row + q];
  } else {
    T u[6];  // the upper values' sums, (0,0) (0,1) (0,2) (1,1) (1,2) (2,2)
#pragma unroll
    for (int q = 0; q < 6; ++q) u[q] = T(0);
    if (t < a.nu) {
      const int begin = kWalk ? a.walk[t] : a.offsets[t];
      const int end = kWalk ? a.walk[a.nu + t] : a.offsets[t + 1];
      row = kWalk ? a.walk[2 * a.nu + t] : a.segs[t];
      for (int p = begin; p < end; p += kDepth) {
        const int n = end - p;
        T v[kDepth][6];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) load_block(a, a.order[d < n ? p + d : begin], v[d]);
#pragma unroll
        for (int d = 0; d < kDepth; ++d)
          if (d < n) {
#pragma unroll
            for (int q = 0; q < 6; ++q) u[q] = add_rn(u[q], v[d][q]);
          }
      }
    } else {
      row = a.holes[t - a.nu];
    }
    s[0] = u[0], s[1] = u[1], s[2] = u[2];
    s[3] = u[1], s[4] = u[3], s[5] = u[4];
    s[6] = u[2], s[7] = u[4], s[8] = u[5];
  }
  if (kForm == kSum) {
#pragma unroll
    for (int q = 0; q < 9; ++q) a.out[9 * row + q] = s[q];
  } else {
    invert(s, a.fixmask, row, a.out);
  }
}

template <typename T, bool kWalk = false>
int run(int form, const Args<T>& a, void* stream) {
  const long long units = a.nu + a.nholes;
  if (units <= 0) return 0;
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  if (form == kFused)
    jacobi_kernel<T, kFused, kWalk><<<grid, kThreads, 0, s>>>(a);
  else if (form == kSum)
    jacobi_kernel<T, kSum, kWalk><<<grid, kThreads, 0, s>>>(a);
  else if (form == kTail)
    jacobi_kernel<T, kTail, kWalk><<<grid, kThreads, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(int form, const T* diag, const int* order, const int* offsets, const int* segs,
          const int* holes, long long nu, long long nholes, long long ne,
          const long long* cols, const T* fixmask, const T* nodal, T* out, void* stream) {
  const Args<T> a{diag,   order, offsets, segs, holes, nullptr,
                  nu,     nholes, ne,     cols, fixmask, nodal, out};
  return run<T>(form, a, stream);
}

}  // namespace

// form: 0 fused (diag -> inverses), 1 sum (diag -> nodal blocks), 2 tail
// (nodal -> inverses: nu the rows, the plan and diag unread).  diag: K3's
// compact diagonal (10, ne, 8) (16-byte aligned).  The plan: K8's write
// form of the slot-major keys of ne elements (order, offsets, segs,
// holes); cols (ne,) int64 or null: the diagonal's element of each.
extern "C" int fcvm_jacobi_inverse_f32(int form, const float* diag, const int* order,
                                       const int* offsets, const int* segs, const int* holes,
                                       long long nu, long long nholes, long long ne,
                                       const long long* cols, const float* fixmask,
                                       const float* nodal, float* out, void* stream) {
  return entry<float>(form, diag, order, offsets, segs, holes, nu, nholes, ne, cols, fixmask,
                      nodal, out, stream);
}

extern "C" int fcvm_jacobi_inverse_f64(int form, const double* diag, const int* order,
                                       const int* offsets, const int* segs, const int* holes,
                                       long long nu, long long nholes, long long ne,
                                       const long long* cols, const double* fixmask,
                                       const double* nodal, double* out, void* stream) {
  return entry<double>(form, diag, order, offsets, segs, holes, nu, nholes, ne, cols, fixmask,
                       nodal, out, stream);
}
