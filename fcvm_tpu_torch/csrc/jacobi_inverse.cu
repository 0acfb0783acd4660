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
// One thread a node row, over K8's write-form segment plan of the
// slot-major keys (ops/assembly.py:jacobi_plan: incidence k = slot ne + e):
//   1. the node's incidences in the plan's order, each (element, slot)
//      diagonal block read straight from the element blocks (element e's at
//      column cols[e] when the blocks come in another element order than
//      the plan's, the solve space's, say): element-major
//      (entry (i, j) of element e at i si + j sj + e se, any strides, so the
//      (30, 30, ne) blocks and their (ne, 30, 30) views alike), 9 values;
//      or K1's packed tiles ([t, q, k], e = t tile + k, q the row-major upper
//      index), the 6 upper values, the lower ones their mirror;
//   2. summed from zero in that order, each add rounded on its own: K8's
//      write form's bits (a node no key names sums nothing: 0);
//   3. masked, nodal (m_i m_j) + (1 - m_i) delta_ij, and inverted by the
//      adjugate, det by cofactors, each cofactor divided by det: every
//      product, sum and quotient rounded on its own in the torch tail's
//      order (utils/linalg3.py:det3, inv3), so its bits are the tail's.
// Three forms: fused (1 to 3, the inverses), sum (1 and 2, the nodal blocks,
// which the sharded backend all-reduces) and tail (3 on given nodal blocks).
//
// What bounds it: bytes.  On the plate about 28 MB of diagonal values (9
// of each of 1,179,360 (element, slot) blocks, read at the elements'
// scattered columns), the plan and the mask, and 6 MB of inverses written:
// 0.014 ms at 3.35 TB/s.  Each thread issues its incidences' loads in
// batches of kDepth before their adds, which keeps the order of the adds.
//
// C interface: each entry returns cudaGetLastError() after its launch (0 =
// launched).  The caller owns all memory and the stream; the kernel does
// not synchronise.  csrc/ops.cpp binds it as torch.ops.fcvm.jacobi_inverse.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 4;         // incidences a load batch
constexpr int kNPack = 30 * 31 / 2;

enum Form { kFused = 0, kSum = 1, kTail = 2 };

template <typename T>
struct Args {
  const T* blocks;       // element-major (strides si, sj, se) or packed (tile)
  long long si, sj, se;
  long long tile;        // > 0: the packed tiles (ntiles, 465, tile)
  const int* order;      // the plan: (nsum,), (nu + 1,), (nu,), (nholes,)
  const int* offsets;
  const int* segs;
  const int* holes;
  long long nu, nholes;  // the tail form: nu the rows, no holes
  long long ne;
  const long long* cols; // (ne,): the blocks' column of each plan element, or null
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

__device__ __forceinline__ int packed_index(int i, int j) {
  return i * 30 - i * (i - 1) / 2 + (j - i);
}

// the 3x3 diagonal block of incidence k (slot k / ne of element k % ne)
template <typename T>
__device__ __forceinline__ void load_block(const Args<T>& a, int k, T (&v)[9]) {
  const long long slot = k / a.ne, pe = k - slot * a.ne;
  const long long e = a.cols ? __ldg(a.cols + pe) : pe;
  if (a.tile > 0) {
    const T* base = a.blocks + (e / a.tile) * kNPack * a.tile + e % a.tile;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = r; c < 3; ++c) {
        const int i = 3 * static_cast<int>(slot);
        v[3 * r + c] = __ldg(base + packed_index(i + r, i + c) * a.tile);
        v[3 * c + r] = v[3 * r + c];
      }
  } else {
    const T* base = a.blocks + 3 * slot * (a.si + a.sj) + e * a.se;
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 * r + c] = __ldg(base + r * a.si + c * a.sj);
  }
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

template <typename T, int kForm>
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
#pragma unroll
    for (int q = 0; q < 9; ++q) s[q] = T(0);
    if (t < a.nu) {
      row = a.segs[t];
      const int begin = a.offsets[t], end = a.offsets[t + 1];
      for (int p = begin; p < end; p += kDepth) {
        const int n = end - p;
        T v[kDepth][9];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) load_block(a, a.order[d < n ? p + d : begin], v[d]);
#pragma unroll
        for (int d = 0; d < kDepth; ++d)
          if (d < n) {
#pragma unroll
            for (int q = 0; q < 9; ++q) s[q] = add_rn(s[q], v[d][q]);
          }
      }
    } else {
      row = a.holes[t - a.nu];
    }
  }
  if (kForm == kSum) {
#pragma unroll
    for (int q = 0; q < 9; ++q) a.out[9 * row + q] = s[q];
  } else {
    invert(s, a.fixmask, row, a.out);
  }
}

template <typename T>
int run(int form, const Args<T>& a, void* stream) {
  const long long units = a.nu + a.nholes;
  if (units <= 0) return 0;
  const long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  if (form == kFused)
    jacobi_kernel<T, kFused><<<grid, kThreads, 0, s>>>(a);
  else if (form == kSum)
    jacobi_kernel<T, kSum><<<grid, kThreads, 0, s>>>(a);
  else if (form == kTail)
    jacobi_kernel<T, kTail><<<grid, kThreads, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(int form, const T* blocks, long long si, long long sj, long long se, long long tile,
          const int* order, const int* offsets, const int* segs, const int* holes, long long nu,
          long long nholes, long long ne, const long long* cols, const T* fixmask,
          const T* nodal, T* out, void* stream) {
  const Args<T> a{blocks, si, sj,     se, tile, order,   offsets, segs,
                  holes,  nu, nholes, ne, cols, fixmask, nodal,   out};
  return run<T>(form, a, stream);
}

}  // namespace

// form: 0 fused (blocks -> inverses), 1 sum (blocks -> nodal blocks), 2 tail
// (nodal -> inverses: nu the rows, the plan and blocks unread).  tile > 0:
// blocks are K1's packed tiles; else element-major with strides si, sj, se
// (in elements).  The plan: K8's write form of the slot-major keys of ne
// elements; cols (ne,) int64 or null: the blocks' element of each.
extern "C" int fcvm_jacobi_inverse_f32(int form, const float* blocks, long long si, long long sj,
                                       long long se, long long tile, const int* order,
                                       const int* offsets, const int* segs, const int* holes,
                                       long long nu, long long nholes, long long ne,
                                       const long long* cols, const float* fixmask,
                                       const float* nodal, float* out, void* stream) {
  return entry<float>(form, blocks, si, sj, se, tile, order, offsets, segs, holes, nu, nholes,
                      ne, cols, fixmask, nodal, out, stream);
}

extern "C" int fcvm_jacobi_inverse_f64(int form, const double* blocks, long long si,
                                       long long sj, long long se, long long tile,
                                       const int* order, const int* offsets, const int* segs,
                                       const int* holes, long long nu, long long nholes,
                                       long long ne, const long long* cols,
                                       const double* fixmask, const double* nodal, double* out,
                                       void* stream) {
  return entry<double>(form, blocks, si, sj, se, tile, order, offsets, segs, holes, nu, nholes,
                       ne, cols, fixmask, nodal, out, stream);
}
