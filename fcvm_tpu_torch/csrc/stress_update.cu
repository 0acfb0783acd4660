// K2: the stress update and internal force, for Hopper (sm_90a).
//
// Replaces the XLA-lowered per-element stress update of the JAX package:
// _element_stress_update_hp, update_stress_load and internal_force_from_stress
// (fcvm_tpu/ops/stress_update.py:66-195), with radial_return and von_mises
// (fcvm_tpu/ops/material.py:52-88) and tet10_element_geometry
// (fcvm_tpu/ops/elements.py:126).  For each element e and Gauss point g, on
// the element's 10 nodes (moved by the step-start disp under large_disp):
//
//   J = sum_k x_k (x) dN_k/dxi, det J and J^-1 by the adjugate
//   (fcvm_tpu_torch/utils/linalg3.py), dN_k/dx = J^-T dN_k/dxi;
//   deps = B du, taken from dN/dx directly (B is never formed; Voigt
//   [xx, yy, zz, xy, zx, yz], engineering shears, ops/elements.py:99-112);
//   under large_disp F = I + grad du and sig_c = F sig_old F^T / det F;
//   sig_test = sig_c + D deps, D one (6, 6) or one per element;
//   the radial return with hardening (ops/material.py:radial_return):
//   sig_new, and pgp = (svm >= sig_yield);
//   elv = sum_g B_g^T sig_new w_g |det J_g|, times weights[e] when given.
//
// The given-stress form (internal_force_from_stress) is the same kernel with
// the stress given (kGiven): its elv, no trial stress and no return.  The
// node sum of elv is K8's (csrc/segment_sum.cu), which the caller launches.
//
// What bounds it: bytes.  Per element it reads 10 node indices (int64, 80
// B), the 10 nodes' coordinates and increments (and disp under large_disp),
// 24 stresses and 4 yield stresses, and writes 24 + 24 stresses, 4 flags and
// 30 forces: about 540 B in float32 against about 2,400 flops, so the
// card's 3.35 TB/s is the bound (about 64 MB, 0.019 ms, on the plate's
// 117,936 elements; the wrapper's caller computes it from the arrays).
// The design: a thread for each (element, Gauss point), 64 elements a
// block, so one Gauss point's state (J, J^-1, deps, F, the stresses: about
// 40 values) lives in registers and the (ne, 4, 6, 30) B of the plain
// version is never written.  dN/dx is recomputed from J^-1 and the
// shared-memory table where it is needed, not held (30 registers).  The 4
// threads of an element read the same node rows (one line fetch serves
// them) and the stresses as 8- or 16-byte pairs, and add their elv rows by
// two shuffles in a fixed order, (g0 + g1) + (g2 + g3), which leaves the same
// sum in all four (addition commutes), so two launches give the same bits.
// Products are FMAs on the CUDA cores, no tensor cores; division and sqrt
// stay IEEE (built without fast math): the radial return's factor and its
// >= test read them.
//
// C interface: returns cudaGetLastError() after the launch (0 = launched).
// The caller owns all memory and the stream; the kernel does not
// synchronise.  csrc/ops.cpp binds it as torch.ops.fcvm.stress_update.

#include <cuda_runtime.h>

namespace {

constexpr int kNodes = 10;
constexpr int kGauss = 4;
constexpr int kTable = kGauss * 3 * kNodes;
constexpr int kThreads = 256;  // 64 elements a block

// dN_k/dxi_j at the 4 Gauss points of the tet10 rule, [g][j][k], as
// fcvm_tpu_torch/ops/elements.py (DSHP10_AT_GP) computes them in float64
// (shortest round-trip digits: the same doubles)
__constant__ double kDshp[kTable] = {
    -1.3416407864998683, -0.447213595499956, 0.0, 0.0, 1.7888543819998244, 0.552786404500044,
    -0.552786404500044, -0.552786404500044, 0.552786404500044, 0.0,
    -1.3416407864998683, 0.0, -0.447213595499956, 0.0, -0.552786404500044, 0.552786404500044,
    1.788854381999824, -0.552786404500044, 0.0, 0.552786404500044,
    -1.3416407864998683, 0.0, 0.0, -0.447213595499956, -0.552786404500044, 0.0,
    -0.552786404500044, 1.7888543819998242, 0.552786404500044, 0.552786404500044,
    0.44721359549995976, 1.3416407864998718, 0.0, 0.0, -1.7888543819998315, 0.552786404500044,
    -0.552786404500044, -0.552786404500044, 0.552786404500044, 0.0,
    0.44721359549995976, 0.0, -0.447213595499956, 0.0, -2.341640786499872, 2.341640786499872,
    -3.885780586188048e-15, -0.552786404500044, 0.0, 0.552786404500044,
    0.44721359549995976, 0.0, 0.0, -0.447213595499956, -2.341640786499872, 0.0,
    -0.552786404500044, -3.774758283725532e-15, 2.341640786499872, 0.552786404500044,
    0.44721359549995976, -0.447213595499956, 0.0, 0.0, -3.6637359812630166e-15, 2.341640786499872,
    -2.341640786499872, -0.552786404500044, 0.552786404500044, 0.0,
    0.44721359549995976, 0.0, 1.3416407864998718, 0.0, -0.552786404500044, 0.552786404500044,
    -1.7888543819998315, -0.552786404500044, 0.0, 0.552786404500044,
    0.44721359549995976, 0.0, 0.0, -0.447213595499956, -0.552786404500044, 0.0,
    -2.341640786499872, -3.774758283725532e-15, 0.552786404500044, 2.341640786499872,
    0.44721359549995965, -0.447213595499956, 0.0, 0.0, -3.552713678800501e-15, 0.552786404500044,
    -0.552786404500044, -2.341640786499872, 2.341640786499872, 0.0,
    0.44721359549995965, 0.0, -0.447213595499956, 0.0, -0.552786404500044, 0.552786404500044,
    -3.9968028886505635e-15, -2.341640786499872, 0.0, 2.341640786499872,
    0.44721359549995965, 0.0, 0.0, 1.3416407864998718, -0.552786404500044, 0.0,
    -0.552786404500044, -1.7888543819998315, 0.552786404500044, 0.552786404500044,
};
constexpr double kWeight = 0.041666666666667;  // each Gauss point's weight (W10)

template <typename T>
struct Args {
  const T* coords;           // (nn, 3)
  const long long* elnodes;  // (ne, 10)
  const T* disp;             // (3 n,), read under large_disp
  const T* du;               // (3 n,); null in the given-stress form
  const T* sig;              // (ne, 4, 6): sig_old, or the given stress
  const T* sig_yield;        // (ne, 4)
  const T* dmat;             // (6, 6), or (ne, 6, 6) with dstride 36
  long long dstride;
  const T* g;                // (ne,) shear moduli, or null: g_s
  const T* h3g;              // (ne,) H + 3 G, or null: h3g_s
  T g_s, h3g_s;
  const T* weights;          // (ne,), or null
  T* sig_new;                // (ne, 4, 6)
  T* sig_test;               // (ne, 4, 6)
  unsigned char* pgp;        // (ne, 4)
  T* elv;                    // (ne, 30)
  long long ne;
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// a Gauss point's 6 stresses: 8-byte pairs in float32 (24 B a point), 16-byte
// in float64 (48 B), aligned where the array is 16-byte aligned
template <typename T>
__device__ __forceinline__ void load6(const T* p, T (&s)[6]) {
  using P = typename Pair<T>::type;
  const P* q = reinterpret_cast<const P*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const P v = __ldg(q + i);
    s[2 * i] = v.x;
    s[2 * i + 1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void store6(T* p, const T (&s)[6]) {
  using P = typename Pair<T>::type;
  P* q = reinterpret_cast<P*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = P{s[2 * i], s[2 * i + 1]};
}

// the determinant by cofactors, in utils/linalg3.py:det3's order
template <typename T>
__device__ __forceinline__ T det3(const T (&a)[3][3]) {
  return a[0][0] * a[1][1] * a[2][2] - a[0][0] * a[1][2] * a[2][1] +
         a[0][2] * a[1][0] * a[2][1] - a[0][2] * a[1][1] * a[2][0] +
         a[0][1] * a[1][2] * a[2][0] - a[0][1] * a[1][0] * a[2][2];
}

// dN_k/dx_i = sum_j Ji[j][i] dN_k/dxi_j at this thread's Gauss point
template <typename T>
__device__ __forceinline__ void dndx(const T (&ji)[3][3], const T* dn, int k, T (&d)[3]) {
  const T a = dn[k], b = dn[kNodes + k], c = dn[2 * kNodes + k];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = ji[0][i] * a + ji[1][i] * b + ji[2][i] * c;
}

template <typename T, bool kGiven, bool kLarge>
__global__ void __launch_bounds__(kThreads) stress_update_kernel(const Args<T> a) {
  __shared__ T table[kTable];
  for (int i = threadIdx.x; i < kTable; i += kThreads) table[i] = static_cast<T>(kDshp[i]);
  __syncthreads();
  const long long e = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 2;
  const int g = threadIdx.x & 3;
  if (e >= a.ne) return;  // an element's four threads leave together
  const unsigned group = 0xFu << (threadIdx.x & 28);  // this element's lanes
  const T* dn = table + g * 3 * kNodes;
  const long long gp = e * kGauss + g;

  int node[kNodes];
#pragma unroll
  for (int k = 0; k < kNodes; ++k) node[k] = static_cast<int>(__ldg(a.elnodes + e * kNodes + k));

  // J[i][j] = sum_k x_k[i] dN_k/dxi_j
  T jac[3][3] = {};
#pragma unroll
  for (int k = 0; k < kNodes; ++k) {
    const long long n = 3LL * node[k];
    T x[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x[i] = __ldg(a.coords + n + i);
      if (kLarge) x[i] += __ldg(a.disp + n + i);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) jac[i][j] = x[i] * dn[j * kNodes + k] + jac[i][j];
  }
  const T det = det3(jac);
  T ji[3][3];
  {
    const T(&m)[3][3] = jac;
    ji[0][0] = (m[1][1] * m[2][2] - m[2][1] * m[1][2]) / det;
    ji[0][1] = (m[0][2] * m[2][1] - m[0][1] * m[2][2]) / det;
    ji[0][2] = (m[0][1] * m[1][2] - m[0][2] * m[1][1]) / det;
    ji[1][0] = (m[1][2] * m[2][0] - m[1][0] * m[2][2]) / det;
    ji[1][1] = (m[0][0] * m[2][2] - m[0][2] * m[2][0]) / det;
    ji[1][2] = (m[1][0] * m[0][2] - m[0][0] * m[1][2]) / det;
    ji[2][0] = (m[1][0] * m[2][1] - m[2][0] * m[1][1]) / det;
    ji[2][1] = (m[2][0] * m[0][1] - m[0][0] * m[2][1]) / det;
    ji[2][2] = (m[0][0] * m[1][1] - m[1][0] * m[0][1]) / det;
  }

  T s[6];
  load6(a.sig + gp * 6, s);
  if (!kGiven) {
    // deps = B du and, under large_disp, grad du [a][b] = sum_k du_k[a] dN_k/dx_b
    T eps[6] = {};
    T grad[3][3] = {};
#pragma unroll
    for (int k = 0; k < kNodes; ++k) {
      T d[3];
      dndx(ji, dn, k, d);
      const long long n = 3LL * node[k];
      const T u0 = __ldg(a.du + n), u1 = __ldg(a.du + n + 1), u2 = __ldg(a.du + n + 2);
      eps[0] += d[0] * u0;
      eps[1] += d[1] * u1;
      eps[2] += d[2] * u2;
      eps[3] += d[1] * u0 + d[0] * u1;
      eps[4] += d[2] * u0 + d[0] * u2;
      eps[5] += d[2] * u1 + d[1] * u2;
      if (kLarge) {
        const T u[3] = {u0, u1, u2};
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c) grad[r][c] += u[r] * d[c];
      }
    }
    if (kLarge) {
      // sig_c = F sig F^T / det F, F = I + grad du
      T f[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) f[r][c] = (r == c ? T(1) : T(0)) + grad[r][c];
      const T st[3][3] = {{s[0], s[3], s[4]}, {s[3], s[1], s[5]}, {s[4], s[5], s[2]}};
      T fs[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          fs[r][c] = f[r][0] * st[0][c] + f[r][1] * st[1][c] + f[r][2] * st[2][c];
      const T detf = det3(f);
      // Voigt [xx, yy, zz, xy, zx, yz]: the rows and columns (r, c) of
      // (0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)
#pragma unroll
      for (int v = 0; v < 6; ++v) {
        const int r = v < 3 ? v : (v == 5 ? 1 : 0), c = v < 3 ? v : (v == 3 ? 1 : 2);
        s[v] = (fs[r][0] * f[c][0] + fs[r][1] * f[c][1] + fs[r][2] * f[c][2]) / detf;
      }
    }
    // the trial stress sig_c + D deps
    const T* dm = a.dmat + e * a.dstride;
    T t[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < 6; ++c) acc += __ldg(dm + r * 6 + c) * eps[c];
      t[r] = s[r] + acc;
    }
    // the radial return (ops/material.py:radial_return)
    const T p = (t[0] + t[1] + t[2]) / T(3);
    T dev[6] = {t[0] - p, t[1] - p, t[2] - p, t[3], t[4], t[5]};
    const T svm = sqrt(T(1.5) * (dev[0] * dev[0] + dev[1] * dev[1] + dev[2] * dev[2]) +
                       T(3) * (dev[3] * dev[3] + dev[4] * dev[4] + dev[5] * dev[5]));
    const T sy = __ldg(a.sig_yield + gp);
    const bool plastic = svm >= sy;
    const T gs = a.g ? __ldg(a.g + e) : a.g_s;
    const T h3g = a.h3g ? __ldg(a.h3g + e) : a.h3g_s;
    const T safe = svm == T(0) ? T(1) : svm;
    const T fac = plastic ? T(1) - (T(1) - sy / safe) * T(3) * gs / h3g : T(1);
#pragma unroll
    for (int v = 0; v < 6; ++v) s[v] = dev[v] * fac + (v < 3 ? p : T(0));
    store6(a.sig_test + gp * 6, t);
    store6(a.sig_new + gp * 6, s);
    a.pgp[gp] = plastic ? 1 : 0;
  }

  // elv = sum_g B_g^T sig w_g |det J_g|, the four Gauss points added by two
  // shuffles; thread g < 3 writes component g of each node
  const T scale = static_cast<T>(kWeight) * fabs(det);
  const T wt = a.weights ? __ldg(a.weights + e) : T(1);
  T* out = a.elv + e * (3 * kNodes);
#pragma unroll
  for (int k = 0; k < kNodes; ++k) {
    T d[3];
    dndx(ji, dn, k, d);
    T q[3] = {(d[0] * s[0] + d[1] * s[3] + d[2] * s[4]) * scale,
              (d[1] * s[1] + d[0] * s[3] + d[2] * s[5]) * scale,
              (d[2] * s[2] + d[0] * s[4] + d[1] * s[5]) * scale};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[c] += __shfl_xor_sync(group, q[c], 1);
      q[c] += __shfl_xor_sync(group, q[c], 2);
      if (a.weights) q[c] *= wt;
    }
    if (g < 3) out[3 * k + g] = g == 0 ? q[0] : (g == 1 ? q[1] : q[2]);
  }
}

template <typename T, bool kGiven, bool kLarge>
int launch(const Args<T>& a, cudaStream_t stream) {
  const long long blocks = (a.ne * kGauss + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  stress_update_kernel<T, kGiven, kLarge>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const Args<T>& a, bool large_disp, void* stream) {
  if (a.ne <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool given = a.du == nullptr;
  if (given) return large_disp ? launch<T, true, true>(a, s) : launch<T, true, false>(a, s);
  return large_disp ? launch<T, false, true>(a, s) : launch<T, false, false>(a, s);
}

template <typename T>
int entry(const T* coords, const long long* elnodes, const T* disp, const T* du, const T* sig,
          const T* sig_yield, const T* dmat, long long dstride, const T* g, const T* h3g,
          double g_s, double h3g_s, const T* weights, T* sig_new, T* sig_test,
          unsigned char* pgp, T* elv, long long ne, int large_disp, void* stream) {
  const Args<T> a{coords, elnodes, disp,    du,      sig,      sig_yield,
                  dmat,   dstride, g,       h3g,     static_cast<T>(g_s),
                  static_cast<T>(h3g_s),    weights, sig_new,  sig_test,
                  pgp,    elv,     ne};
  return run<T>(a, large_disp != 0, stream);
}

}  // namespace

// du null: the given-stress form (sig is the stress; only elv is written).
// g or h3g null: their scalars g_s and h3g_s, in the kernel's type.
extern "C" int fcvm_stress_update_f32(const float* coords, const long long* elnodes,
                                      const float* disp, const float* du, const float* sig,
                                      const float* sig_yield, const float* dmat,
                                      long long dstride, const float* g, const float* h3g,
                                      double g_s, double h3g_s, const float* weights,
                                      float* sig_new, float* sig_test, unsigned char* pgp,
                                      float* elv, long long ne, int large_disp, void* stream) {
  return entry<float>(coords, elnodes, disp, du, sig, sig_yield, dmat, dstride, g, h3g, g_s,
                      h3g_s, weights, sig_new, sig_test, pgp, elv, ne, large_disp, stream);
}

extern "C" int fcvm_stress_update_f64(const double* coords, const long long* elnodes,
                                      const double* disp, const double* du, const double* sig,
                                      const double* sig_yield, const double* dmat,
                                      long long dstride, const double* g, const double* h3g,
                                      double g_s, double h3g_s, const double* weights,
                                      double* sig_new, double* sig_test, unsigned char* pgp,
                                      double* elv, long long ne, int large_disp, void* stream) {
  return entry<double>(coords, elnodes, disp, du, sig, sig_yield, dmat, dstride, g, h3g, g_s,
                       h3g_s, weights, sig_new, sig_test, pgp, elv, ne, large_disp, stream);
}
