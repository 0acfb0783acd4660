// The tet10 Gauss-point geometry shared by K2 (stress_update.cu, the
// internal force's B) and K3 (form_blocks.cu, the operator's B), so the
// card forms both from one arithmetic: the dN/dxi table and weight of the
// 4-point rule, J = sum_k x_k (x) dN_k/dxi, det J by cofactors, J^-1 by the
// adjugate divided by det J, and dN_k/dx = J^-T dN_k/dxi
// (fcvm_tpu_torch/ops/elements.py:tet10_element_geometry,
// fcvm_tpu_torch/utils/linalg3.py), each in one fixed order.

#pragma once

namespace fcvm_tet10 {

constexpr int kNodes = 10;
constexpr int kGauss = 4;
constexpr int kTable = kGauss * 3 * kNodes;

// dN_k/dxi_j at the 4 Gauss points of the tet10 rule, [g][j][k], as
// fcvm_tpu_torch/ops/elements.py (DSHP10_AT_GP) computes them in float64
// (shortest round-trip digits: the same doubles); static: each translation
// unit that includes this header holds its own copy
static __constant__ double kDshp[kTable] = {
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

// the determinant by cofactors, in utils/linalg3.py:det3's order
template <typename T>
__device__ __forceinline__ T det3(const T (&a)[3][3]) {
  return a[0][0] * a[1][1] * a[2][2] - a[0][0] * a[1][2] * a[2][1] +
         a[0][2] * a[1][0] * a[2][1] - a[0][2] * a[1][1] * a[2][0] +
         a[0][1] * a[1][2] * a[2][0] - a[0][1] * a[1][0] * a[2][2];
}

// dN_k/dx_i = sum_j Ji[j][i] dN_k/dxi_j at a Gauss point, dn its [j][k]
// rows of the table
template <typename T>
__device__ __forceinline__ void dndx(const T (&ji)[3][3], const T* dn, int k, T (&d)[3]) {
  const T a = dn[k], b = dn[kNodes + k], c = dn[2 * kNodes + k];
#pragma unroll
  for (int i = 0; i < 3; ++i) d[i] = ji[0][i] * a + ji[1][i] * b + ji[2][i] * c;
}

// J[i][j] = sum_k x_k[i] dN_k/dxi_j over the element's nodes, read through
// nodes.x(k, i), at the Gauss point of the table rows dn
template <typename T, typename Nodes>
__device__ __forceinline__ void jacobian(const Nodes& nodes, const T* dn, T (&jac)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) jac[i][j] = T(0);
#pragma unroll
  for (int k = 0; k < kNodes; ++k) {
    T x[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i] = nodes.x(k, i);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) jac[i][j] = x[i] * dn[j * kNodes + k] + jac[i][j];
  }
}

// J^-1 by the adjugate, each cofactor divided by det J (utils/linalg3.py:inv3)
template <typename T>
__device__ __forceinline__ void inverse(const T (&m)[3][3], T det, T (&ji)[3][3]) {
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

}  // namespace fcvm_tet10
