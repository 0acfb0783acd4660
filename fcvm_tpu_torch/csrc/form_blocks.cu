// K3: the element stiffness blocks, for Hopper (sm_90a): every block the
// paths form, elastic, tangent or geometric, in one launch that writes K1's
// packed tiles and, when the caller asks, the element-major blocks.
//
// Replaces the XLA-lowered element-block formation of the JAX package:
// _single_elastic_esm / elastic_stiffness_blocks
// (fcvm_tpu/ops/assembly.py:59-74, :105-114), _single_tangent_esm /
// tangent_stiffness_blocks (:117-162) and _single_geometric_nsm /
// geometric_stiffness_blocks (:165-188), with tet10_element_geometry
// (fcvm_tpu/ops/elements.py:126) and von_mises (fcvm_tpu/ops/material.py);
// on the port's side the einsum chain of ops/kernels.py:form_blocks_ref and
// the copies after it (the element-major permute, pack_blocks).
//
// For each output element e (input element r = perm[e], or e) and Gauss
// point g, on r's 10 nodes (moved by disp when given):
//
//   J, det J, J^-1 and dN_k/dx from tet10.cuh, the arithmetic K2 forms the
//   internal force from; s_g = w_g |det J_g|;
//   elastic:   D_g = D (one, or r's);
//   tangent:   D_g = D - fac dev dev^T, fac = g3fac / svm^2 at a plastic
//              point (pgp) and 0 elsewhere, svm = 0 read as 1, g3fac =
//              3 G / (1 + H / 3 G) (the stress sig_r the step's start);
//   geometric: sigma_g = sig_r's stress at g;
//   K[3a + i, 3b + j] = sum_g B_a,i^T (s_g D_g) B_b,j   (elastic, tangent)
//   K[3a + i, 3b + j] = delta_ij sum_g dN_a^T (s_g sigma_g) dN_b  (geometric),
//   times weights[r] when given.
//
// Only the upper triangle is computed, node pair (a, b), a <= b, by pair;
// the element-major output gets each value at (i, j) and (j, i), so the
// blocks are exactly symmetric.
//
// What bounds it: bytes.  Per element it writes 465 packed values (the
// tiles K1, K1m, dirichlet_rhs and the deflation builds read) and, when
// asked, 900 element-major ones, against 10 node ids, the coordinates (and
// displacements) at its nodes, 24 stresses and 4 flags (tangent), 24
// stresses (geometric) or a D: on the plate's 117,936 elements about 240 MB
// in float32 for the packed tiles alone and 665 MB with the element-major
// blocks, 0.07 and 0.20 ms at 3.35 TB/s.  Its arithmetic, about 81 FMAs a
// node pair and Gauss point (D B_b, 54; B_a^T (D B_b), 27), is 17,800 FMAs
// an element, 0.06 ms of float32 FMA on the plate.
//
// Design: a block of 256 threads takes a tile of 128 / sizeof(T) elements
// (32 in float32, 16 in float64), so a warp's (float32) or half-warp's
// (float64) stores along the elements are 128 bytes.
//   1. A thread for each (Gauss point, element) of the tile forms the
//      geometry and writes dN/dx (30 values) and s_g D_g (its 21 upper
//      values; geometric: s_g sigma_g, 6) to shared memory, [g][value][e].
//   2. Every thread takes one element of the tile (its lane) and the node
//      pairs p = group, group + groups, ... of the 55; for each pair it sums
//      the four Gauss points' 3x3 block in registers from shared memory
//      (the lanes of a warp read neighbouring words), then stores its upper
//      entries into the packed tile [t, q, k] (q the row-major upper index,
//      t = e / tile, k = e % tile) and, when asked, the element-major
//      blocks [i, j, e].  Lanes past the last element write the packed
//      tile's zero padding.
//   Every sum runs in one fixed order (the Gauss points ascending, each
//   product in the order written), division and sqrt IEEE (no fast math),
//   no atomics: two launches give the same bits.
//
// C interface: each entry returns cudaGetLastError() after its launch (0 =
// launched).  The caller owns all memory and the stream; the kernel does
// not synchronise.  csrc/ops.cpp binds it as torch.ops.fcvm.form_blocks.

#include <cstdint>

#include <cuda_runtime.h>

#include "tet10.cuh"

namespace {

using namespace fcvm_tet10;  // kNodes, kGauss, kTable, kDshp, kWeight, det3, dndx, jacobian, inverse

constexpr int kThreads = 256;
constexpr int kPairs = kNodes * (kNodes + 1) / 2;  // node pairs a <= b
constexpr int kNPack = 30 * 31 / 2;                // packed values an element
constexpr int kDq = 21;                            // shared values a Gauss point: D_g's upper

enum Form { kElastic = 0, kTangent = 1, kGeometric = 2 };

template <typename T>
constexpr int kTile = 128 / static_cast<int>(sizeof(T));  // elements a block

template <typename T>
struct Args {
  const T* coords;            // (nn, 3)
  const T* disp;              // (3 n,), or null
  const int* table;           // (10, nt): node k of input element r at k nt + r
  long long nt;
  const long long* perm;      // (ne,): the input element of output element e, or null
  const T* dmat;              // (6, 6), or (nt, 6, 6) with dstride 36
  long long dstride;
  const T* sig;               // (nt, 4, 6): tangent, geometric
  const unsigned char* pgp;   // (nt, 4): tangent
  const T* g;                 // (nt,) shear moduli, or null: g3fac_s
  const T* h;                 // (nt,) hardening moduli, with g
  double g3fac_s;             // 3 G / (1 + H / 3 G) of one material
  const T* weights;           // (nt,), or null
  T* full;                    // (30, 30, ne), or null
  T* packed;                  // (npad / tile, 465, tile), or null
  long long ne, npad, tile;
};

// the position of (i, j), i <= j, in an element's packed row-major upper triangle
__device__ __forceinline__ int packed_index(int i, int j) {
  return i * 30 - i * (i - 1) / 2 + (j - i);
}

// the position of D_g(k, l), k <= l, in its 21 upper values
__host__ __device__ constexpr int upper6(int k, int l) {
  return k * 6 - k * (k - 1) / 2 + (l - k);
}

// D_g(k, l) of its upper values (D_g symmetric)
template <typename T>
__device__ __forceinline__ T sym(const T (&d)[kDq], int k, int l) {
  return k <= l ? d[upper6(k, l)] : d[upper6(l, k)];
}

// An element's nodes in global memory: position, plus disp when given.
template <typename T>
struct Nodes {
  const Args<T>& a;
  int node[kNodes];
  __device__ __forceinline__ T x(int k, int i) const {
    const long long n = 3LL * node[k];
    T v = __ldg(a.coords + n + i);
    if (a.disp) v += __ldg(a.disp + n + i);
    return v;
  }
};

template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads) form_blocks_kernel(const Args<T> a) {
  constexpr int kE = kTile<T>;
  constexpr int kGroups = kThreads / kE;
  __shared__ T tab[kTable];
  __shared__ T dx[kGauss][3 * kNodes][kE];
  __shared__ T dq[kGauss][kDq][kE];
  for (int i = threadIdx.x; i < kTable; i += kThreads) tab[i] = static_cast<T>(kDshp[i]);
  __syncthreads();
  const long long e0 = static_cast<long long>(blockIdx.x) * kE;

  // 1. the geometry and the material of each (Gauss point, element)
  if (threadIdx.x < kGauss * kE) {
    const int g = threadIdx.x / kE, lane = threadIdx.x % kE;
    const long long e = e0 + lane < a.ne ? e0 + lane : a.ne - 1;
    const long long r = a.perm ? __ldg(a.perm + e) : e;
    Nodes<T> nodes{a, {}};
#pragma unroll
    for (int k = 0; k < kNodes; ++k) nodes.node[k] = __ldg(a.table + k * a.nt + r);
    const T* dn = tab + g * 3 * kNodes;
    T jac[3][3];
    jacobian(nodes, dn, jac);
    const T det = det3(jac);
    T ji[3][3];
    inverse(jac, det, ji);
#pragma unroll
    for (int k = 0; k < kNodes; ++k) {
      T d[3];
      dndx(ji, dn, k, d);
#pragma unroll
      for (int i = 0; i < 3; ++i) dx[g][3 * k + i][lane] = d[i];
    }
    const T scale = static_cast<T>(kWeight) * fabs(det);
    if (kForm == kGeometric) {
      const T* s = a.sig + (r * kGauss + g) * 6;
#pragma unroll
      for (int v = 0; v < 6; ++v) dq[g][v][lane] = scale * __ldg(s + v);
    } else {
      const T* dm = a.dmat + r * a.dstride;
      T fac = T(0);
      T dev[6] = {};
      if (kForm == kTangent) {
        const T* s = a.sig + (r * kGauss + g) * 6;
        T t[6];
#pragma unroll
        for (int v = 0; v < 6; ++v) t[v] = __ldg(s + v);
        // the deviator and von Mises stress (ops/material.py:von_mises)
        const T p = (t[0] + t[1] + t[2]) / T(3);
#pragma unroll
        for (int v = 0; v < 6; ++v) dev[v] = v < 3 ? t[v] - p : t[v];
        const T svm = sqrt(T(1.5) * (dev[0] * dev[0] + dev[1] * dev[1] + dev[2] * dev[2]) +
                           T(3) * (dev[3] * dev[3] + dev[4] * dev[4] + dev[5] * dev[5]));
        const T safe = svm == T(0) ? T(1) : svm;
        T g3fac = static_cast<T>(a.g3fac_s);
        if (a.g) {
          const T gg = __ldg(a.g + r), hh = __ldg(a.h + r);
          g3fac = T(3) * gg / (T(1) + hh / (T(3) * gg));
        }
        fac = a.pgp[r * kGauss + g] ? g3fac / (safe * safe) : T(0);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int l = k; l < 6; ++l) {
          T v = __ldg(dm + 6 * k + l);
          if (kForm == kTangent) v = v - fac * dev[k] * dev[l];
          dq[g][upper6(k, l)][lane] = scale * v;
        }
    }
  }
  __syncthreads();

  // 2. the node pairs' blocks of the lane's element
  const int lane = threadIdx.x % kE, group = threadIdx.x / kE;
  const long long e = e0 + lane;
  if (e >= a.npad) return;
  const bool real = e < a.ne;
  T w = T(1);
  if (a.weights) {
    const long long ee = real ? e : a.ne - 1;
    w = __ldg(a.weights + (a.perm ? __ldg(a.perm + ee) : ee));
  }
  T* full = a.full && real ? a.full + e : nullptr;
  T* packed = a.packed ? a.packed + (e / a.tile) * kNPack * a.tile + e % a.tile : nullptr;
  for (int p = group; p < kPairs; p += kGroups) {
    int na = 0, rem = p;  // pair p of the row-major a <= b order
    while (rem >= kNodes - na) {
      rem -= kNodes - na;
      ++na;
    }
    const int nb = na + rem;
    T acc[3][3] = {};
#pragma unroll
    for (int g = 0; g < kGauss; ++g) {
      T da[3], db[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        da[i] = dx[g][3 * na + i][lane];
        db[i] = dx[g][3 * nb + i][lane];
      }
      if (kForm == kGeometric) {
        // dN_a^T sigma dN_b, sigma from Voigt [xx, yy, zz, xy, zx, yz]
        T s[6];
#pragma unroll
        for (int v = 0; v < 6; ++v) s[v] = dq[g][v][lane];
        const T st[3][3] = {{s[0], s[3], s[4]}, {s[3], s[1], s[5]}, {s[4], s[5], s[2]}};
        T m = T(0);
#pragma unroll
        for (int i = 0; i < 3; ++i) m += da[i] * (st[i][0] * db[0] + st[i][1] * db[1] +
                                                  st[i][2] * db[2]);
        acc[0][0] += m;
      } else {
        T d[kDq];
#pragma unroll
        for (int u = 0; u < kDq; ++u) d[u] = dq[g][u][lane];
        // D B_b (6 x 3); B's columns of node b: x [db0, 0, 0, db1, db2, 0],
        // y [0, db1, 0, db0, 0, db2], z [0, 0, db2, 0, db0, db1] (Voigt rows,
        // engineering shears, ops/elements.py)
        T dbm[6][3];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          dbm[k][0] = sym(d, k, 0) * db[0] + sym(d, k, 3) * db[1] + sym(d, k, 4) * db[2];
          dbm[k][1] = sym(d, k, 1) * db[1] + sym(d, k, 3) * db[0] + sym(d, k, 5) * db[2];
          dbm[k][2] = sym(d, k, 2) * db[2] + sym(d, k, 4) * db[0] + sym(d, k, 5) * db[1];
        }
        // B_a^T (D B_b)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[0][c] += da[0] * dbm[0][c] + da[1] * dbm[3][c] + da[2] * dbm[4][c];
          acc[1][c] += da[1] * dbm[1][c] + da[0] * dbm[3][c] + da[2] * dbm[5][c];
          acc[2][c] += da[2] * dbm[2][c] + da[0] * dbm[4][c] + da[1] * dbm[5][c];
        }
      }
    }
#pragma unroll
    for (int ri = 0; ri < 3; ++ri)
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        if (na == nb && ci < ri) continue;  // the diagonal block's lower half: its mirror
        const int i = 3 * na + ri, j = 3 * nb + ci;
        T v = kForm == kGeometric ? (ri == ci ? acc[0][0] : T(0)) : acc[ri][ci];
        if (a.weights) v *= w;
        if (full) {
          full[(i * 30LL + j) * a.ne] = v;
          if (i != j) full[(j * 30LL + i) * a.ne] = v;
        }
        if (packed) packed[packed_index(i, j) * a.tile] = real ? v : T(0);
      }
  }
}

template <typename T>
int run(int form, const Args<T>& a, void* stream) {
  if (a.ne <= 0) return 0;
  const long long blocks = (a.npad + kTile<T> - 1) / kTile<T>;
  if (blocks > 0x7fffffffLL || a.tile % kTile<T> != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  if (form == kElastic)
    form_blocks_kernel<T, kElastic><<<grid, kThreads, 0, s>>>(a);
  else if (form == kTangent)
    form_blocks_kernel<T, kTangent><<<grid, kThreads, 0, s>>>(a);
  else if (form == kGeometric)
    form_blocks_kernel<T, kGeometric><<<grid, kThreads, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(int form, const T* coords, const T* disp, const int* table, long long nt,
          const long long* perm, const T* dmat, long long dstride, const T* sig,
          const unsigned char* pgp, const T* g, const T* h, double g3fac_s, const T* weights,
          T* full, T* packed, long long ne, long long npad, long long tile, void* stream) {
  const Args<T> a{coords, disp, table,   nt,      perm, dmat,   dstride, sig,  pgp,
                  g,      h,    g3fac_s, weights, full, packed, ne,      npad, tile};
  return run<T>(form, a, stream);
}

}  // namespace

// form: 0 elastic, 1 tangent, 2 geometric.  table: the int32 (10, nt)
// element-major node table (ops/kernels.py::element_table) of the input
// elements; perm (ne,) int64 or null; full or packed null: not written;
// npad: the packed tiles' element slots (ntiles tile), or ne without them;
// tile a multiple of 128 / sizeof(T).
extern "C" int fcvm_form_blocks_f32(int form, const float* coords, const float* disp,
                                    const int* table, long long nt, const long long* perm,
                                    const float* dmat, long long dstride, const float* sig,
                                    const unsigned char* pgp, const float* g, const float* h,
                                    double g3fac_s, const float* weights, float* full,
                                    float* packed, long long ne, long long npad, long long tile,
                                    void* stream) {
  return entry<float>(form, coords, disp, table, nt, perm, dmat, dstride, sig, pgp, g, h,
                      g3fac_s, weights, full, packed, ne, npad, tile, stream);
}

extern "C" int fcvm_form_blocks_f64(int form, const double* coords, const double* disp,
                                    const int* table, long long nt, const long long* perm,
                                    const double* dmat, long long dstride, const double* sig,
                                    const unsigned char* pgp, const double* g, const double* h,
                                    double g3fac_s, const double* weights, double* full,
                                    double* packed, long long ne, long long npad, long long tile,
                                    void* stream) {
  return entry<double>(form, coords, disp, table, nt, perm, dmat, dstride, sig, pgp, g, h,
                       g3fac_s, weights, full, packed, ne, npad, tile, stream);
}
