// K3: the element stiffness blocks, for Hopper (sm_90a): every block the
// paths form, elastic, tangent or geometric, in one launch that writes K1's
// packed tiles and, when the caller asks, the element-major blocks and the
// compact diagonal K5 reads.
//
// Replaces the XLA-lowered element-block formation of the JAX package:
// _single_elastic_esm / elastic_stiffness_blocks
// (fcvm_tpu/ops/assembly.py:59-74, :105-114), _single_tangent_esm /
// tangent_stiffness_blocks (:117-162) and _single_geometric_nsm /
// geometric_stiffness_blocks (:165-188), with tet10_element_geometry
// (fcvm_tpu/ops/elements.py:126) and von_mises (fcvm_tpu/ops/material.py);
// on the port's side the einsum chain of ops/kernels.py:form_blocks_ref and
// the copies after it (the element-major permute, pack_blocks, the
// diagonal slice of block Jacobi).
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
// Only the upper triangle is computed, node pair (a, b), a <= b; the
// element-major output gets each value at (i, j) and (j, i), so the blocks
// are exactly symmetric.  The compact diagonal (diag, when asked) holds,
// for incidence k = slot ne + e, the 6 upper values of element e's diagonal
// block (slot, slot), row-major, padded with 2 zeros to 8: one 32-byte
// sector in float32, 64 bytes in float64.
//
// What bounds it: bytes.  Per element it writes 465 packed values (the
// tiles K1, K1m, dirichlet_rhs and the deflation builds read), when asked
// 900 element-major ones and 60 diagonal values (80 with the padding),
// against 10 node ids, the coordinates (and displacements) at its nodes, 24
// stresses and 4 flags (tangent), 24 stresses (geometric) or a D: on the
// plate's 117,936 elements about 240 MB in float32 for the packed tiles
// alone (28 MB more of diagonal values), 665 MB with the element-major
// blocks, 0.07 to 0.20 ms at 3.35 TB/s.  Its arithmetic, about 81 FMAs a
// node pair and Gauss point (D_g B_b, 54; B_a^T (D_g B_b), 27), is 17,800
// FMAs an element, 0.06 ms of float32 FMA on the plate.  Its stores and its
// arithmetic overlap only as far as an SM holds warps: the stores of a
// stage 2 without its arithmetic, and its arithmetic without its stores,
// each take about half of the whole (fcvm_tpu_torch/tools/k3_probe.py).
//
// Design: a block of 256 threads takes a tile of 128 / sizeof(T) elements
// (32 in float32, 16 in float64), so a warp's (float32) or half-warp's
// (float64) stores along the elements are 128 bytes.
//   0. In float64, for the elastic and tangent forms, the block gathers each
//      element's 10 nodes (coordinates plus disp) once into shared memory,
//      [3 k + i][e]; elsewhere each Gauss point's thread reads its nodes
//      from global memory in stage 1 (kGather: the gather was 2 to 5%
//      faster there, and 1 to 3% slower in float32 and 11% slower for the
//      float64 geometric form, fcvm_tpu_torch/tools/k3_probe.py).
//   1. A thread for each (Gauss point, element) of the tile forms the
//      geometry and writes dN/dx (30 values) and s_g D_g (its 21 upper
//      values; geometric: s_g sigma_g, 6) to shared memory, [g][value][e].
//   2. Every thread takes one element of the tile (its lane) and the node
//      pairs p = group, group + groups, ... of the 55; for each pair it sums
//      the four Gauss points' 3x3 block in registers from shared memory
//      (the lanes of a warp read neighbouring words), forming D_g B_b for
//      the pair, then stores its upper entries into the packed tile [t, q,
//      k] (q the row-major upper index, t = e / tile, k = e % tile) and, when
//      asked, the element-major blocks [i, j, e] and, for a diagonal pair,
//      the diagonal's sector.  Lanes past the last element write the packed
//      tile's zero padding.
//   Forming D_g B_b once a column of pairs and holding it across the
//   column's pairs (a fifth of the arithmetic) needs 72 more registers a
//   thread in float32 (144 in float64) and so fewer warps an SM, and was
//   slower in both dtypes at every tile shape and register bound tried; so
//   were its Gauss points split over two lanes and its outputs staged in
//   shared memory for a store pass of their own (csrc/form_blocks_probe.cu
//   keeps those layouts).  The kernel's arithmetic and its stores each take
//   about half of its time and overlap only as far as an SM holds warps.
//   Every sum runs in one fixed order (the Gauss points ascending, each
//   product in the order written), division and sqrt IEEE (no fast math), no
//   atomics: two launches give the same bits.
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
constexpr int kDiag = 8;                           // diagonal values an incidence, padded

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
  T* diag;                    // (10, ne, 8), or null
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

// the position of (r, c), r <= c, in a 3x3 block's 6 upper values
__host__ __device__ constexpr int upper3(int r, int c) { return r * 3 - r * (r - 1) / 2 + c - r; }

// values a Gauss point keeps in shared memory: D_g's upper 21, or sigma_g's 6
__host__ __device__ constexpr int dq_values(int form) { return form == kGeometric ? 6 : 21; }

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

// An element's nodes staged in shared memory, [3 k + i][lane].
template <typename T, int kE>
struct StagedNodes {
  const T* s;
  int lane;
  __device__ __forceinline__ T x(int k, int i) const { return s[(3 * k + i) * kE + lane]; }
};

// Stages 0 and 1 for the tile of kE elements from e0, with kThreadsB threads,
// after the block has begun writing the dN/dxi table tab: with kStage each
// element's nodes gathered once into xs, [3 k + i][lane]; the block's
// barrier; then a thread a (Gauss point, element) writes dN/dx into dx,
// [g][3 k + i][lane], and s_g D_g (geometric: s_g sigma_g) into dq,
// [g][value][lane], rows of kStride values.  Ends with the block's barrier.
template <typename T, int kForm, int kE, int kStride, bool kStage, int kThreadsB>
__device__ __forceinline__ void geometry(const Args<T>& a, const T* tab, T* dx, T* dq, T* xs,
                                         long long e0) {
  constexpr int kDq = dq_values(kForm);
  if (kStage) {  // each element's nodes gathered once
    for (int i = threadIdx.x; i < kNodes * kE; i += kThreadsB) {
      const int k = i / kE, lane = i % kE;
      const long long e = e0 + lane < a.ne ? e0 + lane : a.ne - 1;
      const long long r = a.perm ? __ldg(a.perm + e) : e;
      const long long n = 3LL * __ldg(a.table + k * a.nt + r);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T v = __ldg(a.coords + n + c);
        if (a.disp) v += __ldg(a.disp + n + c);
        xs[(3 * k + c) * kE + lane] = v;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kGauss * kE) {
    const int g = threadIdx.x / kE, lane = threadIdx.x % kE;
    const long long e = e0 + lane < a.ne ? e0 + lane : a.ne - 1;
    const long long r = a.perm ? __ldg(a.perm + e) : e;
    const T* dn = tab + g * 3 * kNodes;
    T jac[3][3];
    if (kStage) {
      jacobian(StagedNodes<T, kE>{xs, lane}, dn, jac);
    } else {
      Nodes<T> nodes{a, {}};
#pragma unroll
      for (int k = 0; k < kNodes; ++k) nodes.node[k] = __ldg(a.table + k * a.nt + r);
      jacobian(nodes, dn, jac);
    }
    const T det = det3(jac);
    T ji[3][3];
    inverse(jac, det, ji);
    T* dxg = dx + g * 3 * kNodes * kStride + lane;
#pragma unroll
    for (int k = 0; k < kNodes; ++k) {
      T d[3];
      dndx(ji, dn, k, d);
#pragma unroll
      for (int i = 0; i < 3; ++i) dxg[(3 * k + i) * kStride] = d[i];
    }
    T* dqg = dq + g * kDq * kStride + lane;
    const T scale = static_cast<T>(kWeight) * fabs(det);
    if (kForm == kGeometric) {
      const T* s = a.sig + (r * kGauss + g) * 6;
#pragma unroll
      for (int v = 0; v < 6; ++v) dqg[v * kStride] = scale * __ldg(s + v);
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
          dqg[upper6(k, l) * kStride] = scale * v;
        }
    }
  }
  __syncthreads();
}

// the 8 values of a diagonal sector, stored as 16-byte words
__device__ __forceinline__ void store_sector(float* p, const float (&v)[kDiag]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store_sector(double* p, const double (&v)[kDiag]) {
#pragma unroll
  for (int q = 0; q < kDiag / 2; ++q)
    reinterpret_cast<double2*>(p)[q] = make_double2(v[2 * q], v[2 * q + 1]);
}

// Where a lane's element goes: its packed column, its element-major column,
// its diagonal sectors and its weight.
template <typename T>
struct Out {
  const Args<T>& a;
  long long e;
  bool real;
  T w;
  T* full;
  T* packed;
  int tile;

  __device__ __forceinline__ Out(const Args<T>& args, long long el)
      : a(args), e(el), real(el < args.ne), w(T(1)), full(nullptr), packed(nullptr),
        tile(static_cast<int>(args.tile)) {
    if (a.weights) {
      const long long ee = real ? e : a.ne - 1;
      w = __ldg(a.weights + (a.perm ? __ldg(a.perm + ee) : ee));
    }
    if (a.full && real) full = a.full + e;
    if (a.packed) packed = a.packed + (e / tile) * kNPack * tile + e % tile;
  }

  // entry (i, j), i <= j, of the element's block (and its mirror), times
  // the weight; returned as stored
  __device__ __forceinline__ T store(int i, int j, T x) const {
    if (a.weights) x *= w;
    if (full) {
      full[(i * 30LL + j) * a.ne] = x;
      if (i != j) full[(j * 30LL + i) * a.ne] = x;
    }
    if (packed) packed[packed_index(i, j) * tile] = real ? x : T(0);
    return x;
  }

  // the diagonal block (slot, slot)'s sector
  __device__ __forceinline__ void sector(int slot, const T (&d)[kDiag]) const {
    if (a.diag && real) store_sector(a.diag + (slot * a.ne + e) * kDiag, d);
  }
};

// kGather: stage 0 where it was faster (float64, elastic and tangent)
template <typename T, int kForm>
constexpr bool kGather = sizeof(T) == 8 && kForm != kGeometric;

template <typename T, int kForm, bool kStage>
__global__ void __launch_bounds__(kThreads) form_blocks_kernel(const Args<T> a) {
  constexpr int kE = kTile<T>;
  constexpr int kGroups = kThreads / kE;
  constexpr int kDq = dq_values(kForm);
  __shared__ T tab[kTable];
  __shared__ T xs[kStage ? 3 * kNodes * kE : 1];
  __shared__ T dx[kGauss * 3 * kNodes * kE];
  __shared__ T dq[kGauss * kDq * kE];
  for (int i = threadIdx.x; i < kTable; i += kThreads) tab[i] = static_cast<T>(kDshp[i]);
  const long long e0 = static_cast<long long>(blockIdx.x) * kE;
  geometry<T, kForm, kE, kE, kStage, kThreads>(a, tab, dx, dq, xs, e0);

  // 2. the node pairs' blocks of the lane's element
  const int lane = threadIdx.x % kE, group = threadIdx.x / kE;
  const long long e = e0 + lane;
  if (e >= a.npad) return;
  const Out<T> out(a, e);
  const T* dxl = dx + lane;
  const T* dql = dq + lane;
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
        da[i] = dxl[(g * 3 * kNodes + 3 * na + i) * kE];
        db[i] = dxl[(g * 3 * kNodes + 3 * nb + i) * kE];
      }
      if (kForm == kGeometric) {
        // dN_a^T sigma dN_b, sigma from Voigt [xx, yy, zz, xy, zx, yz]
        T s[6];
#pragma unroll
        for (int v = 0; v < 6; ++v) s[v] = dql[(g * kDq + v) * kE];
        const T st[3][3] = {{s[0], s[3], s[4]}, {s[3], s[1], s[5]}, {s[4], s[5], s[2]}};
        T m = T(0);
#pragma unroll
        for (int i = 0; i < 3; ++i) m += da[i] * (st[i][0] * db[0] + st[i][1] * db[1] +
                                                  st[i][2] * db[2]);
        acc[0][0] += m;
      } else {
        T d[21];
#pragma unroll
        for (int u = 0; u < 21; ++u) d[u] = dql[(g * kDq + u) * kE];
        auto sym = [&d](int k, int l) { return k <= l ? d[upper6(k, l)] : d[upper6(l, k)]; };
        // D B_b (6 x 3); B's columns of node b: x [db0, 0, 0, db1, db2, 0],
        // y [0, db1, 0, db0, 0, db2], z [0, 0, db2, 0, db0, db1] (Voigt rows,
        // engineering shears, ops/elements.py)
        T dbm[6][3];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          dbm[k][0] = sym(k, 0) * db[0] + sym(k, 3) * db[1] + sym(k, 4) * db[2];
          dbm[k][1] = sym(k, 1) * db[1] + sym(k, 3) * db[0] + sym(k, 5) * db[2];
          dbm[k][2] = sym(k, 2) * db[2] + sym(k, 4) * db[0] + sym(k, 5) * db[1];
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
    T sec[kDiag] = {};
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (na == nb && c < r) continue;  // the diagonal block's lower half: its mirror
        const T v = kForm == kGeometric ? (r == c ? acc[0][0] : T(0)) : acc[r][c];
        const T x = out.store(3 * na + r, 3 * nb + c, v);
        if (na == nb) sec[upper3(r, c)] = x;
      }
    if (na == nb) out.sector(na, sec);
  }
}

template <typename T>
int run(int form, const Args<T>& a, void* stream) {
  if (a.ne <= 0) return 0;
  const long long blocks = (a.npad + kTile<T> - 1) / kTile<T>;
  if (blocks > 0x7fffffffLL || (a.packed && a.tile % kTile<T> != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  if (form == kElastic)
    form_blocks_kernel<T, kElastic, kGather<T, kElastic>><<<grid, kThreads, 0, s>>>(a);
  else if (form == kTangent)
    form_blocks_kernel<T, kTangent, kGather<T, kTangent>><<<grid, kThreads, 0, s>>>(a);
  else if (form == kGeometric)
    form_blocks_kernel<T, kGeometric, kGather<T, kGeometric>><<<grid, kThreads, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> args(const T* coords, const T* disp, const int* table, long long nt,
             const long long* perm, const T* dmat, long long dstride, const T* sig,
             const unsigned char* pgp, const T* g, const T* h, double g3fac_s,
             const T* weights, T* full, T* packed, T* diag, long long ne, long long npad,
             long long tile) {
  return Args<T>{coords, disp, table,   nt,      perm, dmat,   dstride, sig, pgp,  g,
                 h,      g3fac_s, weights, full, packed, diag, ne,      npad, tile};
}

}  // namespace

// form: 0 elastic, 1 tangent, 2 geometric.  table: the int32 (10, nt)
// element-major node table (ops/kernels.py::element_table) of the input
// elements; perm (ne,) int64 or null; full, packed or diag null: not
// written; npad: the packed tiles' element slots (ntiles tile), or ne
// without them; tile a multiple of 128 / sizeof(T).
extern "C" int fcvm_form_blocks_f32(int form, const float* coords, const float* disp,
                                    const int* table, long long nt, const long long* perm,
                                    const float* dmat, long long dstride, const float* sig,
                                    const unsigned char* pgp, const float* g, const float* h,
                                    double g3fac_s, const float* weights, float* full,
                                    float* packed, float* diag, long long ne, long long npad,
                                    long long tile, void* stream) {
  return run<float>(form, args(coords, disp, table, nt, perm, dmat, dstride, sig, pgp, g, h,
                               g3fac_s, weights, full, packed, diag, ne, npad, tile),
                    stream);
}

extern "C" int fcvm_form_blocks_f64(int form, const double* coords, const double* disp,
                                    const int* table, long long nt, const long long* perm,
                                    const double* dmat, long long dstride, const double* sig,
                                    const unsigned char* pgp, const double* g, const double* h,
                                    double g3fac_s, const double* weights, double* full,
                                    double* packed, double* diag, long long ne, long long npad,
                                    long long tile, void* stream) {
  return run<double>(form, args(coords, disp, table, nt, perm, dmat, dstride, sig, pgp, g, h,
                                g3fac_s, weights, full, packed, diag, ne, npad, tile),
                     stream);
}
