// K2: the stress update and internal force, for Hopper (sm_90a), in two
// passes: the element pass and the node pass.
//
// Replaces the XLA-lowered per-element stress update of the JAX package:
// _element_stress_update_hp, update_stress_load and internal_force_from_stress
// (fcvm_tpu/ops/stress_update.py:66-195), with radial_return and von_mises
// (fcvm_tpu/ops/material.py:52-88) and tet10_element_geometry
// (fcvm_tpu/ops/elements.py:126), and the node sum of its segment_sum
// (:151-157); in the residual form also the out-of-balance residual and its
// norm around it (fcvm_tpu/runtime/system.py's residual).
//
// 1. The element pass.  For each element e and Gauss point g, on the
//    element's 10 nodes (moved by the step-start disp under large_disp):
//
//      J = sum_k x_k (x) dN_k/dxi, det J and J^-1 by the adjugate
//      (fcvm_tpu_torch/utils/linalg3.py), dN_k/dx = J^-T dN_k/dxi, the
//      geometry of tet10.cuh, which K3 forms the operator's blocks from;
//      deps = B du, taken from dN/dx directly (B is never formed; Voigt
//      [xx, yy, zz, xy, zx, yz], engineering shears, ops/elements.py:99-112);
//      under large_disp F = I + grad du and sig_c = F sig_old F^T / det F;
//      sig_test = sig_c + D deps, D one (6, 6) or one per element;
//      the radial return with hardening (ops/material.py:radial_return):
//      sig_new, and pgp = (svm >= sig_yield);
//      elv = sum_g B_g^T sig_new w_g |det J_g|, times weights[e] when given.
//
//    The given-stress form (internal_force_from_stress) is the same pass
//    with the stress given (kGiven): its elv, no trial stress and no return.
//
//    What bounds it on paper: bytes.  Per element it reads 10 node ids
//    (int32, 40 B), 24 stresses and 4 yield stresses and writes 24 + 24
//    stresses, 4 flags and 30 forces; the node arrays (coordinates,
//    increments, disp under large_disp) are read once each: about 59 MB in
//    float32 on the plate's 117,936 elements, 0.018 ms at 3.35 TB/s, against
//    about 2,400 flops an element (the wrapper's caller computes the bound
//    from the arrays).  Measured (tools/k2_probe.py, PERF.md), the pass is
//    bound by neither alone: its memory traffic alone takes about twice the
//    bound (the copies and stores at the rate of a plain device copy, the
//    gathers' dependent loads on top) and its arithmetic alone as long
//    (about 1,200 instructions a Gauss point).  Staging a tile's nodes,
//    stresses and outputs in shared memory (each distinct node gathered
//    once, bulk copies, 16-byte stores), with or without a producer warp
//    that stages the next tile, was no faster than reading them where the
//    arithmetic needs them, as here (the probe keeps both variants).  The
//    design: a thread for each (element, Gauss point), 64 elements a block.
//      - Each thread reads its element's 10 node ids from the int32
//        element-major table (10, ne) (ops/kernels.py::element_table):
//        neighbouring elements' ids in neighbouring words, the four lanes of
//        an element the same words; its nodes' data from global memory
//        where the arithmetic needs them.
//      - dN/dx is recomputed from J^-1 and the shared-memory table where
//        it is needed, not held (30 registers); a single D sits in shared
//        memory, a per-element D (a region model) stays a global read.
//      - Every lane computes (a lane past the last element on the last
//        element's data, writing nothing), so the warp stays converged and
//        its shuffles and ballot need no convergence loop; the four flags of
//        an element are written as one 32-bit word.
//    Per Gauss point the arithmetic runs in one fixed order: FMAs in a
//    fixed order, the Gauss points' elv rows added by two shuffles as
//    (g0 + g1) + (g2 + g3), the same sum in all four lanes, so two launches
//    give the same bits; division and sqrt IEEE (built without fast math):
//    the radial return's factor and its >= test read them.
//
// 2. The node pass.  Over K8's write-form plan of the element rows' node
//    keys (ops/kernels.py::SegmentPlan: order, offsets, segs, holes), one
//    thread a node row: qin = the node's 3-wide rows of elv summed in the
//    plan's order, ascending incidence, from zero (fcvm_segment::gather_sum,
//    K8's sum: K8's bits); 0 in the holes.  In the residual form it also
//    writes r = relax (fixmask (lbd1 glv - qin)), each product and
//    difference rounded on its own (__fmul_rn, __fsub_rn: the torch chain's
//    bits), and each block's partial of sum (fixmask (lbd1 glv - qin))^2 in
//    float64; the last block to finish (an integer ticket, no float
//    atomics) sums the partials in a fixed order (thread t those of blocks
//    t, t + 256, ..., then the block's tree) and writes
//    error = sqrt(sum) / qnorm, and resets the ticket.  lbd1, relax and
//    qnorm are kernel scalars.  What bounds it: bytes (elv once, the plan,
//    glv and fixmask, qin and r written: about 28 MB on the plate).
//
// No atomics on floats and a fixed order everywhere, so two calls on the
// same inputs give the same bits.
//
// C interface: each entry returns cudaGetLastError() after its launch (0 =
// launched).  The caller owns all memory (the ticket, zero before the first
// launch, and the partials are its scratch) and the stream; the kernels do
// not synchronise.  csrc/ops.cpp binds them as torch.ops.fcvm.stress_update
// and torch.ops.fcvm.node_force.

#include <cstdint>

#include <cuda_runtime.h>

#include "segment.cuh"
#include "tet10.cuh"

namespace {

using namespace fcvm_tet10;  // kNodes, kGauss, kTable, kDshp, kWeight, det3, dndx, jacobian, inverse

constexpr int kNodeThreads = 256;  // the node pass's blocks
constexpr int kNodeDepth = 4;      // incidences a gather batch (fcvm_segment::gather_sum)

template <typename T>
struct Args {
  const T* coords;     // (nn, 3)
  const int* table;    // (10, ne): node k of element e at k ne + e
  const T* disp;       // (3 n,), read under large_disp
  const T* du;         // (3 n,); null in the given-stress form
  const T* sig;        // (ne, 4, 6): sig_old, or the given stress; 16-byte aligned
  const T* sig_yield;  // (ne, 4)
  const T* dmat;       // (6, 6), or (ne, 6, 6) with dstride 36
  long long dstride;
  const T* g;          // (ne,) shear moduli, or null: g_s
  const T* h3g;        // (ne,) H + 3 G, or null: h3g_s
  T g_s, h3g_s;
  const T* weights;    // (ne,), or null
  T* sig_new;          // (ne, 4, 6)
  T* sig_test;         // (ne, 4, 6)
  uint32_t* pgp;       // (ne,) words: the (ne, 4) bytes of the flags
  T* elv;              // (ne, 30)
  long long ne;
};

constexpr int kThreads = 256;  // the element pass's blocks: 64 elements

// the element pass's blocks an SM must hold at least (__launch_bounds__),
// the fastest of 1 to 3 on the plate and the beam-column (PERF.md): the
// float32 update three (80 registers), the float32 given-stress form one,
// float64 two (128 registers; at 130 the GNL update held one block an SM,
// and ran slower)
template <typename T, bool kGiven>
constexpr int kMinBlocks = sizeof(T) == 8 ? 2 : (kGiven ? 1 : 3);

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

// a Gauss point's 6 stresses as 8-byte pairs in float32 and 16-byte in
// float64 (each point's 6 start at an even index of a 16-byte aligned array)
template <typename T>
__device__ __forceinline__ void load6(const T* p, T (&s)[6]) {
  using P = typename Pair<T>::type;
  const P* q = reinterpret_cast<const P*>(p);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const P v = q[i];
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

// the trial stress t = s + D eps, D row-major (6, 6): a per-element D read
// from global memory (kGlobal), the single one from shared memory
template <bool kGlobal, typename T>
__device__ __forceinline__ void trial_stress(const T* dm, const T (&eps)[6], const T (&s)[6],
                                             T (&t)[6]) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    T acc = T(0);
#pragma unroll
    for (int c = 0; c < 6; ++c) acc += (kGlobal ? __ldg(dm + r * 6 + c) : dm[r * 6 + c]) * eps[c];
    t[r] = s[r] + acc;
  }
}

// One Gauss point: thread g of element e, its nodes' positions and
// increments read through `nodes` (x(k, i) and u(k, i): from global memory
// in the pass, from shared memory in a probe's staged variants), its
// stresses from sig_in and its yield stress sy.  Every lane of the warp
// calls it, so its shuffles and ballot take the whole warp; a lane with
// `valid` false works on element e's data and writes nothing.  It writes
// sig_test to test_out and sig_new to sig_out (6 values each), elv (30) to
// elv_out and the element's four plastic flags as one word.
template <typename T, bool kGiven, bool kLarge, typename Nodes>
__device__ __forceinline__ void gauss_point(const Args<T>& a, const Nodes& nodes, int g,
                                            bool valid, long long e, const T* sig_in, T sy,
                                            T* sig_out, T* test_out, T* elv_out, const T* d_s,
                                            const T* table) {
  const T* dn = table + g * 3 * kNodes;

  // J, det J and J^-1 (tet10.cuh: the geometry K3 forms the operator from)
  T jac[3][3];
  jacobian(nodes, dn, jac);
  const T det = det3(jac);
  T ji[3][3];
  inverse(jac, det, ji);

  T s[6];
  load6(sig_in, s);
  if (!kGiven) {
    // deps = B du and, under large_disp, grad du [a][b] = sum_k du_k[a] dN_k/dx_b
    T eps[6] = {};
    T grad[3][3] = {};
#pragma unroll
    for (int k = 0; k < kNodes; ++k) {
      T d[3];
      dndx(ji, dn, k, d);
      const T u0 = nodes.u(k, 0), u1 = nodes.u(k, 1), u2 = nodes.u(k, 2);
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
    T t[6];
    if (a.dstride)
      trial_stress<true>(a.dmat + e * a.dstride, eps, s, t);
    else
      trial_stress<false>(d_s, eps, s, t);
    // the radial return (ops/material.py:radial_return)
    const T p = (t[0] + t[1] + t[2]) / T(3);
    T dev[6] = {t[0] - p, t[1] - p, t[2] - p, t[3], t[4], t[5]};
    const T svm = sqrt(T(1.5) * (dev[0] * dev[0] + dev[1] * dev[1] + dev[2] * dev[2]) +
                       T(3) * (dev[3] * dev[3] + dev[4] * dev[4] + dev[5] * dev[5]));
    const bool plastic = svm >= sy;
    const T gs = a.g ? __ldg(a.g + e) : a.g_s;
    const T h3g = a.h3g ? __ldg(a.h3g + e) : a.h3g_s;
    const T safe = svm == T(0) ? T(1) : svm;
    const T fac = plastic ? T(1) - (T(1) - sy / safe) * T(3) * gs / h3g : T(1);
#pragma unroll
    for (int v = 0; v < 6; ++v) s[v] = dev[v] * fac + (v < 3 ? p : T(0));
    if (valid) {
      store6(test_out, t);
      store6(sig_out, s);
    }
    // the element's four flags, one byte each, as one word
    const unsigned bits = (__ballot_sync(0xffffffffu, plastic) >> (threadIdx.x & 28)) & 0xFu;
    if (g == 0 && valid)
      a.pgp[e] = (bits & 1u) | ((bits >> 1) & 1u) << 8 | ((bits >> 2) & 1u) << 16 |
                 ((bits >> 3) & 1u) << 24;
  }

  // elv = sum_g B_g^T sig w_g |det J_g|, the four Gauss points added by two
  // shuffles; thread g < 3 writes component g of each node
  const T scale = static_cast<T>(kWeight) * fabs(det);
  const T wt = a.weights ? __ldg(a.weights + e) : T(1);
#pragma unroll
  for (int k = 0; k < kNodes; ++k) {
    T d[3];
    dndx(ji, dn, k, d);
    T q[3] = {(d[0] * s[0] + d[1] * s[3] + d[2] * s[4]) * scale,
              (d[1] * s[1] + d[0] * s[3] + d[2] * s[5]) * scale,
              (d[2] * s[2] + d[0] * s[4] + d[1] * s[5]) * scale};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[c] += __shfl_xor_sync(0xffffffffu, q[c], 1);
      q[c] += __shfl_xor_sync(0xffffffffu, q[c], 2);
      if (a.weights) q[c] *= wt;
    }
    if (valid && g < 3) elv_out[3 * k + g] = g == 0 ? q[0] : (g == 1 ? q[1] : q[2]);
  }
}

// The nodes of one element in global memory, by its node ids: position
// (with disp under large_disp, added as the plain version adds it) and
// increment; the arrays are read through the kernel's parameters.
template <typename T, bool kLarge>
struct GlobalNodes {
  const Args<T>& a;
  int node[kNodes];
  __device__ __forceinline__ T x(int k, int i) const {
    const long long n = 3LL * node[k];
    T v = __ldg(a.coords + n + i);
    if (kLarge) v += __ldg(a.disp + n + i);
    return v;
  }
  __device__ __forceinline__ T u(int k, int i) const { return __ldg(a.du + 3LL * node[k] + i); }
};

// The element pass: a thread a Gauss point, 64 elements a block; each
// thread reads its element's node ids (for each k a coalesced int32 row of
// the element-major table) and its nodes' data from global memory where
// the arithmetic needs them.
template <typename T, bool kGiven, bool kLarge>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<T, kGiven>))
    stress_update_kernel(const Args<T> a) {
  __shared__ T table[kTable];
  __shared__ T d_s[36];
  for (int i = threadIdx.x; i < kTable; i += kThreads) table[i] = static_cast<T>(kDshp[i]);
  if (!kGiven && a.dstride == 0 && threadIdx.x < 36) d_s[threadIdx.x] = a.dmat[threadIdx.x];
  __syncthreads();
  const long long own = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 2;
  const bool valid = own < a.ne;  // an element's four threads agree
  const long long e = valid ? own : a.ne - 1;
  const int g = threadIdx.x & 3;
  GlobalNodes<T, kLarge> nodes{a, {}};
#pragma unroll
  for (int k = 0; k < kNodes; ++k) nodes.node[k] = __ldg(a.table + k * a.ne + e);
  const long long gp = e * kGauss + g;
  const T sy = kGiven ? T(0) : __ldg(a.sig_yield + gp);
  gauss_point<T, kGiven, kLarge>(a, nodes, g, valid, e, a.sig + gp * 6, sy,
                                 kGiven ? nullptr : a.sig_new + gp * 6,
                                 kGiven ? nullptr : a.sig_test + gp * 6, a.elv + e * 3 * kNodes,
                                 d_s, table);
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
  if (a.du == nullptr)
    return large_disp ? launch<T, true, true>(a, s) : launch<T, true, false>(a, s);
  return large_disp ? launch<T, false, true>(a, s) : launch<T, false, false>(a, s);
}

template <typename T>
int entry(const T* coords, const int* table, const T* disp, const T* du, const T* sig,
          const T* sig_yield, const T* dmat, long long dstride, const T* g, const T* h3g,
          double g_s, double h3g_s, const T* weights, T* sig_new, T* sig_test, uint32_t* pgp,
          T* elv, long long ne, int large_disp, void* stream) {
  const Args<T> a{coords,  table,   disp,    du,      sig,      sig_yield,
                  dmat,    dstride, g,       h3g,     static_cast<T>(g_s),
                  static_cast<T>(h3g_s),     weights, sig_new,  sig_test,
                  pgp,     elv,     ne};
  return run<T>(a, large_disp != 0, stream);
}

// -- the node pass --------------------------------------------------------------

template <typename T>
struct NodeArgs {
  const T* elv;        // (rows of 3): row order[p] adds into node segs[u]
  const int* order;    // (nsum,)
  const int* offsets;  // (nu + 1,)
  const int* segs;     // (nu,)
  const int* holes;    // (nholes,)
  long long nu, nholes;
  T* qin;              // (3 (nu + nholes),)
  const T* glv;        // the residual form: (3 (nu + nholes),)
  const T* fixmask;
  T* r;
  double* partials;    // (gridDim.x,)
  unsigned* ticket;    // 0 before the launch; 0 after it
  T* error;            // 0-dim
  T lbd1, relax;
  double qnorm;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// the block's sum of v, valid in thread 0: a shuffle tree in each warp
// (lane i adds lane i + o, o = 16, 8, 4, 2, 1), then the warps' sums in
// order; every thread of the block calls it
__device__ __forceinline__ double block_sum(double v, double* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kNodeThreads / 32; ++w) s = __dadd_rn(s, warp_sums[w]);
  __syncthreads();
  return s;
}

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kNodeThreads) stress_node_kernel(const NodeArgs<T> a) {
  const long long t = static_cast<long long>(blockIdx.x) * kNodeThreads + threadIdx.x;
  double v = 0.0;
  if (t < a.nu + a.nholes) {
    T q[3] = {T(0), T(0), T(0)};
    long long row;
    if (t < a.nu) {
      row = a.segs[t];
      fcvm_segment::gather_sum<T, 3, kNodeDepth>(q, a.elv, a.order, a.offsets[t],
                                                   a.offsets[t + 1], 3, 1);
    } else {
      row = a.holes[t - a.nu];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) a.qin[3 * row + c] = q[c];
    if (kResidual) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const long long i = 3 * row + c;
        const T raw = mul_rn(a.fixmask[i], sub_rn(mul_rn(a.lbd1, a.glv[i]), q[c]));
        a.r[i] = mul_rn(a.relax, raw);
        const double d = static_cast<double>(raw);
        v = __dadd_rn(v, __dmul_rn(d, d));
      }
    }
  }
  if (!kResidual) return;
  __shared__ double warp_sums[kNodeThreads / 32];
  __shared__ bool last;
  const double part = block_sum(v, warp_sums);
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = part;
    __threadfence();  // the partial before the ticket
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every block's partial after its ticket
  double s = 0.0;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kNodeThreads)
    s = __dadd_rn(s, __ldcg(a.partials + b));
  s = block_sum(s, warp_sums);
  if (threadIdx.x == 0) {
    *a.error = static_cast<T>(__ddiv_rn(__dsqrt_rn(s), a.qnorm));
    *a.ticket = 0u;
  }
}

template <typename T>
int node_run(const NodeArgs<T>& a, void* stream) {
  const long long units = a.nu + a.nholes;
  if (units <= 0) return 0;
  const long long blocks = (units + kNodeThreads - 1) / kNodeThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.glv != nullptr)
    stress_node_kernel<T, true><<<static_cast<unsigned>(blocks), kNodeThreads, 0, s>>>(a);
  else
    stress_node_kernel<T, false><<<static_cast<unsigned>(blocks), kNodeThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int node_entry(const T* elv, const int* order, const int* offsets, const int* segs,
               const int* holes, long long nu, long long nholes, T* qin, const T* glv,
               const T* fixmask, T* r, double* partials, unsigned* ticket, T* error,
               double lbd1, double relax, double qnorm, void* stream) {
  const NodeArgs<T> a{elv,     order,   offsets, segs,     holes,  nu,
                      nholes,  qin,     glv,     fixmask,  r,      partials,
                      ticket,  error,   static_cast<T>(lbd1),       static_cast<T>(relax),
                      qnorm};
  return node_run<T>(a, stream);
}

}  // namespace

// du null: the given-stress form (sig is the stress; only elv is written).
// g or h3g null: their scalars g_s and h3g_s, in the kernel's type.
// table: the int32 (10, ne) element-major node table
// (ops/kernels.py::element_table).
extern "C" int fcvm_stress_update_f32(const float* coords, const int* table, const float* disp,
                                      const float* du, const float* sig,
                                      const float* sig_yield, const float* dmat,
                                      long long dstride, const float* g, const float* h3g,
                                      double g_s, double h3g_s, const float* weights,
                                      float* sig_new, float* sig_test, uint32_t* pgp,
                                      float* elv, long long ne, int large_disp, void* stream) {
  return entry<float>(coords, table, disp, du, sig, sig_yield, dmat, dstride, g, h3g, g_s,
                      h3g_s, weights, sig_new, sig_test, pgp, elv, ne, large_disp, stream);
}

extern "C" int fcvm_stress_update_f64(const double* coords, const int* table,
                                      const double* disp, const double* du, const double* sig,
                                      const double* sig_yield, const double* dmat,
                                      long long dstride, const double* g, const double* h3g,
                                      double g_s, double h3g_s, const double* weights,
                                      double* sig_new, double* sig_test, uint32_t* pgp,
                                      double* elv, long long ne, int large_disp, void* stream) {
  return entry<double>(coords, table, disp, du, sig, sig_yield, dmat, dstride, g, h3g, g_s,
                       h3g_s, weights, sig_new, sig_test, pgp, elv, ne, large_disp, stream);
}

// The partials of the residual form: one double a block of the node pass.
extern "C" long long fcvm_node_force_blocks(long long units) {
  return (units + kNodeThreads - 1) / kNodeThreads;
}

// glv null: the internal force alone (fixmask, r, partials, ticket and
// error unread); else the residual form.
extern "C" int fcvm_node_force_f32(const float* elv, const int* order, const int* offsets,
                                   const int* segs, const int* holes, long long nu,
                                   long long nholes, float* qin, const float* glv,
                                   const float* fixmask, float* r, double* partials,
                                   unsigned* ticket, float* error, double lbd1, double relax,
                                   double qnorm, void* stream) {
  return node_entry<float>(elv, order, offsets, segs, holes, nu, nholes, qin, glv, fixmask, r,
                           partials, ticket, error, lbd1, relax, qnorm, stream);
}

extern "C" int fcvm_node_force_f64(const double* elv, const int* order, const int* offsets,
                                   const int* segs, const int* holes, long long nu,
                                   long long nholes, double* qin, const double* glv,
                                   const double* fixmask, double* r, double* partials,
                                   unsigned* ticket, double* error, double lbd1, double relax,
                                   double qnorm, void* stream) {
  return node_entry<double>(elv, order, offsets, segs, holes, nu, nholes, qin, glv, fixmask, r,
                            partials, ticket, error, lbd1, relax, qnorm, stream);
}
