// Variants of K2's element pass for fcvm_tpu_torch/tools/k2_probe.py (not
// in ops/kernels.py's SOURCES; the solver never loads it), on the
// small-strain update with one material.
//
// Beside the pass (stress_update_kernel: a thread a Gauss point reading its
// nodes from global memory where it needs them), two staged designs that
// share its arithmetic (gauss_point) on operands in shared memory, each at
// 32 or 64 elements a tile and three occupancy targets (__launch_bounds__:
// 3/4, 1 and 3/2 times kThreadsPerSm threads an SM):
//   - one tile a block: thread 0 copies the tile's sig and sig_yield by bulk
//     copies, the block gathers each of the tile's distinct nodes once, in
//     ascending order (tables of each tile's distinct nodes and each pair's
//     index among them, made by the probe), lays the pairs out [k][i][e],
//     computes and writes its outputs as 16-byte coalesced stores, its phases
//     one after another;
//   - persistent and pipelined: a producer warp for each 32 elements stages
//     the next tile in one of two stages while the consumers compute one.
// Each in modes: the pass, its memory traffic alone (copies, gathers,
// staged stores; no Gauss-point arithmetic) and its arithmetic alone (every
// gather on the first tile's nodes, cache hits); one tile a block also its
// copies and stores alone and its copies and gathers alone.

#include "stress_update.cu"

#include "bulk.cuh"
#include "ring.cuh"

namespace {

constexpr int kBatch = 4;  // the staged gathers' loads a thread issues together

// the threads an SM the staged variants ask for at least
// (__launch_bounds__), by dtype: 1024 in float32, 512 in float64
template <typename T>
constexpr int kThreadsPerSm = sizeof(T) == 4 ? 1024 : 512;

// what a staged variant's launch runs (see the top of this file)
enum Mode : int {
  kPass = 0,
  kMemoryOnly = 1,
  kArithmeticOnly = 2,
  kCopiesAndStores = 3,
  kCopiesAndGathers = 4
};

// the tables of each tile's distinct nodes: node k of element e is
// nodes[offsets[e / kE] + local[k ne + e]]
struct Tiles {
  const short* local;
  const int* offsets;
  const int* nodes;
};

// a tile's element el's nodes in shared memory, [k][i][e]
template <typename T, int kE>
struct SharedNodes {
  const T* pos;
  const T* du;
  int el;
  __device__ __forceinline__ T x(int k, int i) const { return pos[(3 * k + i) * kE + el]; }
  __device__ __forceinline__ T u(int k, int i) const { return du[(3 * k + i) * kE + el]; }
};

// count values from shared src to global dst, both 16-byte aligned: 16-byte
// stores by the block's lanes, the tail one value each
template <typename T, int kThreads>
__device__ __forceinline__ void store_out(T* __restrict__ dst, const T* src, int count) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const int nv = count / kV;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < nv; i += kThreads) d4[i] = s4[i];
  for (int i = nv * kV + threadIdx.x; i < count; i += kThreads) dst[i] = src[i];
}

// The staging of gauss_point without its arithmetic (a probe's memory
// traffic alone): each staged value read once.
template <typename T, int kE, bool kGiven>
__device__ __forceinline__ void stage_only(const Args<T>& a, int el, int g, long long e,
                                           const T* pos_s, const T* du_s, const T* sig_s,
                                           T* test_s, T* elv_s) {
  T s[6];
  load6(sig_s + (el * kGauss + g) * 6, s);
  if (!kGiven) store6(test_s + (el * kGauss + g) * 6, s);
  if (!kGiven && g == 0) a.pgp[e] = 0u;
  for (int j = g; j < 3 * kNodes; j += kGauss)
    elv_s[el * 3 * kNodes + j] = pos_s[j * kE + el] + (kGiven ? T(0) : du_s[j * kE + el]);
}

// A block's shared memory, in values of T after a 16-byte mbarrier slot,
// each array a multiple of 16 bytes (kE >= 32), in this order: sig (then
// sig_new), sig_yield, the pairs [k][i][e] (positions, then increments),
// then the tile's distinct nodes (positions, then increments: at most 10 kE
// each), whose space sig_test and elv take after the nodes' last read; D
// and the dN/dxi table.
template <typename T, int kE, bool kGiven>
struct Smem {
  static constexpr int kSig = kE * kGauss * 6;
  static constexpr int kYield = kGiven ? 0 : kE * kGauss;
  static constexpr int kPos = kNodes * 3 * kE;
  static constexpr int kDu = kGiven ? 0 : kNodes * 3 * kE;
  static constexpr int kNodeBuf = kPos + kDu;
  static constexpr int kTest = kGiven ? 0 : kE * kGauss * 6;
  static constexpr int kOut = kTest + kE * 3 * kNodes;
  static constexpr int kShared = kNodeBuf > kOut ? kNodeBuf : kOut;
  static constexpr int kPosAt = kSig + kYield;
  static constexpr int kDuAt = kPosAt + kPos;
  static constexpr int kSharedAt = kDuAt + kDu;
  static constexpr int kElvAt = kSharedAt + kTest;
  static constexpr int kDAt = kSharedAt + kShared;
  static constexpr int kTableAt = kDAt + (kGiven ? 0 : 36);
  static constexpr int kBytes = 16 + static_cast<int>(sizeof(T)) * (kTableAt + kTable);
};

// The staged variant: block b takes tile b, kE elements, a thread for each
// (element, Gauss point): thread 0 copies the tile's sig and sig_yield by
// bulk copies, the block loads its pairs' local node indices and gathers
// each of its distinct nodes once, ascending (the position, with disp under
// large_disp, and the increment), lays the pairs out [k][i][e], computes
// the Gauss points and writes its outputs as 16-byte coalesced stores.
template <typename T, int kE, bool kGiven, bool kLarge, int kSm = kThreadsPerSm<T>,
          int kMode = kPass>
__global__ void __launch_bounds__(4 * kE, (kSm / (4 * kE) > 0 ? kSm / (4 * kE) : 1))
    tile_kernel(const Args<T> a, const Tiles t) {
  using S = Smem<T, kE, kGiven>;
  constexpr int kThreads = 4 * kE;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* base = reinterpret_cast<T*>(smem + 16);
  T* sig_s = base;
  T* yield_s = base + S::kSig;
  T* pos_s = base + S::kPosAt;
  T* du_s = base + S::kDuAt;
  T* nodes_s = base + S::kSharedAt;  // the tile's distinct nodes' positions [node][i]
  T* node_du_s = nodes_s + S::kPos;  // and increments
  T* test_s = base + S::kSharedAt;   // over the nodes, once they are read
  T* elv_s = base + S::kElvAt;
  T* d_s = base + S::kDAt;
  T* table = base + S::kTableAt;

  const long long e0 = static_cast<long long>(blockIdx.x) * kE;
  const int n = static_cast<int>(a.ne - e0 < kE ? a.ne - e0 : kE);  // the tile's elements
  if (threadIdx.x == 0) {
    // the tile's stresses and yield stresses: contiguous, multiples of 16
    // bytes at 16-byte aligned addresses (the caller's alignment, 96 or 192
    // bytes an element)
    const uint32_t sig_bytes = static_cast<uint32_t>(n * kGauss * 6 * sizeof(T));
    const uint32_t yield_bytes = kGiven ? 0u : static_cast<uint32_t>(n * kGauss * sizeof(T));
    fcvm_bulk::mbar_init(bar, 1);
    fcvm_bulk::fence_barrier_init();
    fcvm_bulk::mbar_expect_tx(bar, sig_bytes + yield_bytes);
    fcvm_bulk::bulk_copy_g2s(sig_s, a.sig + e0 * kGauss * 6, sig_bytes, bar);
    if (!kGiven) fcvm_bulk::bulk_copy_g2s(yield_s, a.sig_yield + e0 * kGauss, yield_bytes, bar);
  }
  // this thread's (element, node) pairs, lane p taking node p / kE of
  // element p % kE: their indices among the tile's distinct nodes, loaded
  // first (a probe's arithmetic alone takes the first tile's everywhere)
  constexpr int kPairs = (kNodes * kE + kThreads - 1) / kThreads;
  const long long eb = kMode == kArithmeticOnly ? 0 : e0;
  const int tile = kMode == kArithmeticOnly ? 0 : static_cast<int>(blockIdx.x);
  int loc[kPairs];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int p = threadIdx.x + j * kThreads, k = p / kE, el = p % kE;
    loc[j] = p < kNodes * kE && el < n ? __ldg(t.local + k * a.ne + eb + el) : 0;
  }
  for (int i = threadIdx.x; i < kTable; i += kThreads) table[i] = static_cast<T>(kDshp[i]);
  if (!kGiven && a.dstride == 0 && threadIdx.x < 36) d_s[threadIdx.x] = a.dmat[threadIdx.x];
  // each distinct node of the tile once, in ascending order, so
  // neighbouring lanes read neighbouring rows: value v is component v % 3
  // of the tile's node v / 3; a thread's loads of kBatch values issued
  // before their stores
  const int first = __ldg(t.offsets + tile);
  const int values =
      kMode == kCopiesAndStores ? 0 : 3 * (__ldg(t.offsets + tile + 1) - first);
  for (int v0 = threadIdx.x; v0 < values; v0 += kBatch * kThreads) {
    long long at[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int v = v0 + b * kThreads, j = v / 3;
      at[b] = v < values ? 3LL * __ldg(t.nodes + first + j) + (v - 3 * j) : -1;
    }
    T x[kBatch], u[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (at[b] < 0) continue;
      x[b] = __ldg(a.coords + at[b]);
      if (kLarge) x[b] += __ldg(a.disp + at[b]);
      if (!kGiven) u[b] = __ldg(a.du + at[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (at[b] < 0) continue;
      nodes_s[v0 + b * kThreads] = x[b];
      if (!kGiven) node_du_s[v0 + b * kThreads] = u[b];
    }
  }
  __syncthreads();
  // each pair from its node, into [k][i][e]
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const int p = threadIdx.x + j * kThreads, k = p / kE, el = p % kE;
    if (kMode != kCopiesAndStores && p < kNodes * kE && el < n) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pos_s[(3 * k + i) * kE + el] = nodes_s[3 * loc[j] + i];
        if (!kGiven) du_s[(3 * k + i) * kE + el] = node_du_s[3 * loc[j] + i];
      }
    }
  }
  __syncthreads();
  fcvm_bulk::mbar_wait(bar, 0);

  const int el = threadIdx.x >> 2, g = threadIdx.x & 3;
  const bool valid = el < n;
  const long long e = valid ? e0 + el : e0;
  if (kMode == kPass || kMode == kArithmeticOnly)
    gauss_point<T, kGiven, kLarge>(a, SharedNodes<T, kE>{pos_s, du_s, el}, g, valid, e,
                                   sig_s + (el * kGauss + g) * 6, yield_s[el * kGauss + g],
                                   sig_s + (el * kGauss + g) * 6, test_s + (el * kGauss + g) * 6,
                                   elv_s + el * 3 * kNodes, d_s, table);
  else if (valid)
    stage_only<T, kE, kGiven>(a, el, g, e, pos_s, du_s, sig_s, test_s, elv_s);
  __syncthreads();
  if (kMode == kCopiesAndGathers) return;
  store_out<T, kThreads>(a.elv + e0 * 3 * kNodes, elv_s, n * 3 * kNodes);
  if (!kGiven) {
    store_out<T, kThreads>(a.sig_new + e0 * kGauss * 6, sig_s, n * kGauss * 6);
    store_out<T, kThreads>(a.sig_test + e0 * kGauss * 6, test_s, n * kGauss * 6);
  }
}

template <typename T, int kE, bool kGiven, bool kLarge, int kSm = kThreadsPerSm<T>,
          int kMode = kPass>
int tile_launch(const Args<T>& a, const Tiles& t, cudaStream_t stream) {
  const auto kernel = tile_kernel<T, kE, kGiven, kLarge, kSm, kMode>;
  constexpr int kSmem = Smem<T, kE, kGiven>::kBytes;
  // the first launch on a device raises the kernel's dynamic shared memory
  // limit (resident_blocks sets it)
  static int resident[fcvm_ring::kMaxDevices];
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (dev >= fcvm_ring::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    const int err = fcvm_ring::resident_blocks(kernel, 4 * kE, kSmem, resident + dev);
    if (err != 0) return err;
  }
  const long long tiles = (a.ne + kE - 1) / kE;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(tiles), 4 * kE, kSmem, stream>>>(a, t);
  return static_cast<int>(cudaGetLastError());
}

// The pipelined variant's shared memory, in values of T after 32
// bytes of mbarriers (full[2], empty[2]): two stages of a tile's inputs
// (sig or the given stress, sig_yield, the pairs' local node indices), the
// tile's pairs, its staged outputs, D and the dN/dxi table, each array a
// multiple of 16 bytes (kE >= 32); then the two stages' distinct nodes
// (positions, then increments, 3 max_nodes values each), sized at launch.
template <typename T, int kE, bool kGiven>
struct Layout {
  static constexpr int kSig = kE * kGauss * 6;                          // sig, then sig_new
  static constexpr int kYield = kGiven ? 0 : kE * kGauss;
  static constexpr int kLoc = kNodes * kE * 2 / static_cast<int>(sizeof(T));  // int16 [k][e]
  static constexpr int kStage = kSig + kYield + kLoc;
  static constexpr int kPosAt = 2 * kStage;                              // [k][i][e]
  static constexpr int kDuAt = kPosAt + kNodes * 3 * kE;
  static constexpr int kTestAt = kDuAt + (kGiven ? 0 : kNodes * 3 * kE);
  static constexpr int kElvAt = kTestAt + (kGiven ? 0 : kE * kGauss * 6);  // [e][30]
  static constexpr int kDAt = kElvAt + kE * 3 * kNodes;
  static constexpr int kTableAt = kDAt + (kGiven ? 0 : 36);
  static constexpr int kNodesAt = kTableAt + kTable;
  // a stage's distinct nodes: positions, then (the update) increments
  static __host__ __device__ int stage_nodes(int max_nodes) {
    return (3 * max_nodes * (kGiven ? 1 : 2) + 3) / 4 * 4;
  }
  static int bytes(int max_nodes) {
    return 32 + static_cast<int>(sizeof(T)) * (kNodesAt + 2 * stage_nodes(max_nodes));
  }
};

__device__ __forceinline__ void consumers_sync(int count) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(count) : "memory");
}

// A variant of the element pass, persistent and pipelined (measured slower
// than the pass, PERF.md): block b takes tiles b, b + G,
// ... of kE elements.  Its kE producer threads stage a tile's inputs while
// its 4 kE consumer threads (a thread a Gauss point) work on the tile
// before: thread 0 of the producers copies the tile's sig and sig_yield by
// bulk copies, and the producers load its pairs' local node indices and
// gather each of its distinct nodes once, ascending (the position, with
// disp under large_disp, and the increment), into one of two stages; a
// stage's full mbarrier completes when all of it has landed, its empty
// mbarrier when every consumer has stored the tile it held.  The consumers
// lay the tile's pairs out [k][i][e], compute its Gauss points and write
// its outputs as 16-byte coalesced stores.
template <typename T, int kE, bool kGiven, bool kLarge, int kSm = kThreadsPerSm<T>,
          int kMode = kPass>
__global__ void __launch_bounds__(5 * kE, (kSm / (5 * kE) > 0 ? kSm / (5 * kE) : 1))
    pipelined_kernel(const Args<T> a, const Tiles tiles, const int max_nodes) {
  using L = Layout<T, kE, kGiven>;
  constexpr int kCompute = 4 * kE, kProducers = kE, kThreads = 5 * kE;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + 2;
  T* base = reinterpret_cast<T*>(smem + 32);
  T* pos_s = base + L::kPosAt;
  T* du_s = base + L::kDuAt;
  T* test_s = base + L::kTestAt;
  T* elv_s = base + L::kElvAt;
  T* d_s = base + L::kDAt;
  T* table = base + L::kTableAt;
  const int stage_nodes = L::stage_nodes(max_nodes);
  const long long ntiles = (a.ne + kE - 1) / kE;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      fcvm_bulk::mbar_init(full + b, kProducers);
      fcvm_bulk::mbar_init(empty + b, kCompute);
    }
    fcvm_bulk::fence_barrier_init();
  }
  for (int i = threadIdx.x; i < kTable; i += kThreads) table[i] = static_cast<T>(kDshp[i]);
  if (!kGiven && a.dstride == 0 && threadIdx.x < 36) d_s[threadIdx.x] = a.dmat[threadIdx.x];
  __syncthreads();

  if (threadIdx.x >= kCompute) {  // the producers
    const int q = threadIdx.x - kCompute;
    int i = 0;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
      const int b = i & 1;
      if (i >= 2) fcvm_bulk::mbar_wait(empty + b, ((i >> 1) & 1) ^ 1);
      T* stage = base + b * L::kStage;
      short* loc_s = reinterpret_cast<short*>(stage + L::kSig + L::kYield);
      T* nodes_s = base + L::kNodesAt + b * stage_nodes;
      const long long e0 = t * kE;
      const int n = static_cast<int>(a.ne - e0 < kE ? a.ne - e0 : kE);
      const uint32_t sig_bytes = static_cast<uint32_t>(n * kGauss * 6 * sizeof(T));
      const uint32_t yield_bytes = kGiven ? 0u : static_cast<uint32_t>(n * kGauss * sizeof(T));
      if (q == 0) {
        // the tile's stresses and yield stresses: contiguous, multiples of 16
        // bytes at 16-byte aligned addresses (the caller's alignment, 96 or
        // 192 bytes an element); the consumers' reads of the stage first
        fcvm_bulk::fence_proxy_async();
        fcvm_bulk::bulk_copy_g2s(stage, a.sig + e0 * kGauss * 6, sig_bytes, full + b);
        if (!kGiven)
          fcvm_bulk::bulk_copy_g2s(stage + L::kSig, a.sig_yield + e0 * kGauss, yield_bytes,
                                   full + b);
      }
      // the pairs' indices among the tile's distinct nodes, [k][e], and each
      // distinct node once, value v component v % 3 of node v / 3, a
      // thread's loads of kBatch values issued before their stores (a
      // probe's arithmetic alone takes the first tile's everywhere)
      const long long et = kMode == kArithmeticOnly ? 0 : e0;
      for (int j = q; j < kNodes * kE; j += kProducers) {
        const int k = j / kE, el = j % kE;
        loc_s[j] = el < n ? __ldg(tiles.local + k * a.ne + et + el) : short(0);
      }
      const long long tt = kMode == kArithmeticOnly ? 0 : t;
      const int first = __ldg(tiles.offsets + tt);
      const int values = 3 * (__ldg(tiles.offsets + tt + 1) - first);
      for (int v0 = q; v0 < values; v0 += kBatch * kProducers) {
        long long at[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int v = v0 + k * kProducers, j = v / 3;
          at[k] = v < values ? 3LL * __ldg(tiles.nodes + first + j) + (v - 3 * j) : -1;
        }
        T x[kBatch], u[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (at[k] < 0) continue;
          x[k] = __ldg(a.coords + at[k]);
          if (kLarge) x[k] += __ldg(a.disp + at[k]);
          if (!kGiven) u[k] = __ldg(a.du + at[k]);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (at[k] < 0) continue;
          nodes_s[v0 + k * kProducers] = x[k];
          if (!kGiven) nodes_s[3 * max_nodes + v0 + k * kProducers] = u[k];
        }
      }
      // thread 0 arrives with the copies' bytes, after its own stores
      if (q == 0)
        fcvm_bulk::mbar_expect_tx(full + b, sig_bytes + yield_bytes);
      else
        fcvm_bulk::mbar_arrive(full + b);
    }
    return;
  }

  // the consumers
  constexpr int kPairs = (kNodes * kE + kCompute - 1) / kCompute;
  const int el = threadIdx.x >> 2, g = threadIdx.x & 3;
  int i = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int b = i & 1;
    T* sig_s = base + b * L::kStage;
    const T* yield_s = sig_s + L::kSig;
    const short* loc_s = reinterpret_cast<const short*>(yield_s + L::kYield);
    const T* nodes_s = base + L::kNodesAt + b * stage_nodes;
    const long long e0 = t * kE;
    const int n = static_cast<int>(a.ne - e0 < kE ? a.ne - e0 : kE);
    fcvm_bulk::mbar_wait(full + b, (i >> 1) & 1);
    // each pair from its node, into [k][i][e]
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int p = threadIdx.x + j * kCompute, k = p / kE, pe = p % kE;
      if (p < kNodes * kE && pe < n) {
        const int l = 3 * loc_s[p];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          pos_s[(3 * k + c) * kE + pe] = nodes_s[l + c];
          if (!kGiven) du_s[(3 * k + c) * kE + pe] = nodes_s[3 * max_nodes + l + c];
        }
      }
    }
    consumers_sync(kCompute);
    const bool valid = el < n;
    const long long e = valid ? e0 + el : e0;
    if (kMode == kMemoryOnly) {
      if (valid) stage_only<T, kE, kGiven>(a, el, g, e, pos_s, du_s, sig_s, test_s, elv_s);
    } else {
      gauss_point<T, kGiven, kLarge>(a, SharedNodes<T, kE>{pos_s, du_s, el}, g, valid, e,
                                     sig_s + (el * kGauss + g) * 6, yield_s[el * kGauss + g],
                                     sig_s + (el * kGauss + g) * 6,
                                     test_s + (el * kGauss + g) * 6, elv_s + el * 3 * kNodes,
                                     d_s, table);
    }
    consumers_sync(kCompute);
    store_out<T, kCompute>(a.elv + e0 * 3 * kNodes, elv_s, n * 3 * kNodes);
    if (!kGiven) {
      store_out<T, kCompute>(a.sig_new + e0 * kGauss * 6, sig_s, n * kGauss * 6);
      store_out<T, kCompute>(a.sig_test + e0 * kGauss * 6, test_s, n * kGauss * 6);
    }
    fcvm_bulk::mbar_arrive(empty + b);
  }
}

template <typename T, int kE, bool kGiven, bool kLarge, int kSm = kThreadsPerSm<T>,
          int kMode = kPass>
int pipelined_launch(const Args<T>& a, const Tiles& t, int max_nodes, cudaStream_t stream) {
  const auto kernel = pipelined_kernel<T, kE, kGiven, kLarge, kSm, kMode>;
  const int smem = Layout<T, kE, kGiven>::bytes(max_nodes);
  // a persistent grid: the blocks resident at once (by the kernel's shared
  // memory, which follows max_nodes), at most one a tile; the first launch
  // on a device at a size raises the kernel's dynamic shared memory limit
  struct Resident {
    int smem;
    int blocks;
  };
  static Resident resident[fcvm_ring::kMaxDevices];
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (dev >= fcvm_ring::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev].smem != smem) {
    int blocks = 0;
    const int err = fcvm_ring::resident_blocks(kernel, 5 * kE, smem, &blocks);
    if (err != 0) return err;
    resident[dev] = {smem, blocks};
  }
  const long long ntiles = (a.ne + kE - 1) / kE;
  const int grid = static_cast<int>(ntiles < resident[dev].blocks ? ntiles : resident[dev].blocks);
  kernel<<<grid, 5 * kE, smem, stream>>>(a, t, max_nodes);
  return static_cast<int>(cudaGetLastError());
}

// The pass: its blocks an SM read, then launched.
template <typename T>
int pass_launch(const Args<T>& a, int* per_sm, cudaStream_t s) {
  const int err = launch<T, false, false>(a, s);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, stress_update_kernel<T, false, false>, kThreads, 0));
}

// One tile a block and the pipelined variant: the same.
template <typename T, int kE, int kSm, int kMode>
int tile_variant(const Args<T>& a, const Tiles& t, int* per_sm, cudaStream_t s) {
  const int err = tile_launch<T, kE, false, false, kSm, kMode>(a, t, s);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, tile_kernel<T, kE, false, false, kSm, kMode>, 4 * kE,
      Smem<T, kE, false>::kBytes));
}

template <typename T, int kE, int kSm, int kMode>
int pipelined_variant(const Args<T>& a, const Tiles& t, int max_nodes, int* per_sm,
                      cudaStream_t s) {
  const int err = pipelined_launch<T, kE, false, false, kSm, kMode>(a, t, max_nodes, s);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, pipelined_kernel<T, kE, false, false, kSm, kMode>, 5 * kE,
      Layout<T, kE, false>::bytes(max_nodes)));
}

template <typename T, int kE, int kSm>
int probe_mode(const Args<T>& a, const Tiles& t, int max_nodes, int design, int mode,
               int* per_sm, cudaStream_t s) {
  if (design == 2) {
    switch (mode) {
      case kPass:
        return pipelined_variant<T, kE, kSm, kPass>(a, t, max_nodes, per_sm, s);
      case kMemoryOnly:
        return pipelined_variant<T, kE, kSm, kMemoryOnly>(a, t, max_nodes, per_sm, s);
      case kArithmeticOnly:
        return pipelined_variant<T, kE, kSm, kArithmeticOnly>(a, t, max_nodes, per_sm, s);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (mode) {
    case kPass:
      return tile_variant<T, kE, kSm, kPass>(a, t, per_sm, s);
    case kMemoryOnly:
      return tile_variant<T, kE, kSm, kMemoryOnly>(a, t, per_sm, s);
    case kArithmeticOnly:
      return tile_variant<T, kE, kSm, kArithmeticOnly>(a, t, per_sm, s);
    case kCopiesAndStores:
      return tile_variant<T, kE, kSm, kCopiesAndStores>(a, t, per_sm, s);
    case kCopiesAndGathers:
      return tile_variant<T, kE, kSm, kCopiesAndGathers>(a, t, per_sm, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int kE>
int probe_threads(const Args<T>& a, const Tiles& t, int max_nodes, int threads, int design,
                  int mode, int* per_sm, cudaStream_t s) {
  constexpr int kBase = kThreadsPerSm<T>;
  if (threads == kBase * 3 / 4)
    return probe_mode<T, kE, kBase * 3 / 4>(a, t, max_nodes, design, mode, per_sm, s);
  if (threads == kBase)
    return probe_mode<T, kE, kBase>(a, t, max_nodes, design, mode, per_sm, s);
  if (threads == kBase * 3 / 2)
    return probe_mode<T, kE, kBase * 3 / 2>(a, t, max_nodes, design, mode, per_sm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int probe(const T* coords, const int* table, const short* local, const int* offsets,
          const int* nodes, int max_nodes, const T* du, const T* sig, const T* sig_yield,
          const T* dmat, double g_s, double h3g_s, T* sig_new, T* sig_test, uint32_t* pgp,
          T* elv, long long ne, int elements, int threads, int design, int mode, int* per_sm,
          void* stream) {
  if (ne <= 0) return 0;
  const Args<T> a{coords,  table,   nullptr, du,      sig,      sig_yield,
                  dmat,    0,       nullptr, nullptr, static_cast<T>(g_s),
                  static_cast<T>(h3g_s),     nullptr, sig_new,  sig_test,
                  pgp,     elv,     ne};
  const Tiles t{local, offsets, nodes};
  const auto s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    if (mode != kPass) return static_cast<int>(cudaErrorInvalidValue);
    return pass_launch<T>(a, per_sm, s);
  }
  if (elements == 32)
    return probe_threads<T, 32>(a, t, max_nodes, threads, design, mode, per_sm, s);
  if (elements == 64)
    return probe_threads<T, 64>(a, t, max_nodes, threads, design, mode, per_sm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The small-strain update with one D and one material: the arguments of
// fcvm_stress_update_f32 that it reads; local, offsets, nodes: the staged
// variants' tables of tiles of `elements` elements, max_nodes the most
// distinct nodes a tile has (it sizes the pipelined variant's shared
// memory); threads: a staged variant's occupancy target; design: 0 the
// pass, 1 one tile a block, 2 pipelined; mode: 0 the pass, 1 its memory
// traffic, 2 its arithmetic (one tile a block also 3 its copies and
// stores, 4 its copies and gathers); per_sm: the blocks an SM holds,
// written.
extern "C" int fcvm_k2_probe_f32(const float* coords, const int* table, const short* local,
                                 const int* offsets, const int* nodes, int max_nodes,
                                 const float* du, const float* sig, const float* sig_yield,
                                 const float* dmat, double g_s, double h3g_s, float* sig_new,
                                 float* sig_test, uint32_t* pgp, float* elv, long long ne,
                                 int elements, int threads, int design, int mode, int* per_sm,
                                 void* stream) {
  return probe<float>(coords, table, local, offsets, nodes, max_nodes, du, sig, sig_yield, dmat,
                      g_s, h3g_s, sig_new, sig_test, pgp, elv, ne, elements, threads, design,
                      mode, per_sm, stream);
}

extern "C" int fcvm_k2_probe_f64(const double* coords, const int* table, const short* local,
                                 const int* offsets, const int* nodes, int max_nodes,
                                 const double* du, const double* sig, const double* sig_yield,
                                 const double* dmat, double g_s, double h3g_s, double* sig_new,
                                 double* sig_test, uint32_t* pgp, double* elv, long long ne,
                                 int elements, int threads, int design, int mode, int* per_sm,
                                 void* stream) {
  return probe<double>(coords, table, local, offsets, nodes, max_nodes, du, sig, sig_yield,
                       dmat, g_s, h3g_s, sig_new, sig_test, pgp, elv, ne, elements, threads,
                       design, mode, per_sm, stream);
}
