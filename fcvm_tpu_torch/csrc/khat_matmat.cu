// K1m: the fused block K_hat·V of the buckling eigensolve, for Hopper (sm_90a).
//
// Replaces the XLA-lowered chains of the JAX package's
// fcvm_tpu/runtime/buckling.py::_multi_matvec and
// fcvm_tpu/ops/deflation.py::block_khat_matvec (node-row gather of an
// (ndof, m) block -> block product -> node reduction -> Dirichlet masks),
// and K0 under the vmap of make_bc_matvec in buckling.py::_kinv.  For U of
// shape (3 nn, m), row-major with the column axis last, it computes
//
//     masked:     Y = P K (P U) + (I - P) U,   P = diag(fixmask)
//     projected:  Y = P K (P U)                (-G_hat·V once negated)
//     raw:        Y = K U
//
// each optionally negated, for K given by K1's packed symmetric blocks
// (tile-major (ntiles, 465, E), E = 256 in f32 and 128 in f64, the last
// tile zero-padded: ops/kernels.py::pack_blocks) and K1's node table and
// node-incidence CSR (ops/assembly.py::node_incidence).
//
// What bounds it: reading the packed blocks (1860 bytes an element in f32,
// 3720 in f64), then the tables, U and Y once; fe, the element output
// (30, ne, m), is written once and read once by the node pass, mostly
// beyond the 50 MB L2 at m = 8.  Two kernels:
//   1. the element pass, K1's (csrc/packed.cuh): a persistent grid; one
//      producer thread copies stages of 31 packed rows into a ring of
//      shared-memory slots (about 96 KB whatever the stage's size) while
//      the consumers sum the stages before.  The column split: K1 keeps an
//      element's 30 gathered values and 30 sums in registers, which for 8
//      columns would be 480 values a thread.  So a thread owns one
//      (element, column): kCols threads (1, 2, 4 or 8, the least power of
//      two >= min(m, 8)) share an element, read the same shared-memory
//      entry (a broadcast, no bank conflict) and hold 60 values each.  The
//      register file then holds one tile's elements at kCols = 1 only, so a
//      thread block takes a sub-tile of kEs = 512 / kCols elements in f32
//      (256 / kCols in f64, at most a tile): a stage is a box of 31 packed
//      rows of kEs values each, strided by the tile.  It is one TMA request
//      of a 2-D tensor map over the packed copy (cp.async.bulk.tensor): as
//      31 bulk copies, one a row, the stages landed at 1.3 TB/s at kEs = 64
//      (256 bytes a copy: a cost a request, the same from the L2), and the
//      element pass took twice its time without copies (PERF.md).  A warp's
//      lanes run column fastest, so the gathers of U rows and the stores of
//      fe are contiguous runs.  Where m
//      is wider than 8 (the deflation builds' 32 and 64) a block walks its
//      sub-tile once for each chunk of 8 columns, the blocks re-read from
//      the L2 after the first chunk (the L2 evict-first hint only when there
//      is one chunk);
//   2. the node pass: one thread a (node, column) sums the node's incident
//      rows of fe in the fixed order of the incidence table
//      (fcvm_segment::gather_sum, K8's sum), then applies the mask, the
//      identity on fixed dofs and the sign.
// No atomics and a fixed order everywhere (each element's entries in packed
// order, each node's incidences in table order), so two calls on the same
// inputs give the same bits.  Sums accumulate in the input type, with FMA;
// nothing is lowered in precision.
//
// C interface: returns cudaGetLastError() after the launches (0 = launched);
// form 0 raw (fixmask == nullptr), 1 projected, 2 masked; negate 0 or 1.
// The caller owns all memory (fe is its scratch) and the stream; the
// kernels do not synchronise.  csrc/ops.cpp binds it to PyTorch as
// torch.ops.fcvm.khat_matmat.

#include <cstdint>
#include <utility>

#include <cuda.h>
#include <cuda_runtime.h>

#include "bulk.cuh"
#include "packed.cuh"
#include "ring.cuh"
#include "segment.cuh"

namespace {

using fcvm_packed::kDofs;
using fcvm_packed::kNodes;
using fcvm_packed::kPacked;
using fcvm_packed::kRows;
using fcvm_packed::kStages;
constexpr int kNodeThreads = 256;
constexpr int kRingBytes = 3 * kRows * 1024;  // K1's ring: 3 slots of 31 KB
constexpr int kMaxCols = 8;                   // columns a chunk

enum Form { kRaw = 0, kProjected = 1, kMasked = 2 };

// The shape of the element pass for elements of T at kCols columns a chunk.
template <typename T, int kCols>
struct Shape {
  static constexpr int kTile = 1024 / static_cast<int>(sizeof(T));     // pack_blocks' E
  static constexpr int kThreadsMax = sizeof(T) == 4 ? 512 : 256;        // consumers
  static constexpr int kEs = kThreadsMax / kCols < kTile ? kThreadsMax / kCols : kTile;
  static constexpr int kConsumers = kEs * kCols;
  static constexpr int kStageBytes = kRows * kEs * static_cast<int>(sizeof(T));
  static constexpr int kSlots = kRingBytes / kStageBytes;
  static constexpr int kSmem = kSlots * kStageBytes + 128;  // + the slack to align the ring
  static_assert(kTile % kEs == 0 && kConsumers % 32 == 0, "whole sub-tiles and warps");
  static_assert((kEs * sizeof(T)) % 16 == 0 && kStageBytes % 128 == 0,
                "a box row is 16-byte sized, a slot 128-byte aligned");
};

// The element pass: Shape::kConsumers consumer threads, thread t on element
// t / kCols of the sub-tile and column t % kCols of the chunk, and one
// producer warp.  Block b takes sub-tiles b, b + gridDim.x, ..., each for
// every chunk of columns in turn.
template <typename T, int kCols, bool kMaskIn>
__global__ void __launch_bounds__(Shape<T, kCols>::kConsumers + 32)
element_kernel(const __grid_constant__ CUtensorMap packed, const int* __restrict__ elnodes_t,
               const T* __restrict__ x, const T* __restrict__ fixmask, T* __restrict__ fe,
               long long ne, long long nsub, int m, int nchunks) {
  using S = Shape<T, kCols>;
  constexpr int kEs = S::kEs, kSlots = S::kSlots;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots];
  // a tensor copy lands at a 128-byte aligned address (kSmem holds the slack)
  T* const ring =
      reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(smem) + 127) & ~uintptr_t{127});
  const long long my_subs =
      nsub > blockIdx.x ? (nsub - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const long long my_items = my_subs * nchunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      fcvm_bulk::mbar_init(full + s, 1);
      fcvm_bulk::mbar_init(empty + s, S::kConsumers / 32);
    }
    fcvm_bulk::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= S::kConsumers) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == S::kConsumers) {
      const bool once = nchunks == 1;  // read once: evict first from the L2
      const uint64_t policy = fcvm_bulk::evict_first_policy();
      long long k = 0;
      for (long long n = 0; n < my_items; ++n) {
        const long long sub = blockIdx.x + (n / nchunks) * gridDim.x;
        const int x0 = static_cast<int>(sub % (S::kTile / kEs)) * kEs;
        const int y0 = static_cast<int>(sub / (S::kTile / kEs)) * kPacked;
        for (int st = 0; st < kStages; ++st, ++k) {
          const int slot = static_cast<int>(k % kSlots);
          if (k >= kSlots) {
            fcvm_bulk::mbar_wait(empty + slot, static_cast<uint32_t>((k / kSlots - 1) & 1));
            fcvm_bulk::fence_proxy_async();  // the consumers' reads before the refill
          }
          T* dst = ring + slot * kRows * kEs;
          fcvm_bulk::mbar_expect_tx(full + slot, S::kStageBytes);
          if (once)
            fcvm_bulk::tensor_copy_2d_g2s_hint(dst, &packed, x0, y0 + st * kRows, full + slot,
                                               policy);
          else
            fcvm_bulk::tensor_copy_2d_g2s(dst, &packed, x0, y0 + st * kRows, full + slot);
        }
      }
    }
    return;
  }

  const fcvm_packed::Ring bars{full, empty};
  const int c = threadIdx.x % kCols, el = threadIdx.x / kCols;
  for (long long n = 0; n < my_items; ++n) {
    const long long sub = blockIdx.x + (n / nchunks) * gridDim.x;
    const long long e = sub * kEs + el;
    const int col = static_cast<int>(n % nchunks) * kCols + c;
    const bool live = e < ne && col < m;
    T u[kDofs], y[kDofs];
#pragma unroll
    for (int i = 0; i < kDofs; ++i) u[i] = y[i] = T(0);
    if (live) {
#pragma unroll
      for (int nd = 0; nd < kNodes; ++nd) {
        const long long d = 3LL * elnodes_t[nd * ne + e];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const T v = x[(d + a) * m + col];
          u[3 * nd + a] = kMaskIn ? fixmask[d + a] * v : v;
        }
      }
    }
    fcvm_packed::block_sum<kEs, kSlots>(ring, bars, n * kStages, el, y, u,
                                        std::make_integer_sequence<int, kStages>{});
    if (live) {
#pragma unroll
      for (int i = 0; i < kDofs; ++i) fe[(i * ne + e) * m + col] = y[i];
    }
  }
}

// One thread a (node, column): y[3n + a, col] = sum over the node's
// incidences p of fe[pos[p] + a ne, col], masked and signed.
template <typename T, int kForm>
__global__ void __launch_bounds__(kNodeThreads)
node_kernel(const T* __restrict__ fe, const int* __restrict__ offsets,
            const int* __restrict__ pos, const T* __restrict__ x,
            const T* __restrict__ fixmask, T* __restrict__ y, long long nn, long long ne, int m,
            T sign) {
  const long long t = static_cast<long long>(blockIdx.x) * kNodeThreads + threadIdx.x;
  if (t >= nn * m) return;
  const long long n = t / m;
  const int col = static_cast<int>(t % m);
  T s[3] = {T(0), T(0), T(0)};
  fcvm_segment::gather_sum<T, 3>(s, fe + col, pos, offsets[n], offsets[n + 1], m, ne * m);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const long long d = 3 * n + a;
    T v = s[a];
    if constexpr (kForm == kProjected) v = fixmask[d] * v;
    if constexpr (kForm == kMasked) v = fixmask[d] * v + (T(1) - fixmask[d]) * x[d * m + col];
    y[d * m + col] = sign * v;
  }
}

// The driver's cuTensorMapEncodeTiled, found through the runtime (no link to
// the driver library); nullptr where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The packed copy (ntiles 465 rows of kTile values) as a 2-D tensor whose
// boxes are a stage of a sub-tile: 31 rows of kEs values.
template <typename T, int kCols>
int packed_map(const T* packed, long long ntiles, CUtensorMap* map) {
  using S = Shape<T, kCols>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(S::kTile),
                              static_cast<cuuint64_t>(ntiles) * kPacked};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(S::kTile) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(S::kEs), static_cast<cuuint32_t>(kRows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 2,
      const_cast<T*>(packed), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int kCols, bool kMaskIn>
int element_pass(const T* packed, const int* elnodes_t, const T* x, const T* fixmask, T* fe,
                 long long ne, long long ntiles, int m, cudaStream_t stream) {
  using S = Shape<T, kCols>;
  const auto kernel = element_kernel<T, kCols, kMaskIn>;
  const long long nsub = ntiles * (S::kTile / S::kEs);
  if (ntiles * kPacked > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  int err = packed_map<T, kCols>(packed, ntiles, &map);
  if (err != 0) return err;
  static int resident[fcvm_ring::kMaxDevices];
  int grid = 0;
  err = fcvm_ring::persistent_grid(kernel, S::kConsumers + 32, S::kSmem, nsub, resident, &grid);
  if (err != 0) return err;
  const int nchunks = (m + kCols - 1) / kCols;
  kernel<<<grid, S::kConsumers + 32, S::kSmem, stream>>>(map, elnodes_t, x, fixmask, fe, ne,
                                                         nsub, m, nchunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kMaskIn>
int element_pass_m(const T* packed, const int* elnodes_t, const T* x, const T* fixmask, T* fe,
                   long long ne, long long ntiles, int m, cudaStream_t stream) {
  if (m == 1)
    return element_pass<T, 1, kMaskIn>(packed, elnodes_t, x, fixmask, fe, ne, ntiles, m, stream);
  if (m == 2)
    return element_pass<T, 2, kMaskIn>(packed, elnodes_t, x, fixmask, fe, ne, ntiles, m, stream);
  if (m <= 4)
    return element_pass<T, 4, kMaskIn>(packed, elnodes_t, x, fixmask, fe, ne, ntiles, m, stream);
  return element_pass<T, kMaxCols, kMaskIn>(packed, elnodes_t, x, fixmask, fe, ne, ntiles, m,
                                            stream);
}

template <typename T, int kForm>
int node_pass(const T* fe, const int* offsets, const int* pos, const T* x, const T* fixmask,
              T* y, long long nn, long long ne, int m, T sign, cudaStream_t stream) {
  const long long blocks = (nn * m + kNodeThreads - 1) / kNodeThreads;
  node_kernel<T, kForm><<<static_cast<unsigned>(blocks), kNodeThreads, 0, stream>>>(
      fe, offsets, pos, x, fixmask, y, nn, ne, m, sign);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const T* packed, const int* elnodes_t, const int* offsets, const int* pos, const T* x,
        const T* fixmask, T* fe, T* y, long long ne, long long nn, long long ntiles, int m,
        int form, int negate, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if ((form == kRaw) != (fixmask == nullptr) || form < kRaw || form > kMasked || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ne > 0) {
    const int err = form == kRaw
                        ? element_pass_m<T, false>(packed, elnodes_t, x, fixmask, fe, ne, ntiles,
                                                   m, s)
                        : element_pass_m<T, true>(packed, elnodes_t, x, fixmask, fe, ne, ntiles,
                                                  m, s);
    if (err != 0) return err;
  }
  if (nn <= 0) return 0;
  const T sign = negate ? T(-1) : T(1);
  if (form == kRaw) return node_pass<T, kRaw>(fe, offsets, pos, x, fixmask, y, nn, ne, m, sign, s);
  if (form == kProjected)
    return node_pass<T, kProjected>(fe, offsets, pos, x, fixmask, y, nn, ne, m, sign, s);
  return node_pass<T, kMasked>(fe, offsets, pos, x, fixmask, y, nn, ne, m, sign, s);
}

}  // namespace

extern "C" int fcvm_khat_matmat_f32(const float* packed, const int* elnodes_t,
                                    const int* offsets, const int* pos, const float* x,
                                    const float* fixmask, float* fe, float* y, long long ne,
                                    long long nn, long long ntiles, int m, int form, int negate,
                                    void* stream) {
  return run<float>(packed, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, ntiles, m, form,
                    negate, stream);
}

extern "C" int fcvm_khat_matmat_f64(const double* packed, const int* elnodes_t,
                                    const int* offsets, const int* pos, const double* x,
                                    const double* fixmask, double* fe, double* y, long long ne,
                                    long long nn, long long ntiles, int m, int form, int negate,
                                    void* stream) {
  return run<double>(packed, elnodes_t, offsets, pos, x, fixmask, fe, y, ne, nn, ntiles, m, form,
                     negate, stream);
}
