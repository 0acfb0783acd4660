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
// tile zero-padded: ops/kernels.py::pack_blocks), K1's node table and
// incidence CSR (ops/assembly.py::node_incidence) and K1m's compacted
// tables (ops/kernels.py::k1m_tables), and gives, column by column, K1's
// bits (khat_matvec.cu).
//
// What bounds it: reading the packed blocks (1860 bytes an element in f32,
// 3720 in f64), then the tables, U and Y once, and the element output once
// written and once read.  Two kernels, launched by one call: an element
// pass, in one of two layouts, and a node pass.  A persistent grid; in
// both layouts one producer thread copies the packed entries of a block's
// elements in 15 stages of 31 rows, each stage a 2-D TMA request
// (cp.async.bulk.tensor) into a slot of shared memory, and a consumer
// thread keeps an element's 30 gathered values and 30 sums a column in
// registers and adds the entries in packed order (csrc/packed.cuh, K1's
// order).  The layouts:
//   collapse: the tables' unit is a sub-tile of kSub = 32 elements, whatever
//      m, so one set of tables serves every width; a thread block takes
//      kGroup consecutive sub-tiles at once (128 consumer threads where the
//      chunk has few columns, one sub-tile at 8 columns).  Each block is
//      read from HBM once, at every width: up to 8 columns (one chunk) the
//      slots form a ring; wider, the block holds its whole sub-tile (15
//      slots) and walks every chunk of 8 columns over it before it releases
//      a slot.  A thread owns one element and kPer of the chunk's columns
//      (2 in f32: each shared-memory read feeds four FMAs).  The sums go to
//      shared memory, and the block then collapses, for each node whose
//      first incidence (in K1's table order) lies in a sub-tile, that
//      node's rows of the sub-tile into one partial row, summed from 0 in
//      table order: exactly K1's running sum after those rows.  Every other
//      incidence is written as its own row, so the element output is R
//      compacted rows (R, 3, m), R 0.64 of 10 ne on the beam-column's mesh.
//      A thread collapses a row's three components at 16 bytes of columns;
//      the group's entries' tables come with cp.async a group ahead;
//   direct: K1's element pass on m columns: a thread owns one (element,
//      column), a block kEs = 512 / kCols elements in f32 (256 / kCols in
//      f64, at most a tile) and one stage is one box of kEs values, and
//      each thread writes its 30 sums straight to K1's element output
//      (30, ne, m), one row an incidence.  Wider than 8 columns a
//      block walks its elements once for each chunk of 8, the blocks read
//      again from the L2.
// layout_of picks, for each dtype and chunk width, the layout that
// tools/k1m_layout.py timed faster (PERF.md, K1m by width): collapse in
// f32 at chunks of 8 columns (m >= 5), direct in f64 (one block of 288
// threads an SM, whose collapse's barriers nothing covers) and in f32 up
// to 4 columns (a block of 128 consumers against the direct's 512).
// The node pass: one thread a (node, column) sums the node's rows, the
// compacted ones (its partial first, then its later rows in table order)
// or, after the direct layout, its incidences in table order
// (fcvm_segment::gather_sum, K8's sum, from 0, four rows in flight), then
// applies the mask, the identity on fixed dofs and the sign.  Every add of
// K1's node sum happens in the same order, so each column is K1's to the
// bit.  No atomics and a fixed order everywhere, so two calls on the same
// inputs give the same bits.  Sums accumulate in the input type, with FMA;
// nothing is lowered in precision.
//
// C interface: fcvm_khat_matmat_map_* encodes the tensor maps of a packed
// copy once (kMapBytes the caller keeps, as long as the copy lives: one map
// for each box width kSub 2^i up to a tile); fcvm_khat_matmat_rows gives
// the rows of element output a call at m columns writes (R or 10 ne);
// fcvm_khat_matmat_* launches both passes and returns cudaGetLastError()
// after them (0 = launched); form 0 raw (fixmask == nullptr), 1 projected,
// 2 masked; negate 0 or 1.  The caller owns all memory (fe, rows (3 m)
// values, is its scratch) and the stream; the kernels do not synchronise.
// csrc/ops.cpp binds them to PyTorch as torch.ops.fcvm.khat_matmat_map and
// torch.ops.fcvm.khat_matmat.  csrc/khat_matmat_probe.cu runs each layout
// at every width for tools/k1m_layout.py.

#include <cstdint>
#include <cstring>
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
constexpr int kSub = 32;         // elements a sub-tile of the tables: ops/kernels.py K1M_SUB
constexpr int kNodeThreads = 256;
constexpr int kMaxCols = 8;      // columns a chunk
constexpr int kBlockThreads = 128;     // collapse: consumers a block, where the columns leave a choice
constexpr int kRingBytes = 48 * 1024;  // collapse: the ring (one chunk)
constexpr int kDirectRingBytes = 3 * kRows * 1024;  // direct: K1's ring, 3 slots of 31 KB
constexpr int kMaps = 4;         // tensor maps of a packed copy: boxes of kSub 2^i values
constexpr int kMapBytes = kMaps * 128;

enum Form { kRaw = 0, kProjected = 1, kMasked = 2 };
// The element pass's layouts; kChosen: layout_of's for the width.
enum Layout { kCollapse = 0, kDirect = 1, kChosen = 2 };

// The layout K1m takes at kCols columns a chunk: the faster one in
// tools/k1m_layout.py's timings (PERF.md, K1m by width).
template <typename T, int kCols>
constexpr int layout_of() {
  return sizeof(T) == 4 && kCols == kMaxCols ? kCollapse : kDirect;
}

// The collapse layout for elements of T at kCols columns a chunk, kWide for
// several chunks (the block then holds its whole sub-tile).
template <typename T, int kCols, bool kWide>
struct Collapse {
  static constexpr int kTile = 1024 / static_cast<int>(sizeof(T));  // pack_blocks' E
  // columns a thread: 2 in f32 (f64's 60 values a column fill the registers)
  static constexpr int kPer = sizeof(T) == 4 && kCols >= 2 ? 2 : 1;
  static constexpr int kLanes = kCols / kPer;  // threads an element
  // sub-tiles a block takes at once: enough for kBlockThreads consumers (at
  // most a tile), one where the block holds a whole sub-tile
  static constexpr int kWant = kBlockThreads / (kSub * kLanes);
  static constexpr int kGroup =
      kWide || kWant < 1 ? 1 : kWant < kTile / kSub ? kWant : kTile / kSub;
  static constexpr int kEs = kSub * kGroup;
  static constexpr int kConsumers = kEs * kLanes;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kStageBytes = kRows * kEs * static_cast<int>(sizeof(T));
  // a ring of kRingBytes (2 to 8 slots) for one chunk, the whole sub-tile for several
  static constexpr int kRing = kRingBytes / kStageBytes;
  static constexpr int kSlots = kWide ? kStages : kRing < 2 ? 2 : kRing > 8 ? 8 : kRing;
  // two buffers of sums on a ring, one beside a whole sub-tile (it fills the shared memory)
  static constexpr int kBufs = kWide ? 1 : 2;
  static constexpr int kOutVals = kDofs * kEs * kCols;  // a buffer of sums
  // the ring, then the sums; + the slack to align the ring
  static constexpr int kSmem =
      kSlots * kStageBytes + kBufs * kOutVals * static_cast<int>(sizeof(T)) + 128;
  // the blocks an SM the registers must allow: 2 at 160 threads (ptxas then
  // takes 168 registers; left alone it takes up to 255 and one block fills the SM)
  static constexpr int kMinBlocks = kThreads <= 160 ? 2 : 1;
  static_assert(kTile % kEs == 0 && kConsumers % 32 == 0 && kCols % kPer == 0,
                "whole sub-tiles and warps");
  static_assert(kStageBytes % 128 == 0, "a slot 128-byte aligned");
};

// The direct layout for elements of T at kCols columns a chunk.
template <typename T, int kCols>
struct Direct {
  static constexpr int kTile = 1024 / static_cast<int>(sizeof(T));
  static constexpr int kThreadsMax = sizeof(T) == 4 ? 512 : 256;  // consumers
  static constexpr int kEs = kThreadsMax / kCols < kTile ? kThreadsMax / kCols : kTile;
  static constexpr int kConsumers = kEs * kCols;
  static constexpr int kThreads = kConsumers + 32;
  static constexpr int kStageBytes = kRows * kEs * static_cast<int>(sizeof(T));
  static constexpr int kSlots = kDirectRingBytes / kStageBytes;
  static constexpr int kSmem = kSlots * kStageBytes + 128;  // + the slack to align the ring
  static constexpr int kMap = kEs / (2 * kSub) < 1 ? 0 : kEs / (4 * kSub) < 1 ? 1
                              : kEs / (8 * kSub) < 1 ? 2 : 3;  // the map of boxes kEs wide
  static_assert((kSub << kMap) == kEs && kMap < kMaps, "a map's box is the block's elements");
  static_assert(kTile % kEs == 0 && kConsumers % 32 == 0, "whole sub-tiles and warps");
  static_assert(kStageBytes % 128 == 0, "a slot 128-byte aligned");
};

// s[c] += src[c], c < kN: kN values of shared memory, 16-byte loads where
// kN fills them (src aligned to kN values).
template <typename T, int kN>
__device__ __forceinline__ void add_cols(T (&s)[kN], const T* src) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if constexpr (kN % kVec == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int v = 0; v < kN / kVec; ++v) {
      const float4 q = reinterpret_cast<const float4*>(src)[v];
      s[4 * v] += q.x;
      s[4 * v + 1] += q.y;
      s[4 * v + 2] += q.z;
      s[4 * v + 3] += q.w;
    }
  } else if constexpr (kN % kVec == 0) {
#pragma unroll
    for (int v = 0; v < kN / kVec; ++v) {
      const double2 q = reinterpret_cast<const double2*>(src)[v];
      s[2 * v] += q.x;
      s[2 * v + 1] += q.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kN; ++c) s[c] += src[c];
  }
}

// dst[c] = s[c], c < n: 16-byte stores where every chunk is whole
// (`whole`: dst then aligned to kN values), else one value at a time.
template <typename T, int kN>
__device__ __forceinline__ void store_cols(T* dst, const T (&s)[kN], int n, bool whole) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if constexpr (kN % kVec == 0) {
    if (whole) {
#pragma unroll
      for (int v = 0; v < kN / kVec; ++v) {
        if constexpr (sizeof(T) == 4)
          reinterpret_cast<float4*>(dst)[v] =
              make_float4(s[4 * v], s[4 * v + 1], s[4 * v + 2], s[4 * v + 3]);
        else
          reinterpret_cast<double2*>(dst)[v] = make_double2(s[2 * v], s[2 * v + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    if (c < n) dst[c] = s[c];
  }
}

// bar.sync among the consumer warps only (the producer warp has returned).
template <int kThreads>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// The collapse layout's element pass.  Thread t < kConsumers: element t /
// kLanes of the block's kEs, columns kPer (t % kLanes) .. + kPer - 1 of each
// chunk; one producer warp.  Block b takes groups of kGroup sub-tiles b, b +
// gridDim.x, ..., each for every chunk of columns in turn (a turn).  The
// group's entries are its incidences, row by row: ents[i] (10 el + slot in
// the entry's sub-tile) and ent_rows[i], its compacted row, for i in 10 kEs
// g .. ; the consumers copy the next group's with cp.async while they sum
// this one, then make a row index (srow) and each entry's place among the
// sums (sent) in shared memory.  A turn's sums go to a buffer of shared
// memory, and after one barrier each thread collapses a row at 16 bytes of
// columns: its three components, summed from 0 in its entries' order.  With
// two buffers of sums (the ring) the consumers meet once a turn and once a
// group; with one (the whole sub-tile) once more a turn.
template <typename T, int kCols, bool kWide, bool kMaskIn>
__global__ void __launch_bounds__(Collapse<T, kCols, kWide>::kThreads,
                                  Collapse<T, kCols, kWide>::kMinBlocks)
collapse_kernel(const __grid_constant__ CUtensorMap packed, const int* __restrict__ elnodes_t,
                const T* __restrict__ x, const T* __restrict__ fixmask,
                const int* __restrict__ ents, const int* __restrict__ ent_rows,
                T* __restrict__ fe, long long ne, int m, int nchunks) {
  using S = Collapse<T, kCols, kWide>;
  constexpr int kEs = S::kEs, kLanes = S::kLanes, kConsumers = S::kConsumers;
  constexpr int kPer = S::kPer, kSlots = S::kSlots, kGroup = S::kGroup;
  constexpr int kEnts = kNodes * kEs;  // a group's entries
  constexpr int kPlane = kEs * kCols;  // one dof's sums in a buffer
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots];
  __shared__ __align__(16) int raw_q[2][kEnts], raw_r[2][kEnts];  // a group's ents, ent_rows
  __shared__ short srow[kEnts + 1], sent[kEnts];  // each row's first entry, each entry's place
  // a tensor copy lands at a 128-byte aligned address (kSmem holds the slack)
  T* const ring =
      reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(smem) + 127) & ~uintptr_t{127});
  T* const outs = ring + kSlots * kRows * kEs;  // kBufs (30, kEs, kCols): dof, element, column
  const long long ngroups = (ne + kEs - 1) / kEs;
  const long long my_groups =
      ngroups > blockIdx.x ? (ngroups - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      fcvm_bulk::mbar_init(full + s, 1);
      fcvm_bulk::mbar_init(empty + s, kConsumers / 32);
    }
    fcvm_bulk::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == kConsumers) {
      const uint64_t policy = fcvm_bulk::evict_first_policy();  // each block read once
      long long k = 0;
      for (long long n = 0; n < my_groups; ++n) {
        const long long g = blockIdx.x + n * gridDim.x;
        const int x0 = static_cast<int>(g % (S::kTile / kEs)) * kEs;
        const int y0 = static_cast<int>(g / (S::kTile / kEs)) * kPacked;
        for (int st = 0; st < kStages; ++st, ++k) {
          const int slot = static_cast<int>(k % kSlots);
          if (k >= kSlots) {
            fcvm_bulk::mbar_wait(empty + slot, static_cast<uint32_t>((k / kSlots - 1) & 1));
            fcvm_bulk::fence_proxy_async();  // the consumers' reads before the refill
          }
          // a box (31 rows of kSub values) a sub-tile, one after the other
          fcvm_bulk::mbar_expect_tx(full + slot, S::kStageBytes);
          for (int j = 0; j < kGroup; ++j)
            fcvm_bulk::tensor_copy_2d_g2s_hint(ring + (slot * kGroup + j) * kRows * kSub,
                                               &packed, x0 + j * kSub, y0 + st * kRows,
                                               full + slot, policy);
        }
      }
    }
    return;
  }

  const auto group_ents = [&](long long g) {
    return static_cast<int>(kNodes * (ne - g * kEs < kEs ? ne - g * kEs : kEs));
  };
  const auto prefetch = [&](long long n) {  // group n's tables into raw_*[n & 1]
    const long long g = blockIdx.x + n * gridDim.x;
    const int nents = group_ents(g);
    const long long ebeg = static_cast<long long>(kEnts) * g;
    for (int i = threadIdx.x; i < nents; i += kConsumers) {
      fcvm_ring::cp_async<4>(&raw_q[n & 1][i], ents + ebeg + i, true);
      fcvm_ring::cp_async<4>(&raw_r[n & 1][i], ent_rows + ebeg + i, true);
    }
    fcvm_ring::cp_async_commit();
  };
  const fcvm_packed::Ring bars{full, empty};
  const int lane = threadIdx.x % kLanes, el = threadIdx.x / kLanes;
  const int at = el / kSub * kRows * kSub + el % kSub;  // the element in its sub-tile's box
  const bool whole = m % kCols == 0;  // every chunk whole: the rows' stores aligned
  if (my_groups > 0) prefetch(0);
  int turn = 0;  // the chunks so far: which buffer of sums
  for (long long n = 0; n < my_groups; ++n) {
    const long long g = blockIdx.x + n * gridDim.x;
    const long long e = g * kEs + el;
    const int nents = group_ents(g);
    fcvm_ring::cp_async_wait<0>();
    consumers_sync<kConsumers>();  // the group's tables landed, the last group's rows read
    {
      const int* const q = raw_q[n & 1];
      const int* const rr = raw_r[n & 1];
      for (int i = threadIdx.x; i < nents; i += kConsumers) {
        sent[i] = static_cast<short>(
            (3 * (q[i] % 10) * kEs + i / (10 * kSub) * kSub + q[i] / 10) * kCols);
        if (i == 0 || rr[i] != rr[i - 1]) srow[rr[i] - rr[0]] = static_cast<short>(i);
      }
      if (threadIdx.x == 0) srow[rr[nents - 1] - rr[0] + 1] = static_cast<short>(nents);
    }
    if (n + 1 < my_groups) prefetch(n + 1);
    for (int ch = 0; ch < nchunks; ++ch, ++turn) {
      const int col0 = ch * kCols + lane * kPer;
      T u[kPer][kDofs], y[kPer][kDofs];
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
#pragma unroll
        for (int i = 0; i < kDofs; ++i) u[c][i] = y[c][i] = T(0);
      }
      if (e < ne) {
#pragma unroll
        for (int nd = 0; nd < kNodes; ++nd) {
          const long long d = 3LL * elnodes_t[nd * ne + e];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int c = 0; c < kPer; ++c) {
              if (col0 + c < m) {
                const T v = x[(d + a) * m + col0 + c];
                u[c][3 * nd + a] = kMaskIn ? fixmask[d + a] * v : v;
              }
            }
          }
        }
      }
      fcvm_packed::block_sum_cols<kSub, kRows * kEs, kSlots, kPer>(
          ring, bars, n * kStages, at, y, u, ch == nchunks - 1,
          std::make_integer_sequence<int, kStages>{});
      // the group's first row and row count, read again here (raw_r[n & 1]
      // is refilled after the next group's barrier), so they are not live
      // across the sums
      const int rbeg = raw_r[n & 1][0], nrows = raw_r[n & 1][group_ents(g) - 1] - rbeg + 1;
      T* const out = outs + (S::kBufs == 2 ? turn & 1 : 0) * S::kOutVals;
#pragma unroll
      for (int i = 0; i < kDofs; ++i) {
#pragma unroll
        for (int c = 0; c < kPer; ++c) out[(i * kEs + el) * kCols + lane * kPer + c] = y[c][i];
      }
      consumers_sync<kConsumers>();  // the turn's sums written
      // an item: a row's three components at kCpi columns (16 bytes)
      constexpr int kCpi = 16 / static_cast<int>(sizeof(T)) < kCols
                               ? 16 / static_cast<int>(sizeof(T)) : kCols;
      constexpr int kItems = kCols / kCpi;  // items a row
      for (int it = threadIdx.x; it < nrows * kItems; it += kConsumers) {
        const int r = it / kItems, c0 = it % kItems * kCpi;
        const int ncols = m - ch * kCols - c0;
        if (ncols <= 0) continue;
        T s[3][kCpi];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int c = 0; c < kCpi; ++c) s[a][c] = T(0);
        }
        for (int p = srow[r], end = srow[r + 1]; p < end; ++p) {
          const T* o = out + sent[p] + c0;
#pragma unroll
          for (int a = 0; a < 3; ++a) add_cols(s[a], o + a * kPlane);
        }
        T* f = fe + 3LL * (rbeg + r) * m + ch * kCols + c0;
#pragma unroll
        for (int a = 0; a < 3; ++a) store_cols(f + a * m, s[a], ncols, whole);
      }
      if constexpr (S::kBufs == 1) consumers_sync<kConsumers>();  // the buffer's reads done
    }
  }
}

// The direct layout's element pass: Direct::kConsumers consumer threads,
// thread t on element t / kCols of the block's kEs and column t % kCols of
// the chunk, and one producer warp.  Block b takes blocks of elements b, b
// + gridDim.x, ..., each for every chunk of columns in turn; thread t
// writes its element's 30 sums to fe (30, ne, m).
template <typename T, int kCols, bool kMaskIn>
__global__ void __launch_bounds__(Direct<T, kCols>::kThreads)
direct_kernel(const __grid_constant__ CUtensorMap packed, const int* __restrict__ elnodes_t,
              const T* __restrict__ x, const T* __restrict__ fixmask, T* __restrict__ fe,
              long long ne, int m, int nchunks) {
  using S = Direct<T, kCols>;
  constexpr int kEs = S::kEs, kSlots = S::kSlots;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots];
  T* const ring =
      reinterpret_cast<T*>((reinterpret_cast<uintptr_t>(smem) + 127) & ~uintptr_t{127});
  const long long ngroups = (ne + kEs - 1) / kEs;
  const long long my_items =
      (ngroups > blockIdx.x ? (ngroups - blockIdx.x + gridDim.x - 1) / gridDim.x : 0) * nchunks;
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
        const long long g = blockIdx.x + (n / nchunks) * gridDim.x;
        const int x0 = static_cast<int>(g % (S::kTile / kEs)) * kEs;
        const int y0 = static_cast<int>(g / (S::kTile / kEs)) * kPacked;
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
    const long long e = (blockIdx.x + (n / nchunks) * gridDim.x) * kEs + el;
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

// One thread a (node, column): y[3n + a, col] = the sum over the node's rows
// p (rows[offsets[n]] ..) of fe[p row_stride + a col_stride + col], masked
// and signed.
template <typename T, int kForm>
__global__ void __launch_bounds__(kNodeThreads)
node_kernel(const T* __restrict__ fe, const int* __restrict__ offsets,
            const int* __restrict__ rows, const T* __restrict__ x,
            const T* __restrict__ fixmask, T* __restrict__ y, long long nn, int m,
            long long row_stride, long long col_stride, T sign) {
  const long long t = static_cast<long long>(blockIdx.x) * kNodeThreads + threadIdx.x;
  if (t >= nn * m) return;
  const long long n = t / m;
  const int col = static_cast<int>(t % m);
  T s[3] = {T(0), T(0), T(0)};
  fcvm_segment::gather_sum<T, 3, 4>(s, fe + col, rows, offsets[n], offsets[n + 1], row_stride,
                                    col_stride);
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

// The packed copy (ntiles 465 rows of kTile values) as 2-D tensors whose
// boxes are 31 rows of kSub 2^i values, i < kMaps (those wider than a tile
// left zero): map i serves the collapse layout's sub-tiles (i = 0) and the
// direct layout's blocks of kSub 2^i elements.
template <typename T>
int packed_maps(const T* packed, long long ntiles, CUtensorMap* maps) {
  constexpr int kTile = 1024 / static_cast<int>(sizeof(T));
  if (ntiles * kPacked > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  std::memset(static_cast<void*>(maps), 0, kMapBytes);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kTile),
                              static_cast<cuuint64_t>(ntiles) * kPacked};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kTile) * sizeof(T)};
  const cuuint32_t unit[2] = {1, 1};
  for (int i = 0; i < kMaps && (kSub << i) <= kTile; ++i) {
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSub << i),
                               static_cast<cuuint32_t>(kRows)};
    const CUresult res = encode(
        maps + i, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
        2, const_cast<T*>(packed), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// K1m's tables as the kernels read them (ops/kernels.py::NodeIncidence and
// K1mTables).
struct Tables {
  const int* elnodes_t;     // (10, ne)
  const int* offsets;       // (nn + 1): each node's first incidence of pos (K1's)
  const int* pos;           // (10 ne): each incidence's row 3 slot ne + e of (30, ne) (K1's)
  const int* ents;          // (10 ne): each row's incidences, 10 el + slot in their sub-tile
  const int* ent_rows;      // (10 ne): each entry's compacted row
  const int* node_offsets;  // (nn + 1): each node's first entry of node_rows
  const int* node_rows;     // (R): each node's rows, partial first, then table order
};

template <typename T, int kCols, bool kWide, bool kMaskIn>
int collapse_pass(const CUtensorMap* maps, const Tables& tab, const T* x, const T* fixmask,
                  T* fe, long long ne, int m, cudaStream_t stream) {
  using S = Collapse<T, kCols, kWide>;
  const auto kernel = collapse_kernel<T, kCols, kWide, kMaskIn>;
  static int resident[fcvm_ring::kMaxDevices];
  int grid = 0;
  const int err = fcvm_ring::persistent_grid(kernel, S::kThreads, S::kSmem,
                                             (ne + S::kEs - 1) / S::kEs, resident, &grid);
  if (err != 0) return err;
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(maps[0], tab.elnodes_t, x, fixmask, tab.ents,
                                                  tab.ent_rows, fe, ne, m,
                                                  (m + kCols - 1) / kCols);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kCols, bool kMaskIn>
int direct_pass(const CUtensorMap* maps, const Tables& tab, const T* x, const T* fixmask, T* fe,
                long long ne, int m, cudaStream_t stream) {
  using S = Direct<T, kCols>;
  const auto kernel = direct_kernel<T, kCols, kMaskIn>;
  static int resident[fcvm_ring::kMaxDevices];
  int grid = 0;
  const int err = fcvm_ring::persistent_grid(kernel, S::kThreads, S::kSmem,
                                             (ne + S::kEs - 1) / S::kEs, resident, &grid);
  if (err != 0) return err;
  kernel<<<grid, S::kThreads, S::kSmem, stream>>>(maps[S::kMap], tab.elnodes_t, x, fixmask, fe,
                                                  ne, m, (m + kCols - 1) / kCols);
  return static_cast<int>(cudaGetLastError());
}

// The element pass in layout kL (kChosen: layout_of's) at kCols columns a
// chunk, kWide for several chunks.
template <int kL, typename T, int kCols, bool kWide, bool kMaskIn>
int layout_pass(const CUtensorMap* maps, const Tables& tab, const T* x, const T* fixmask, T* fe,
                long long ne, int m, cudaStream_t stream) {
  if constexpr ((kL == kChosen ? layout_of<T, kCols>() : kL) == kDirect)
    return direct_pass<T, kCols, kMaskIn>(maps, tab, x, fixmask, fe, ne, m, stream);
  else
    return collapse_pass<T, kCols, kWide, kMaskIn>(maps, tab, x, fixmask, fe, ne, m, stream);
}

// The chunk's columns at m: the least power of two >= m up to kMaxCols.
constexpr int chunk_cols(int m) { return m == 1 ? 1 : m == 2 ? 2 : m <= 4 ? 4 : kMaxCols; }

// The layout a call at m columns takes in layout kL.
template <typename T>
int layout_at(int kL, int m) {
  if (kL != kChosen) return kL;
  switch (chunk_cols(m)) {
    case 1: return layout_of<T, 1>();
    case 2: return layout_of<T, 2>();
    case 4: return layout_of<T, 4>();
    default: return layout_of<T, kMaxCols>();
  }
}

template <int kL, typename T, bool kMaskIn>
int element_pass(const CUtensorMap* maps, const Tables& tab, const T* x, const T* fixmask, T* fe,
                 long long ne, int m, cudaStream_t stream) {
  switch (chunk_cols(m)) {
    case 1: return layout_pass<kL, T, 1, false, kMaskIn>(maps, tab, x, fixmask, fe, ne, m, stream);
    case 2: return layout_pass<kL, T, 2, false, kMaskIn>(maps, tab, x, fixmask, fe, ne, m, stream);
    case 4: return layout_pass<kL, T, 4, false, kMaskIn>(maps, tab, x, fixmask, fe, ne, m, stream);
    default:
      if (m <= kMaxCols)
        return layout_pass<kL, T, kMaxCols, false, kMaskIn>(maps, tab, x, fixmask, fe, ne, m,
                                                            stream);
      return layout_pass<kL, T, kMaxCols, true, kMaskIn>(maps, tab, x, fixmask, fe, ne, m,
                                                         stream);
  }
}

// The rows of element output layout kL writes at m columns: R compacted
// rows or K1's 10 ne.
template <typename T>
long long fe_rows(int kL, int m, long long ne, long long rows) {
  return layout_at<T>(kL, m) == kDirect ? 10 * ne : rows;
}

template <typename T, int kForm>
int node_pass(const T* fe, const int* offsets, const int* rows, const T* x, const T* fixmask,
              T* y, long long nn, int m, long long row_stride, long long col_stride, T sign,
              cudaStream_t stream) {
  const long long blocks = (nn * m + kNodeThreads - 1) / kNodeThreads;
  node_kernel<T, kForm><<<static_cast<unsigned>(blocks), kNodeThreads, 0, stream>>>(
      fe, offsets, rows, x, fixmask, y, nn, m, row_stride, col_stride, sign);
  return static_cast<int>(cudaGetLastError());
}

template <int kL, typename T>
int run(const void* map_bytes, const Tables& tab, const T* x, const T* fixmask, T* fe, T* y,
        long long ne, long long nn, int m, int form, int negate, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if ((form == kRaw) != (fixmask == nullptr) || form < kRaw || form > kMasked || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ne > 0) {
    CUtensorMap maps[kMaps];
    std::memcpy(static_cast<void*>(maps), map_bytes, kMapBytes);
    const int err = form == kRaw
                        ? element_pass<kL, T, false>(maps, tab, x, fixmask, fe, ne, m, s)
                        : element_pass<kL, T, true>(maps, tab, x, fixmask, fe, ne, m, s);
    if (err != 0) return err;
  }
  if (nn <= 0) return 0;
  const T sign = negate ? T(-1) : T(1);
  // the direct layout's rows are K1's (30, ne, m), the collapse's (R, 3, m)
  const bool direct = layout_at<T>(kL, m) == kDirect;
  const int* offsets = direct ? tab.offsets : tab.node_offsets;
  const int* rows = direct ? tab.pos : tab.node_rows;
  const long long row_stride = direct ? m : 3LL * m, col_stride = direct ? ne * m : m;
  if (form == kRaw)
    return node_pass<T, kRaw>(fe, offsets, rows, x, fixmask, y, nn, m, row_stride, col_stride,
                              sign, s);
  if (form == kProjected)
    return node_pass<T, kProjected>(fe, offsets, rows, x, fixmask, y, nn, m, row_stride,
                                    col_stride, sign, s);
  return node_pass<T, kMasked>(fe, offsets, rows, x, fixmask, y, nn, m, row_stride, col_stride,
                               sign, s);
}

}  // namespace

extern "C" int fcvm_khat_matmat_map_bytes() {
  static_assert(sizeof(CUtensorMap) == 128, "a tensor map is 128 bytes");
  return kMapBytes;
}

extern "C" int fcvm_khat_matmat_map_f32(const float* packed, long long ntiles, void* maps) {
  return packed_maps<float>(packed, ntiles, static_cast<CUtensorMap*>(maps));
}

extern "C" int fcvm_khat_matmat_map_f64(const double* packed, long long ntiles, void* maps) {
  return packed_maps<double>(packed, ntiles, static_cast<CUtensorMap*>(maps));
}

extern "C" long long fcvm_khat_matmat_rows(int itemsize, int m, long long ne, long long rows) {
  return itemsize == 4 ? fe_rows<float>(kChosen, m, ne, rows)
                       : fe_rows<double>(kChosen, m, ne, rows);
}

extern "C" int fcvm_khat_matmat_f32(const void* maps, const int* elnodes_t, const int* offsets,
                                    const int* pos, const int* ents, const int* ent_rows,
                                    const int* node_offsets, const int* node_rows,
                                    const float* x, const float* fixmask, float* fe, float* y,
                                    long long ne, long long nn, int m, int form, int negate,
                                    void* stream) {
  const Tables tab{elnodes_t, offsets, pos, ents, ent_rows, node_offsets, node_rows};
  return run<kChosen, float>(maps, tab, x, fixmask, fe, y, ne, nn, m, form, negate, stream);
}

extern "C" int fcvm_khat_matmat_f64(const void* maps, const int* elnodes_t, const int* offsets,
                                    const int* pos, const int* ents, const int* ent_rows,
                                    const int* node_offsets, const int* node_rows,
                                    const double* x, const double* fixmask, double* fe,
                                    double* y, long long ne, long long nn, int m, int form,
                                    int negate, void* stream) {
  const Tables tab{elnodes_t, offsets, pos, ents, ent_rows, node_offsets, node_rows};
  return run<kChosen, double>(maps, tab, x, fixmask, fe, y, ne, nn, m, form, negate, stream);
}
