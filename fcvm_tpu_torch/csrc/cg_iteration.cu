// K6: the vector work of one CG iteration, with the loop's convergence test,
// for Hopper (sm_90a).
//
// Replaces the XLA-lowered body and cond of the lax.while_loop of
// fcvm_tpu/ops/solver.py::pcg and ::pcg_harvest (the chain at
// solver.py:107-122 and :175-197 around the matvec and the preconditioner
// apply: p.ap, the step length and its pap == 0 guard, the x and r updates,
// r.z, the direction update and its rz == 0 guard, ||r||, the stall
// bookkeeping and the harvest's slots), so the test `rnorm > tol, k <
// maxiter, not stalled` stays on the card as it does in the JAX package;
// with the Ritz deflation correction z = z4 + W (K_w^+ (W^T r)) of
// fcvm_tpu/ops/deflation.py::deflated (:74-92) folded into its passes.  Its
// block form (m <= 64 columns, one state each, no harvest; deflated by up to
// 64 vectors) replaces the same body, deflated, under the vmap of
// fcvm_tpu/runtime/buckling.py::_kinv (:552-567), whose columns freeze, not
// drop, once done.  The two deflation forms stay apart, chosen by b's shape:
// a vector keeps its own (one grid barrier a pass, the harvest's layout),
// since the block form at one column, with its second barrier, is slower on
// the plate's space (PERF.md, K6's row).
//
// The solve's scalars live in a float64 state row a column (the slots
// below, ops/kernels.py CG_SLOTS), read and written only by the passes, so
// no iteration needs the host: the caller queues iterations and reads the
// flags once per batch.  Two passes an iteration, each a cooperative launch
// of a grid that is resident by construction (as many blocks an SM as the
// occupancy of both passes allows, at most kMaxBlocksPerSm; a grid that
// cannot be co-resident is refused at launch), with one grid barrier inside:
//   update, between K1 (ap = K_hat p) and K4 (z4 = M r): p.ap partials; the
//     barrier; every block sums all the partials in one fixed order, so every
//     block holds alpha with the same bits; r -= alpha ap on the ap values the
//     thread still holds in registers, ||r||^2 partials and (deflated) W^T r
//     partials.  Block 0 writes run = next and alpha.
//   direction, after K4: every block sums the update's partials in the same
//     fixed order: ||r||, k, best, since and `next` (the cond of the next
//     iteration decided from this r: tolerance, stall and gate compared in
//     float64) and c = K_w^+ (W^T r) (kd x kd, on chip); z = z4 + W c in
//     registers; r.z partials; the barrier; beta; x += alpha p (x takes the
//     step where the old p is read anyway) and p = z + beta p on the z values
//     the thread holds; in a harvesting solve z into slot min(k, cap) of the
//     harvest and rz, alpha and beta beside it.  Every block reads the state
//     before the barrier and block 0 writes it after it.
// z is never written back; only a harvest stores it.  A pass writes nothing
// of a column whose `run` is 0, so a converged solve stays frozen bit for
// bit while the queued iterations pass; a pass with no running column
// returns at once.  The start of a solve runs both passes in their start
// form: the update takes the partials of r0 alone; the direction ||r0||, the
// tolerance and gate from ||b||, rz0, p0 = z0 and slot 0 of the harvest.
//
// The walk: the grid is persistent; thread t of block b takes items b U + t,
// (G + b) U + t, ... (G blocks, U threads that take items) of the row-major
// (n, m) values.  An item is 16 bytes (float4 or double2: kVec consecutive
// values, a thread's columns of a row contiguous) where every vector's base
// is aligned, else one value; U kVec is a multiple of m, so a thread's lanes
// keep their columns from item to item and their partials stay in
// registers.  The ragged tail is loaded and stored value by value.  Each
// pass has two layouts of its registers, picked at launch: where the grid
// covers the items in 4 sweeps (the plate's vectors), a thread holds its 4
// items across the barrier (ap in the update, z in the direction) and loads
// before it the operands the far side needs of its first 2 (r; p and x),
// so their reads overlap the partial sums; with more items (the
// eigensolve's blocks), it holds its first 8 in float32 and 4 in float64,
// and reads the rest again after the barrier (z: again plus W c).

// Deflation layout: W is (n, kd) with kd a multiple of 4 (the plan pads the
// basis with zero columns).  W^T r: a chunk's r in shared memory; thread t
// loads 16 bytes of a row (four columns, 4 (t % G)) and keeps four column
// partials in registers over all its rows, folded into the block's tree
// once.  W c: a thread multiplies its four columns by c, held in registers,
// and the G threads of a row add their parts with a fixed xor tree (three
// shuffles at kd = 32).
//
// The deflated block (kd <= 64, any m, an (n, m) solve even at m = 1).
// W reaches both passes through a ring (WRing): 32 KB stages of dynamic
// shared memory, each a bulk copy of a tile of W's rows (a chunk's, cut to
// 32 KB), the first issued as the pass starts and each stage refilled as
// soon as the block is done with it, so W's bytes stream while the partials
// are summed, the barriers wait and the arithmetic runs.  The direction
// pass loads each chunk's z and r a chunk ahead: the block waits for every
// tile, so loads issued only when their chunk comes would stall it.
//   W^T R rides the update pass: a chunk's R in shared memory; thread (g,
//     cc, rs) takes four columns 4g of every S-th row of the tile (one read
//     of W for all the block's columns) and keeps the partials of those four
//     columns against BlockCols columns cc BlockCols of R in registers (32
//     values in float32, 16 in float64) over all its rows; at the end the
//     slices' tree over rows_tree, a column of R at a time, and one partial
//     (m x kd) a block.  A second grid barrier; then block c (and c + grid,
//     ...) sums column c's partials over the grid in sum_cols's fixed order
//     and writes C[:, c] = K_w^+ S[:, c], so the grid's partials are read
//     once, not once a block (the vector form's way: 264 x 264 x 512 values
//     an iteration at m = 8, kd = 64).
//   W C rides the direction pass: every block loads C (kd x m, in shared
//     memory transposed, a column's kd values contiguous) and a thread adds
//     to each lane of its item z4 + sum_i W[row, i] C[i, col] from the tile
//     (the groups of four i in a fixed order that starts at the row's, so
//     the rows of a warp read different banks), the lanes of one row
//     sharing the loads of W; z of items past those held across the barrier
//     goes to a scratch copy and is read back after it, so W is read once a
//     pass.
//
// Sums: a thread's items in order, then the block's pairwise tree over its
// threads (one column: the last five levels by shuffles) or over a step's
// rows (several), one partial a block; after the barrier each block adds the grid's partials,
// each of its threads a fixed set of blocks in order, then a tree.  No float atomics: two runs give the same bits.  The element
// updates round as the plain version's separate product and sum (no
// contraction to an FMA), so x, r and p are its bits given the same
// scalars.  The sums and the state's step lengths stay in the working
// dtype; the state stores them in float64, exactly.
//
// What bounds it: bytes.  An iteration reads and writes 10 vectors of n
// values (p, ap, r, r; r, z, p, x, x, p): 20.1 MB in float32 on the
// 502,599-dof plate, 6.0 us at 3.35 TB/s; deflated it also reads W (n, 32)
// twice, 148.8 MB, 44.4 us (the floor: W^T r needs the new r and W c must
// reach z before r.z); a harvest writes z once more; a block of m columns
// moves 10 m, deflated W (n, kd) twice besides: at the beam-column's
// 451,875 rows, m = 8 and kd = 64, 376 MB in float32, 0.112 ms.  What it
// cannot hide: two grid barriers an iteration, each
// followed by every block reading the grid's partials (latency, not bytes:
// on an H100 a pass on the plate takes ~5 us more than its bytes), and the
// launches around K1 and K4.

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk.cuh"

namespace {

// the state's slots (float64 each), a row of kSlots a column
constexpr int kRz = 0, kAlpha = 1, kBeta = 2, kK = 3, kRnorm = 4, kBest = 5, kSince = 6,
              kRun = 7, kNext = 8, kTol = 9, kGate = 10, kStallLim = 11, kMaxIter = 12,
              kBnorm = 13, kRtol = 14, kAtol = 15, kSlots = 16;

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerSm = 4;  // more blocks only lengthen the partials' sums
constexpr int kMaxCols = 64;        // columns of a block solve
constexpr int kMaxDefl = 32;        // deflation vectors of a vector solve
constexpr int kMaxDeflBlock = 64;   // deflation vectors of a block solve
// The two layouts of a pass's registers (a sweep: the grid's threads once
// over the items): up to kFewHeld sweeps, kFewHeld items held across the
// barrier and the later operands (r; p, x) of kFewPre of them loaded before
// it; more, Many<T>::held held and nothing loaded early.
constexpr int kFewHeld = 4, kFewPre = 2;
template <typename T>
struct Many {  // 8 items held in float32, 4 in float64 (the registers' budget)
  static constexpr int held = sizeof(T) == 4 ? 8 : 4;
};
// the deflated block's W^T R: the columns of R a thread keeps partials of
// (with four columns of W: 32 values in float32, 16 in float64)
template <typename T>
struct BlockCols {
  static constexpr int n = sizeof(T) == 4 ? 8 : 4;
};
constexpr unsigned kFull = 0xffffffffu;

// 16 bytes of T
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int n = 2;
};

__device__ inline void unpack(float (&v)[4], float4 u) {
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ inline void unpack(double (&v)[2], double2 u) {
  v[0] = u.x;
  v[1] = u.y;
}
__device__ inline float4 pack(const float (&v)[4]) { return make_float4(v[0], v[1], v[2], v[3]); }
__device__ inline double2 pack(const double (&v)[2]) { return make_double2(v[0], v[1]); }
// a thread's lanes of a vector item, added in a fixed tree
__device__ inline float fold(const float (&a)[4]) { return (a[0] + a[1]) + (a[2] + a[3]); }
__device__ inline double fold(const double (&a)[2]) { return a[0] + a[1]; }

// products and sums rounded alone (no FMA contraction): the plain version's
__device__ inline float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ inline float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ inline double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ inline float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ inline double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ inline float sqrt_of(float a) { return sqrtf(a); }
__device__ inline double sqrt_of(double a) { return sqrt(a); }

// The scratch, in values of T: the p.ap and r.z partials (grid x m) at 0,
// the ||r||^2 partials (grid x m) at y, the W^T r partials (kd a block; a
// deflated block's m kd, column by column) at w, c (kd x m) at c, and for a
// deflated block z of the items not held across the direction pass's
// barrier ((n, m)) at z; each region starts on a multiple of 4 values.
struct Layout {
  long long y, w, c, z, size;
};

__host__ __device__ inline long long round4(long long v) { return (v + 3) / 4 * 4; }

__host__ __device__ inline Layout layout_of(int grid, int m, int kd, long long n, bool block) {
  Layout l;
  l.y = round4(static_cast<long long>(grid) * m);
  l.w = l.y + round4(static_cast<long long>(grid) * m);
  l.c = l.w + round4(static_cast<long long>(grid) * kd * m);
  l.z = l.c + round4(static_cast<long long>(kd) * m);
  l.size = l.z + (block && kd ? round4(n * m) : 0);
  return l;
}

// A pass's walk over the values of an (n, m) block (m = 1: a vector),
// row-major, in items of q consecutive values: thread t of block b takes
// items b U + t, (G + b) U + t, ... (G blocks, U threads that take items).
// U q is a multiple of m, so the lanes of a thread fall on the same
// columns in every item it takes, (t q + j) % m, and a block's items at a
// step are U q / m whole rows.
struct Walk {
  int q;            // values an item
  int used;         // U
  int rows;         // rows of a block's step: U q / m
  long long nvals;  // n m
  long long nit;    // items
};

__host__ __device__ inline int gcd_of(int a, int b) {
  while (b) {
    const int c = a % b;
    a = b;
    b = c;
  }
  return a;
}

__host__ __device__ inline Walk walk_of(long long n, int m, int q) {
  Walk w;
  w.q = q;
  const int step = m / gcd_of(m, q);  // U is a multiple of it
  w.used = step * (kThreads / step);
  w.rows = w.used * q / m;
  w.nvals = n * m;
  w.nit = (w.nvals + q - 1) / q;
  return w;
}

// the values of an item (kVec of them; the rest of the lanes 0)
template <typename T>
struct Item {
  T v[Vec<T>::n];
};

// the values of the item at a + e: one 16-byte load where it is whole and q
// is the vector width, else cnt values one at a time
template <typename T>
__device__ __forceinline__ Item<T> load_item(const T* a, long long e, int q, int cnt) {
  constexpr int kv = Vec<T>::n;
  Item<T> it;
  if (q == kv && cnt == kv) {
    unpack(it.v, *reinterpret_cast<const typename Vec<T>::type*>(a + e));
  } else {
#pragma unroll
    for (int j = 0; j < kv; ++j) it.v[j] = j < cnt ? a[e + j] : T(0);
  }
  return it;
}

template <typename T>
__device__ __forceinline__ void store_item(T* a, long long e, int q, int cnt, const Item<T>& it) {
  constexpr int kv = Vec<T>::n;
  if (q == kv && cnt == kv) {
    *reinterpret_cast<typename Vec<T>::type*>(a + e) = pack(it.v);
  } else {
#pragma unroll
    for (int j = 0; j < kv; ++j)
      if (j < cnt) a[e + j] = it.v[j];
  }
}

// the values of item `it` of the walk: q, or what is left at the end
__device__ __forceinline__ int item_count(long long it, const Walk& wk) {
  const long long left = wk.nvals - it * wk.q;
  return left < wk.q ? static_cast<int>(left) : wk.q;
}

// the values of item `it` of the walk for a thread that has one (active,
// within the items), else zeros
template <typename T>
__device__ __forceinline__ Item<T> item_or_zero(const T* a, long long it, bool active,
                                                const Walk& wk) {
  Item<T> v = {};
  if (active && it < wk.nit) v = load_item(a, it * wk.q, wk.q, item_count(it, wk));
  return v;
}

// four consecutive values of W, read once and not kept in the caches
__device__ inline void load4(float (&v)[4], const float* a) {
  unpack(v, __ldcs(reinterpret_cast<const float4*>(a)));
}
__device__ inline void load4(double (&v)[4], const double* a) {
  const double2 lo = __ldcs(reinterpret_cast<const double2*>(a));
  const double2 hi = __ldcs(reinterpret_cast<const double2*>(a) + 1);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// sh[row w + c] (row < rows) -> sh[c]: the sum over the rows of column c,
// a fixed tree (the rows past the largest power of two first folded onto
// the first ones, then row + s into row).  Every thread of the block calls
// it.
template <typename T>
__device__ void rows_tree(T* sh, int w, int rows) {
  int p = 1;
  while (2 * p <= rows) p *= 2;
  __syncthreads();
  for (int i = threadIdx.x; i < (rows - p) * w; i += kThreads) sh[i] += sh[i + p * w];
  __syncthreads();
  for (int s = p / 2; s > 0; s >>= 1) {
    for (int i = threadIdx.x; i < s * w; i += kThreads) sh[i] += sh[i + s * w];
    __syncthreads();
  }
}

// sh[0] = the block's sum of one value a thread: the pairwise tree of
// rows_tree(sh, 1, kThreads) (slot t + s into slot t), the same bits, its
// last five levels inside warp 0 by shuffles instead of barriers.  Every
// thread of the block calls it.
template <typename T>
__device__ __forceinline__ void block_sum1(T* sh, T v) {
  const int t = threadIdx.x;
  __syncthreads();
  sh[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s >= 32; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  if (t < 32) {
    T x = sh[t];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x += __shfl_down_sync(kFull, x, s);
    if (t == 0) sh[0] = x;
  }
  __syncthreads();
}

// sh[c] = the block's sum of column c < m of the threads' lane partials
// acc (the lanes of a vector's item are one column, folded first)
template <typename T>
__device__ __forceinline__ void block_cols(T* sh, const Item<T>& acc, const Walk& wk, int m) {
  const int t = threadIdx.x;
  if (m == 1) {
    block_sum1(sh, fold(acc.v));
  } else {
    __syncthreads();
    if (t < wk.used) {
#pragma unroll
      for (int j = 0; j < Vec<T>::n; ++j)  // constant bounds keep acc in registers
        if (j < wk.q) sh[t * wk.q + j] = acc.v[j];
    }
    rows_tree(sh, m, wk.rows);
  }
}

// the partials of block b at columns c0 .. c0 + q of a region of `stride`
// values a block (16 bytes where q is the vector width, else one value)
template <typename T>
__device__ __forceinline__ Item<T> load_partial(const T* part, int b, int stride, int c0, int q) {
  constexpr int kv = Vec<T>::n;
  const T* a = part + static_cast<long long>(b) * stride + c0;
  Item<T> it;
  if (q == kv) {
    unpack(it.v, __ldcg(reinterpret_cast<const typename Vec<T>::type*>(a)));
  } else {
#pragma unroll
    for (int j = 0; j < kv; ++j) it.v[j] = j == 0 ? __ldcg(a) : T(0);
  }
  return it;
}

// sh[c] = the sum over the grid's blocks of part[b stride + c] (c < cols)
// in one fixed order, the same in every block: thread (slot, group) adds
// the blocks slot, slot + slots, ... in order (16 bytes a load where cols
// and stride are multiples of the vector width, four loads in flight), then
// the tree over the slots.
template <typename T>
__device__ void sum_cols(T* sh, const T* part, int cols, int stride) {
  constexpr int kv = Vec<T>::n;
  const int q = cols % kv == 0 && stride % kv == 0 ? kv : 1, g = cols / q, nb = gridDim.x,
            t = threadIdx.x;
  int slots = 1;
  while (2 * slots * g <= kThreads) slots *= 2;
  T acc1 = 0;
  if (t < slots * g) {
    const int slot = t / g, c0 = (t % g) * q;
    Item<T> acc = {};
    int b = slot;
    for (; b + 3 * slots < nb; b += 4 * slots) {
      const Item<T> v0 = load_partial(part, b, stride, c0, q),
                    v1 = load_partial(part, b + slots, stride, c0, q),
                    v2 = load_partial(part, b + 2 * slots, stride, c0, q),
                    v3 = load_partial(part, b + 3 * slots, stride, c0, q);
#pragma unroll
      for (int j = 0; j < kv; ++j) acc.v[j] = ((acc.v[j] + v0.v[j]) + v1.v[j] + v2.v[j]) + v3.v[j];
    }
    for (; b < nb; b += slots) {
      const Item<T> v = load_partial(part, b, stride, c0, q);
#pragma unroll
      for (int j = 0; j < kv; ++j) acc.v[j] += v.v[j];
    }
    if (cols > 1) {
#pragma unroll
      for (int j = 0; j < kv; ++j)
        if (j < q) sh[slot * cols + c0 + j] = acc.v[j];
    } else {
      acc1 = acc.v[0];
    }
  }
  if (cols == 1) {  // every thread a slot
    block_sum1(sh, acc1);
  } else {
    rows_tree(sh, cols, slots);
  }
}

// sum_cols of a region of `cols` values a block
template <typename T>
__device__ void sum_cols(T* sh, const T* part, int cols) {
  sum_cols(sh, part, cols, cols);
}

// Every block of the (co-resident) grid waits here until all have arrived;
// what a block wrote before is then visible to every block.  The word
// starts at 0 and returns to it: block 0 adds 2^31 - (blocks - 1), the rest
// 1 each, so the top bit flips when the last block arrives.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, add);
    while (((old ^ *reinterpret_cast<volatile unsigned*>(bar)) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// the while_loop's cond on a column's state after its update
__device__ inline double cond_of(const double* s) {
  const double rn = s[kRnorm];
  const bool stalled = s[kSince] >= s[kStallLim] && rn < s[kGate];
  return (rn > s[kTol] && s[kK] < s[kMaxIter] && !stalled) ? 1.0 : 0.0;
}

// the deflation's thread groups: kd / 4 columns of four, rounded up to a
// power of two (<= 8)
__device__ inline int groups_of(int kd) {
  int g = 1;
  while (4 * g < kd) g *= 2;
  return g;
}

// W^T r over a chunk's rows [row0, row0 + nrows) (sr[i] = r[row0 + i]):
// thread t adds its four columns 4 (t % G) of rows t / G, t / G + kThreads
// / G, ... to its column partials wr, four rows' loads in flight
template <typename T>
__device__ __forceinline__ void wtr_chunk(T (&wr)[4], const T* w, const T* sr, long long row0,
                                          int nrows, int kd, int G) {
  const int g = threadIdx.x % G, rs = threadIdx.x / G, step = kThreads / G;
  if (4 * g >= kd) return;
  int i = rs;
  for (; i + 3 * step < nrows; i += 4 * step) {
    T v[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) load4(v[k], w + (row0 + i + k * step) * kd + 4 * g);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T ri = sr[i + k * step];
#pragma unroll
      for (int j = 0; j < 4; ++j) wr[j] += v[k][j] * ri;
    }
  }
  for (; i < nrows; i += step) {
    T v[4];
    load4(v, w + (row0 + i) * kd + 4 * g);
    const T ri = sr[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) wr[j] += v[j] * ri;
  }
}

// (W c)[row0 + i] -> sw[i] for a chunk's rows: thread t takes the four
// columns 4 (t % G) of a row with c's four values cv, and the G threads of
// the row add their parts with a fixed xor tree (every lane of the group
// ends with the same bits); four rows' loads in flight
template <typename T>
__device__ __forceinline__ void wc_chunk(T* sw, const T* w, const T (&cv)[4], long long row0,
                                         int nrows, int kd, int G) {
  const int g = threadIdx.x % G, rs = threadIdx.x / G, step = kThreads / G;
  const bool has = 4 * g < kd;
  for (int base = 0; base < nrows; base += 4 * step) {  // uniform: every lane shuffles
    T v[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = base + k * step + rs;
      if (has && i < nrows) {
        load4(v[k], w + (row0 + i) * kd + 4 * g);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[k][j] = T(0);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      T s = (v[k][0] * cv[0] + v[k][1] * cv[1]) + (v[k][2] * cv[2] + v[k][3] * cv[3]);
      for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      const int i = base + k * step + rs;
      if (g == 0 && i < nrows) sw[i] = s;
    }
  }
}

// The deflated block's split of a block's threads for W^T R: thread t is
// (g, cc, rs) = (t % G, (t / G) % CC, t / (G CC)): four columns 4g of W
// (G = kd / 4), columns cc BlockCols .. of R (CC of those), rows rs, rs + S,
// ... of a chunk (S slices); threads past S G CC are idle.
struct BlockSplit {
  int G, CC, S, g, cc, rs;
  bool active;
};

template <typename T>
__device__ __forceinline__ BlockSplit block_split(int kd, int m) {
  constexpr int mc = BlockCols<T>::n;
  BlockSplit bs;
  bs.G = kd / 4;
  bs.CC = (m + mc - 1) / mc;
  bs.S = kThreads / (bs.G * bs.CC);
  const int t = threadIdx.x;
  bs.g = t % bs.G;
  bs.cc = (t / bs.G) % bs.CC;
  bs.rs = t / (bs.G * bs.CC);
  bs.active = bs.rs < bs.S;
  return bs;
}

// A deflated block's ring of W tiles: kStages stages of kStageBytes in
// dynamic shared memory after a head of kRingHead bytes (their mbarriers),
// each stage filled by one bulk copy of a tile's rows (W is row-major, so a
// tile is contiguous) and reported by its mbarrier.  Tile j of a block is
// sub-tile j % spc of the block's (j / spc)-th chunk; a pass consumes its
// chunks' tiles in order, and thread 0 refills a stage with tile j +
// kStages as soon as every thread is done with tile j, so W's reads run
// ahead of the partial sums, the barriers and the arithmetic.  A tile has
// tile_rows rows, a multiple of 4, so no 16-byte item straddles two.
constexpr int kStageBytes = 32768, kStages = 2;
constexpr int kRingHead = 128;

__host__ __device__ inline int tile_rows(int kd, int itemsize, int rows) {
  const int tr = kStageBytes / (kd * itemsize) / 4 * 4;
  return tr < rows ? tr : rows;
}

template <typename T>
struct WRing {
  const T* w;
  uint64_t* bar;
  unsigned char* stages;
  long long n, u, nit;
  int kd, rows, tr, spc, j;
  uint64_t policy;

  // rows [r0, r0 + nr) of tile jj, or false past the block's last
  __device__ bool tile(int jj, long long& r0, int& nr) const {
    const long long kc = blockIdx.x + static_cast<long long>(jj / spc) * gridDim.x;
    if (kc * u >= nit) return false;
    r0 = kc * rows + static_cast<long long>(jj % spc) * tr;
    const long long end = kc * rows + rows < n ? kc * rows + rows : n;
    if (r0 >= end) return false;
    nr = static_cast<int>(end - r0 < tr ? end - r0 : tr);
    return true;
  }
  __device__ T* stage(int jj) const {
    return reinterpret_cast<T*>(stages + (jj % kStages) * kStageBytes);
  }
  __device__ void issue(int jj) const {  // thread 0
    long long r0;
    int nr;
    if (!tile(jj, r0, nr)) return;
    const uint32_t bytes = static_cast<uint32_t>(nr) * kd * sizeof(T);
    fcvm_bulk::mbar_expect_tx(bar + jj % kStages, bytes);
    fcvm_bulk::bulk_copy_g2s_hint(stage(jj), w + r0 * kd, bytes, bar + jj % kStages, policy);
  }
  // the next tile, once it has landed
  __device__ const T* wait() const {
    fcvm_bulk::mbar_wait(bar + j % kStages, (j / kStages) & 1);
    return stage(j);
  }
  // every thread is done with the tile: its stage takes tile j + kStages
  __device__ void release() {
    __syncthreads();
    if (threadIdx.x == 0) {
      fcvm_bulk::fence_proxy_async();  // the reads of the stage before its refill
      issue(j + kStages);
    }
    ++j;
  }
};

// the ring on dynamic shared memory `dyn`, its first kStages tiles issued;
// every thread of the block calls it
template <typename T>
__device__ WRing<T> ring_start(unsigned char* dyn, const T* w, long long n, int kd,
                               const Walk& wk) {
  WRing<T> g;
  g.w = w;
  g.bar = reinterpret_cast<uint64_t*>(dyn);
  g.stages = dyn + kRingHead;
  g.n = n;
  g.u = wk.used;
  g.nit = wk.nit;
  g.kd = kd;
  g.rows = wk.rows;
  g.tr = tile_rows(kd, sizeof(T), wk.rows);
  g.spc = (wk.rows + g.tr - 1) / g.tr;
  g.j = 0;
  g.policy = 0;
  if (threadIdx.x == 0) {
    g.policy = fcvm_bulk::evict_first_policy();  // W is read once a pass
    for (int s = 0; s < kStages; ++s) fcvm_bulk::mbar_init(g.bar + s, 1);
    fcvm_bulk::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) g.issue(s);
  return g;
}

// four consecutive values of a W tile in shared memory
__device__ inline void ld4(float (&v)[4], const float* a) {
  unpack(v, *reinterpret_cast<const float4*>(a));
}
__device__ inline void ld4(double (&v)[4], const double* a) {
  const double2* p = reinterpret_cast<const double2*>(a);
  const double2 lo = p[0], hi = p[1];
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// four consecutive values in shared memory; in float64, two 16-byte loads,
// the second half first where `swap` (rows that do so fill the banks the
// others leave)
__device__ inline void ld4x(float (&v)[4], const float* a, bool) { ld4(v, a); }
__device__ inline void ld4x(double (&v)[4], const double* a, bool swap) {
  const double2* p = reinterpret_cast<const double2*>(a);
  const double2 x = p[swap ? 1 : 0], y = p[swap ? 0 : 1];
  v[0] = swap ? y.x : x.x;
  v[1] = swap ? y.y : x.y;
  v[2] = swap ? x.x : y.x;
  v[3] = swap ? x.y : y.y;
}

// W^T R over nrows rows of a W tile ws (in shared memory) and of R (sr[i m
// + c] = R[row i of the tile, c]) into the thread's partials acc[j][k]
// (column 4g + j of W, column cc BlockCols + k of R), rows in order, four
// rows' loads in flight
template <typename T>
__device__ __forceinline__ void wtr_block_tile(T (&acc)[4][BlockCols<T>::n], const T* ws,
                                               const T* sr, int nrows, int kd, int m,
                                               const BlockSplit& bs) {
  constexpr int mc = BlockCols<T>::n;
  if (!bs.active) return;
  const int c0 = bs.cc * mc, S = bs.S;
  int i = bs.rs;
  for (; i + 3 * S < nrows; i += 4 * S) {
    T v[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) ld4(v[k], ws + (i + k * S) * kd + 4 * bs.g);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T* rr = sr + (i + k * S) * m + c0;
#pragma unroll
      for (int c = 0; c < mc; ++c)
        if (c0 + c < m) {
          const T rv = rr[c];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j][c] += v[k][j] * rv;
        }
    }
  }
  for (; i < nrows; i += S) {
    T v[4];
    ld4(v, ws + i * kd + 4 * bs.g);
    const T* rr = sr + i * m + c0;
#pragma unroll
    for (int c = 0; c < mc; ++c)
      if (c0 + c < m) {
        const T rv = rr[c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j][c] += v[j] * rv;
      }
  }
}

// The block's W^T R partial from its threads' acc, into out[c kd + i]: for
// each k < BlockCols, the slices' fixed tree (rows_tree) over columns k,
// BlockCols + k, ... of R (S rows of kd CC values: at most 4 kThreads)
template <typename T>
__device__ void block_wtr(T* sh, T* out, const T (&acc)[4][BlockCols<T>::n], int kd, int m,
                          const BlockSplit& bs) {
  constexpr int mc = BlockCols<T>::n;
  const int width = kd * bs.CC;
#pragma unroll
  for (int k = 0; k < mc; ++k) {
    if (k >= m) break;  // block-uniform
    __syncthreads();
    if (bs.active) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sh[bs.rs * width + bs.cc * kd + 4 * bs.g + j] = acc[j][k];
    }
    rows_tree(sh, width, bs.S);
    for (int t = threadIdx.x; t < width; t += kThreads) {
      const int c = (t / kd) * mc + k;
      if (c < m) out[static_cast<long long>(c) * kd + t % kd] = sh[t];
    }
  }
}

// A deflated block's C after its grid barrier: block c (c + grid, ...) sums
// column c of the grid's W^T R partials (m x kd a block, at part) in
// sum_cols's fixed order and writes C[i][c] = sum_j K_w^+[i][j] S[j] (j in
// order) for i < kd into cout (kd x m)
template <typename T>
__device__ void block_c(T* sh, const T* part, const T* __restrict__ kw_inv, T* cout, int kd,
                        int m) {
  const int t = threadIdx.x;
  for (int c = blockIdx.x; c < m; c += gridDim.x) {
    __syncthreads();
    sum_cols(sh, part + static_cast<long long>(c) * kd, kd, kd * m);
    if (t < kd) {
      T acc = 0;
      for (int j = 0; j < kd; ++j) acc += __ldg(kw_inv + t * kd + j) * sh[j];
      cout[t * m + c] = acc;
    }
  }
}

// A deflated block's z4 + W C on the lanes of an item, rows lrow[j] of the
// W tile ws (in shared memory), columns tcol[j] (sct: C transposed, a
// column's kd values at tcol (kd + 4)): each lane's sum over W's columns in
// groups of four, from group rot on (the rows of a warp then start in
// different banks), then added to z4.  `one`: every lane in the row of lane
// 0 (q divides m), one load of W a group; else a lane in the row of the one
// before it takes its loads.
template <typename T>
__device__ __forceinline__ void add_wc(Item<T>& zv, const T* ws, const T* sct,
                                       const int (&lrow)[Vec<T>::n], const int (&tcol)[Vec<T>::n],
                                       const bool (&fresh)[Vec<T>::n], int cnt, int kd, int rot,
                                       bool one, bool swap) {
  constexpr int kv = Vec<T>::n;
  const int ld = kd + 4, groups = kd / 4;
  T acc[kv] = {};
  int gi = rot;
  if (one) {
    const T* wr = ws + lrow[0] * kd;
#pragma unroll 2
    for (int s = 0; s < groups; ++s) {
      const int i = 4 * gi;
      gi = gi + 1 == groups ? 0 : gi + 1;
      T v[4];
      ld4x(v, wr + i, swap);
#pragma unroll
      for (int j = 0; j < kv; ++j) {
        T c[4];
        ld4x(c, sct + tcol[j] * ld + i, swap);
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[j] += v[l] * c[l];
      }
    }
  } else {
#pragma unroll 2
    for (int s = 0; s < groups; ++s) {
      const int i = 4 * gi;
      gi = gi + 1 == groups ? 0 : gi + 1;
      T v[kv][4];
#pragma unroll
      for (int j = 0; j < kv; ++j) {
        if (j < cnt && fresh[j]) {
          ld4x(v[j], ws + lrow[j] * kd + i, swap);
        } else {
#pragma unroll
          for (int l = 0; l < 4; ++l) v[j][l] = j > 0 ? v[j > 0 ? j - 1 : 0][l] : T(0);
        }
      }
#pragma unroll
      for (int j = 0; j < kv; ++j) {
        T c[4];
        ld4x(c, sct + tcol[j] * ld + i, swap);
#pragma unroll
        for (int l = 0; l < 4; ++l) acc[j] += v[j][l] * c[l];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kv; ++j)
    if (j < cnt) zv.v[j] = add_rn(zv.v[j], acc[j]);
}

// z4 + W C of the thread's item in chunk kc (in: the thread has an item
// there, of cnt values) over the chunk's W tiles from the ring: the tile
// that holds the item's rows adds to it; every thread waits for and
// releases each tile
template <typename T>
__device__ __forceinline__ void chunk_wc(Item<T>& zv, bool in, int cnt, WRing<T>& ring,
                                         const T* sct, long long kc, const Walk& wk, long long n,
                                         const int (&trow)[Vec<T>::n],
                                         const int (&tcol)[Vec<T>::n],
                                         const bool (&fresh)[Vec<T>::n], int kd, int rot,
                                         bool one, bool swap) {
  constexpr int kv = Vec<T>::n;
  const long long left = n - kc * wk.rows;
  const int crow = static_cast<int>(left < wk.rows ? left : wk.rows);
  for (int r0 = 0; r0 < crow; r0 += ring.tr) {
    const T* ws = ring.wait();
    if (in && trow[0] >= r0 && trow[0] < r0 + ring.tr) {
      int lrow[kv];
#pragma unroll
      for (int j = 0; j < kv; ++j) lrow[j] = trow[j] - r0;
      add_wc(zv, ws, sct, lrow, tcol, fresh, cnt, kd, rot, one, swap);
    }
    ring.release();
  }
}

// the rows of a vector's chunk at item cbase: [cbase q, cbase q + kThreads q) within n
__device__ __forceinline__ int chunk_rows(long long cbase, int q, long long n) {
  const long long left = n - cbase * q;
  return static_cast<int>(left < kThreads * q ? left : kThreads * q);
}

// The update pass's work on the thread's item in the chunk at item cbase
// (block-uniform): r -= alpha ap on the running lanes, ||r||^2 into rr and,
// deflated, the chunk's W^T r into wr (a deflated block's W^T R into acc)
template <typename T, bool kBlk>
__device__ __forceinline__ void update_chunk(T* r, const T* w, T* sr, const Item<T>& av,
                                             const Item<T>* rin, long long cbase, const Walk& wk,
                                             long long n, int m, int kd, int G, int start,
                                             const bool (&go)[Vec<T>::n], const Item<T>& al,
                                             Item<T>& rr, T (&wr)[4],
                                             T (&acc)[4][BlockCols<T>::n], const BlockSplit& bs,
                                             WRing<T>& ring) {
  constexpr int kv = Vec<T>::n;
  const int t = threadIdx.x, q = wk.q;
  const long long it = cbase + t;
  Item<T> rv = {};
  if (t < wk.used && it < wk.nit) {
    const int cnt = item_count(it, wk);
    rv = rin ? *rin : load_item(r, it * q, q, cnt);
    if (!start) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < kv; ++j)
        if (go[j]) {
          rv.v[j] = sub_rn(rv.v[j], mul_rn(al.v[j], av.v[j]));
          any = true;
        }
      if (any) store_item(r, it * q, q, cnt, rv);
    }
#pragma unroll
    for (int j = 0; j < kv; ++j) rr.v[j] += rv.v[j] * rv.v[j];
  }
  if constexpr (kBlk) {  // the chunk's rows of R, whole rows from row0; its W tiles
#pragma unroll
    for (int j = 0; j < kv; ++j)
      if (j < q) sr[t * q + j] = rv.v[j];
    __syncthreads();
    const long long left = n - cbase * q / m;
    const int crow = static_cast<int>(left < wk.rows ? left : wk.rows);
    for (int r0 = 0; r0 < crow; r0 += ring.tr) {
      const T* ws = ring.wait();
      wtr_block_tile(acc, ws, sr + r0 * m, crow - r0 < ring.tr ? crow - r0 : ring.tr, kd, m, bs);
      ring.release();
    }
  } else if (kd) {  // a vector
#pragma unroll
    for (int j = 0; j < kv; ++j)
      if (j < q) sr[t * q + j] = rv.v[j];
    __syncthreads();
    wtr_chunk(wr, w, sr, cbase * q, chunk_rows(cbase, q, n), kd, G);
    __syncthreads();
  }
}

// The update pass: p.ap, the barrier, alpha; r -= alpha ap, ||r||^2 and
// W^T r partials (start: the partials of r alone); a deflated block
// (kBlk): W^T R partials, a second barrier and C = K_w^+ W^T R
template <typename T, int kHeld, int kPre, bool kBlk>
__global__ void __launch_bounds__(kThreads, 2)
    cg_pass_update_kernel(double* st, T* part, unsigned* bar, T* r, const T* p, const T* ap,
                          const T* __restrict__ w, const T* __restrict__ kw_inv, long long n,
                          int m, int kd, int q, int start) {
  constexpr int kv = Vec<T>::n;
  __shared__ T sh[4 * kThreads];
  __shared__ T sr[kv * kThreads];
  __shared__ T salpha[kMaxCols];
  __shared__ bool sgo[kMaxCols];
  extern __shared__ __align__(128) unsigned char dyn[];  // a deflated block's W ring
  const int t = threadIdx.x;
  if (t < m) sgo[t] = !start && st[t * kSlots + kNext] != 0.0;  // the test of the last r
  if (!__syncthreads_or(start || (t < m && sgo[t]))) {
    if (blockIdx.x == 0 && t < m) st[t * kSlots + kRun] = 0.0;  // no column runs
    return;
  }
  const Walk wk = walk_of(n, m, q);
  const Layout lay = layout_of(gridDim.x, m, kd, n, kBlk);
  WRing<T> ring = {};
  if constexpr (kBlk) ring = ring_start<T>(dyn, w, n, kd, wk);  // W's reads start now
  const bool active = t < wk.used;
  const long long u = wk.used;
  Item<T> held[kHeld];                 // ap of the thread's first kHeld items
  Item<T> rpre[kPre > 0 ? kPre : 1];  // r of its first kPre, loaded before the barrier
  if (!start) {
    Item<T> acc = {};
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const long long it = (static_cast<long long>(k) * gridDim.x + blockIdx.x) * u + t;
      if (active && it < wk.nit) {
        const int cnt = item_count(it, wk);
        const Item<T> pv = load_item(p, it * q, q, cnt);
        held[k] = load_item(ap, it * q, q, cnt);
        if (k < kPre) rpre[k < kPre ? k : 0] = load_item(r, it * q, q, cnt);
#pragma unroll
        for (int j = 0; j < kv; ++j) acc.v[j] += pv.v[j] * held[k].v[j];
      }
    }
    if constexpr (kPre == 0) {  // later items: the few layout has none
      for (long long it = (static_cast<long long>(kHeld) * gridDim.x + blockIdx.x) * u + t;
           active && it < wk.nit; it += gridDim.x * u) {
        const int cnt = item_count(it, wk);
        const Item<T> pv = load_item(p, it * q, q, cnt), av = load_item(ap, it * q, q, cnt);
#pragma unroll
        for (int j = 0; j < kv; ++j) acc.v[j] += pv.v[j] * av.v[j];
      }
    }
    block_cols(sh, acc, wk, m);
    if (t < m) part[static_cast<long long>(blockIdx.x) * m + t] = sh[t];
    grid_sync(bar);
    sum_cols(sh, part, m);
    if (t < m) {
      const T rz = static_cast<T>(st[t * kSlots + kRz]), pap = sh[t];
      salpha[t] = rz / (pap == T(0) ? T(1) : pap);
    }
    __syncthreads();
    if (blockIdx.x == 0 && t < m) {
      double* s = st + t * kSlots;
      s[kRun] = sgo[t] ? 1.0 : 0.0;  // run = next
      if (sgo[t]) s[kAlpha] = static_cast<double>(salpha[t]);
    }
  }
  bool go[kv];
  Item<T> al;
#pragma unroll
  for (int j = 0; j < kv; ++j) {
    const int c = (t * q + (j < q ? j : 0)) % m;
    go[j] = active && sgo[c];
    al.v[j] = start ? T(0) : salpha[c];
  }
  const int G = kd && !kBlk ? groups_of(kd) : 1;
  Item<T> rr = {};
  T wr[4] = {};
  T acc[4][BlockCols<T>::n] = {};  // a deflated block's W^T R partials
  BlockSplit bs = {};
  if constexpr (kBlk) bs = block_split<T>(kd, m);
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const long long cbase = (static_cast<long long>(k) * gridDim.x + blockIdx.x) * u;
    if (cbase < wk.nit)
      update_chunk<T, kBlk>(r, w, sr, start ? Item<T>{} : held[k],
                            !start && k < kPre ? &rpre[k < kPre ? k : 0] : nullptr, cbase, wk, n,
                            m, kd, G, start, go, al, rr, wr, acc, bs, ring);
  }
  if constexpr (kPre == 0) {  // later items: the few layout has none
    for (long long cbase = (static_cast<long long>(kHeld) * gridDim.x + blockIdx.x) * u;
         cbase < wk.nit; cbase += gridDim.x * u) {
      Item<T> av = {};
      const long long it = cbase + t;
      if (!start && active && it < wk.nit) av = load_item(ap, it * q, q, item_count(it, wk));
      update_chunk<T, kBlk>(r, w, sr, av, static_cast<const Item<T>*>(nullptr), cbase, wk, n, m,
                            kd, G, start, go, al, rr, wr, acc, bs, ring);
    }
  }
  block_cols(sh, rr, wk, m);
  if (t < m) part[lay.y + static_cast<long long>(blockIdx.x) * m + t] = sh[t];
  if constexpr (kBlk) {  // the block's m x kd partials; the barrier; C
    block_wtr(sh, part + lay.w + static_cast<long long>(blockIdx.x) * kd * m, acc, kd, m, bs);
    grid_sync(bar);
    block_c(sh, part + lay.w, kw_inv, part + lay.c, kd, m);
  } else if (kd) {
    __syncthreads();
    const int g = t % G, rs = t / G;
    if (4 * g < kd)
#pragma unroll
      for (int j = 0; j < 4; ++j) sh[rs * kd + 4 * g + j] = wr[j];
    rows_tree(sh, kd, kThreads / G);
    if (t < kd) part[lay.w + static_cast<long long>(blockIdx.x) * kd + t] = sh[t];
  }
}

// z of the thread's item in the chunk at item cbase (0 outside the items),
// with the chunk's W c when deflated (block-uniform)
template <typename T>
__device__ __forceinline__ Item<T> z_chunk(const T* z, const Item<T>* zin, const T* w, T* sw,
                                           const T (&cv)[4], long long cbase, const Walk& wk,
                                           long long n, int kd, int G) {
  constexpr int kv = Vec<T>::n;
  const int t = threadIdx.x, q = wk.q;
  const long long it = cbase + t;
  const bool in = t < wk.used && it < wk.nit;
  Item<T> zv = {};
  if (in) zv = zin ? *zin : load_item(z, it * q, q, item_count(it, wk));
  if (kd) {
    wc_chunk(sw, w, cv, cbase * q, chunk_rows(cbase, q, n), kd, G);
    __syncthreads();
    if (in) {
      const int cnt = item_count(it, wk);
#pragma unroll
      for (int j = 0; j < kv; ++j)
        if (j < cnt) zv.v[j] = add_rn(zv.v[j], sw[t * q + j]);
    }
    __syncthreads();
  }
  return zv;
}

// The direction pass's update of item `it`: x += alpha p and p = z + beta p
// on the running lanes (start: p = z), and a harvest's slot kz
template <typename T>
__device__ __forceinline__ void direction_item(T* x, T* p, T* zs, const Item<T>& zv,
                                               const Item<T>* pin, const Item<T>* xin,
                                               long long it, const Walk& wk, long long n,
                                               long long kz, int start,
                                               const bool (&go)[Vec<T>::n], const Item<T>& al,
                                               const Item<T>& be) {
  constexpr int kv = Vec<T>::n;
  const int q = wk.q, cnt = item_count(it, wk);
  const long long e = it * q;
  if (start) {
    store_item(p, e, q, cnt, zv);
  } else {
    Item<T> pv = pin ? *pin : load_item(p, e, q, cnt), xv = xin ? *xin : load_item(x, e, q, cnt);
#pragma unroll
    for (int j = 0; j < kv; ++j)
      if (go[j]) {
        xv.v[j] = add_rn(xv.v[j], mul_rn(al.v[j], pv.v[j]));
        pv.v[j] = add_rn(zv.v[j], mul_rn(be.v[j], pv.v[j]));
      }
    store_item(x, e, q, cnt, xv);
    store_item(p, e, q, cnt, pv);
  }
  if (zs)  // a vector
#pragma unroll
    for (int j = 0; j < kv; ++j)
      if (j < cnt) zs[kz * n + e + j] = zv.v[j];
}

// The direction pass: ||r||, the counters, the test and c from the update's
// partials; z = z4 + W c, r.z partials, the barrier, beta; x += alpha p, p =
// z + beta p and the harvest's slot (start: p = z and slot 0 alone).  The
// operands of the thread's first kPre items are loaded before the head's
// sums, so their reads overlap it and the barrier.  A deflated block
// (kBlk) reads the update pass's C into its dynamic shared memory (m (kd +
// 4) values).
template <typename T, int kHeld, int kPre, bool kBlk>
__global__ void __launch_bounds__(kThreads, 2)
    cg_pass_direction_kernel(double* st, T* part, unsigned* bar, T* x, const T* r, T* p,
                             const T* z, const T* __restrict__ w, const T* __restrict__ kw_inv,
                             T* zs, T* coef, long long n, int m, int kd, int nstore, int q,
                             int start) {
  constexpr int kv = Vec<T>::n;
  __shared__ T sh[4 * kThreads];
  __shared__ T sw[kBlk ? 1 : kv * kThreads];
  __shared__ T skw[kBlk ? 1 : kMaxDefl * kMaxDefl];
  __shared__ double sst[kMaxCols * kSlots];
  __shared__ T sc[kBlk ? 1 : kMaxDefl];
  extern __shared__ __align__(128) unsigned char dyn[];  // a deflated block's W ring, then C^T
  T* sct = reinterpret_cast<T*>(dyn + kRingHead + kStages * kStageBytes);
  __shared__ T salpha[kMaxCols], sbeta[kMaxCols];
  __shared__ bool sgo[kMaxCols];
  const int t = threadIdx.x;
  for (int i = t; i < m * kSlots; i += kThreads) sst[i] = st[i];  // every block, before the barrier
  __syncthreads();
  if (t < m) sgo[t] = start || sst[t * kSlots + kRun] != 0.0;
  if (!__syncthreads_or(t < m && sgo[t])) return;
  const Walk wk = walk_of(n, m, q);
  const Layout lay = layout_of(gridDim.x, m, kd, n, kBlk);
  const bool active = t < wk.used;
  const long long u = wk.used;
  WRing<T> ring = {};
  if constexpr (kBlk) ring = ring_start<T>(dyn, w, n, kd, wk);  // W's reads start now
  constexpr int kP = kPre > 0 ? kPre : 1;
  Item<T> zpre[kP], rpre[kP], ppre[kP], xpre[kP];
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const long long it = (static_cast<long long>(k) * gridDim.x + blockIdx.x) * u + t;
    if (active && it < wk.nit) {
      const int cnt = item_count(it, wk);
      zpre[k] = load_item(z, it * q, q, cnt);
      rpre[k] = load_item(r, it * q, q, cnt);
      if (!start) {
        ppre[k] = load_item(p, it * q, q, cnt);
        xpre[k] = load_item(x, it * q, q, cnt);
      }
    }
  }
  // the head: ||r|| and the test of each running column, in every block
  sum_cols(sh, part + lay.y, m);
  if (t < m && sgo[t]) {
    double* s = sst + t * kSlots;
    const double rn = static_cast<double>(sqrt_of(sh[t]));
    if (start) {
      const double bn = s[kBnorm];
      s[kK] = 0.0;
      s[kSince] = 0.0;
      s[kBest] = rn;
      s[kTol] = fmax(s[kRtol] * bn, s[kAtol]);
      s[kGate] = 1.0e-3 * bn;
      s[kRun] = 1.0;
    } else {
      s[kK] += 1.0;
      s[kSince] = rn < 0.999 * s[kBest] ? 0.0 : s[kSince] + 1.0;
      s[kBest] = fmin(s[kBest], rn);
    }
    s[kRnorm] = rn;
    s[kNext] = cond_of(s);
  }
  if (t < m) salpha[t] = static_cast<T>(sst[t * kSlots + kAlpha]);
  const int G = kd && !kBlk ? groups_of(kd) : 1;
  T cv[4] = {};
  // a deflated block: the rows and columns of the thread's lanes in a chunk
  // (the same in every chunk), and whether a lane starts a row in its item
  int trow[kv], tcol[kv], rot = 0;
  bool fresh[kv], one = false, swap = false;
  if constexpr (kBlk) {
    for (int i = t; i < kd * m; i += kThreads) sct[(i % m) * (kd + 4) + i / m] = part[lay.c + i];
#pragma unroll
    for (int j = 0; j < kv; ++j) {
      const int e = t * q + j;
      trow[j] = e / m;
      tcol[j] = e % m;
      fresh[j] = j == 0 || trow[j] != trow[j > 0 ? j - 1 : 0];
    }
    rot = (trow[0] & 7) % (kd / 4);
    one = m % q == 0;
    swap = sizeof(T) == 8 && ((trow[0] >> 2) & 1);
  } else if (kd) {  // c = K_w^+ (W^T r), each entry a sum in column order
    for (int i = t; i < kd * kd; i += kThreads) skw[i] = kw_inv[i];
    __syncthreads();
    sum_cols(sh, part + lay.w, kd);
    if (t < kd) {
      T acc = 0;
      for (int j = 0; j < kd; ++j) acc += skw[t * kd + j] * sh[j];
      sc[t] = acc;
    }
    __syncthreads();
    if (blockIdx.x == 0 && t < kd) part[lay.c + t] = sc[t];
    const int g = t % G;
#pragma unroll
    for (int j = 0; j < 4; ++j) cv[j] = 4 * g + j < kd ? sc[4 * g + j] : T(0);
  }
  __syncthreads();
  Item<T> held[kHeld];  // z (+ W c) of the thread's first kHeld items
  Item<T> acc = {};
  // a deflated block waits for every tile, so its z and r of the next chunk
  // are loaded a chunk ahead
  const long long step = gridDim.x * u;
  Item<T> znx = {}, rnx = {};
  if constexpr (kBlk) {
    znx = item_or_zero(z, blockIdx.x * u + t, active, wk);
    rnx = item_or_zero(r, blockIdx.x * u + t, active, wk);
  }
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const long long kc = static_cast<long long>(k) * gridDim.x + blockIdx.x,
                    cbase = kc * u;
    if (cbase < wk.nit) {
      const int kp = k < kPre ? k : 0;
      const long long it = cbase + t;
      if constexpr (kBlk) {
        const bool in = active && it < wk.nit;
        const int cnt = in ? item_count(it, wk) : 0;
        Item<T> zv = znx;
        const Item<T> rv = rnx;
        znx = item_or_zero(z, it + step, active, wk);
        rnx = item_or_zero(r, it + step, active, wk);
        chunk_wc(zv, in, cnt, ring, sct, kc, wk, n, trow, tcol, fresh, kd, rot, one, swap);
        held[k] = zv;
#pragma unroll
        for (int j = 0; j < kv; ++j) acc.v[j] += rv.v[j] * zv.v[j];
      } else {
        held[k] = z_chunk(z, k < kPre ? &zpre[kp] : nullptr, w, sw, cv, cbase, wk, n, kd, G);
        if (active && it < wk.nit) {
          const Item<T> rv = k < kPre ? rpre[kp] : load_item(r, it * q, q, item_count(it, wk));
#pragma unroll
          for (int j = 0; j < kv; ++j) acc.v[j] += rv.v[j] * held[k].v[j];
        }
      }
    }
  }
  if constexpr (kPre == 0) {  // later items: the few layout has none
    for (long long kc = static_cast<long long>(kHeld) * gridDim.x + blockIdx.x; kc * u < wk.nit;
         kc += gridDim.x) {
      const long long cbase = kc * u, it = cbase + t;
      if constexpr (kBlk) {  // z + W C kept in the scratch until after the barrier
        const bool in = active && it < wk.nit;
        const int cnt = in ? item_count(it, wk) : 0;
        Item<T> zv = znx;
        const Item<T> rv = rnx;
        znx = item_or_zero(z, it + step, active, wk);
        rnx = item_or_zero(r, it + step, active, wk);
        chunk_wc(zv, in, cnt, ring, sct, kc, wk, n, trow, tcol, fresh, kd, rot, one, swap);
        if (in) {
          store_item(part + lay.z, it * q, q, cnt, zv);
#pragma unroll
          for (int j = 0; j < kv; ++j) acc.v[j] += rv.v[j] * zv.v[j];
        }
      } else {
        const Item<T> zv = z_chunk(z, static_cast<const Item<T>*>(nullptr), w, sw, cv, cbase, wk,
                                   n, kd, G);
        if (active && it < wk.nit) {
          const Item<T> rv = load_item(r, it * q, q, item_count(it, wk));
#pragma unroll
          for (int j = 0; j < kv; ++j) acc.v[j] += rv.v[j] * zv.v[j];
        }
      }
    }
  }
  block_cols(sh, acc, wk, m);
  if (t < m) part[static_cast<long long>(blockIdx.x) * m + t] = sh[t];
  grid_sync(bar);
  sum_cols(sh, part, m);
  if (t < m && sgo[t]) {
    double* s = sst + t * kSlots;
    const T rz_new = sh[t];
    if (!start) {
      const T rz = static_cast<T>(s[kRz]);
      s[kBeta] = static_cast<double>(rz_new / (rz == T(0) ? T(1) : rz));
    }
    s[kRz] = static_cast<double>(rz_new);
  }
  __syncthreads();
  if (t < m) sbeta[t] = static_cast<T>(sst[t * kSlots + kBeta]);
  if (blockIdx.x == 0)
    for (int i = t; i < m * kSlots; i += kThreads) st[i] = sst[i];
  // the JAX package's slots: z and rz at min(k, cap), alpha and beta of the
  // step that made them at min(k - 1, cap), k already advanced
  const long long cap = nstore - 1, kk = static_cast<long long>(sst[kK]);
  const long long kz = kk < cap ? kk : cap, kc = kk - 1 < cap ? kk - 1 : cap;
  if (coef && blockIdx.x == 0 && t == 0) {  // rows rz, alpha, beta of (3, nstore)
    coef[kz] = static_cast<T>(sst[kRz]);
    if (!start) {
      coef[nstore + kc] = static_cast<T>(sst[kAlpha]);
      coef[2 * nstore + kc] = static_cast<T>(sst[kBeta]);
    }
  }
  __syncthreads();
  bool go[kv];
  Item<T> al, be;
#pragma unroll
  for (int j = 0; j < kv; ++j) {
    const int c = (t * q + (j < q ? j : 0)) % m;
    go[j] = sgo[c];
    al.v[j] = salpha[c];
    be.v[j] = sbeta[c];
  }
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    const long long it = (static_cast<long long>(k) * gridDim.x + blockIdx.x) * u + t;
    const int kp = k < kPre ? k : 0;
    const bool pre = !start && k < kPre;
    if (active && it < wk.nit)
      direction_item(x, p, zs, held[k], pre ? &ppre[kp] : nullptr, pre ? &xpre[kp] : nullptr, it,
                     wk, n, kz, start, go, al, be);
  }
  if constexpr (kPre == 0) {  // later items: the few layout has none
    for (long long cbase = (static_cast<long long>(kHeld) * gridDim.x + blockIdx.x) * u;
         cbase < wk.nit; cbase += gridDim.x * u) {
      const long long it = cbase + t;
      Item<T> zv;
      if constexpr (kBlk) {  // the thread's own z + W C from before the barrier
        if (active && it < wk.nit) zv = load_item(part + lay.z, it * q, q, item_count(it, wk));
      } else {
        zv = z_chunk(z, static_cast<const Item<T>*>(nullptr), w, sw, cv, cbase, wk, n, kd, G);
      }
      if (active && it < wk.nit)
        direction_item(x, p, zs, zv, static_cast<const Item<T>*>(nullptr),
                       static_cast<const Item<T>*>(nullptr), it, wk, n, kz, start, go, al, be);
    }
  }
}

// a deflated block's dynamic shared memory: the W ring in both passes and,
// in the direction pass (step 1), C transposed, m (kd + 4) values
template <typename T>
size_t block_smem(int step, int m, int kd) {
  return kRingHead + static_cast<size_t>(kStages) * kStageBytes +
         (step ? static_cast<size_t>(m) * (kd + 4) * sizeof(T) : 0);
}

// the deflated block's kernels take more than the default 48 KB of shared
// memory: raise their limit to the most a plan asks, once per process
template <typename T>
bool allow_block_smem() {
  static const bool ok = [] {
    const void* kernels[] = {(const void*)cg_pass_update_kernel<T, kFewHeld, kFewPre, true>,
                             (const void*)cg_pass_direction_kernel<T, kFewHeld, kFewPre, true>,
                             (const void*)cg_pass_update_kernel<T, Many<T>::held, 0, true>,
                             (const void*)cg_pass_direction_kernel<T, Many<T>::held, 0, true>};
    for (int i = 0; i < 4; ++i)
      if (cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(block_smem<T>(i % 2, kMaxCols,
                                                              kMaxDeflBlock))) != cudaSuccess)
        return false;
    return true;
  }();
  return ok;
}

// the blocks an SM keeps resident for both passes of a plan (the deflated
// block's kernels with their shared memory at (m, kd)), at most
// kMaxBlocksPerSm, times the SMs; -1 on an error
template <typename T>
int resident_grid(bool block, int m, int kd) {
  int dev = 0, sms = 0, per = kMaxBlocksPerSm;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  if (block && !allow_block_smem<T>()) return -1;
  const void* kernels[] = {
      block ? (void*)cg_pass_update_kernel<T, kFewHeld, kFewPre, true>
            : (void*)cg_pass_update_kernel<T, kFewHeld, kFewPre, false>,
      block ? (void*)cg_pass_direction_kernel<T, kFewHeld, kFewPre, true>
            : (void*)cg_pass_direction_kernel<T, kFewHeld, kFewPre, false>,
      block ? (void*)cg_pass_update_kernel<T, Many<T>::held, 0, true>
            : (void*)cg_pass_update_kernel<T, Many<T>::held, 0, false>,
      block ? (void*)cg_pass_direction_kernel<T, Many<T>::held, 0, true>
            : (void*)cg_pass_direction_kernel<T, Many<T>::held, 0, false>};
  for (int i = 0; i < 4; ++i) {
    int a = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &a, kernels[i], kThreads, block ? block_smem<T>(i % 2, m, kd) : 0) != cudaSuccess)
      return -1;
    per = a < per ? a : per;
  }
  return per * sms;
}

// C interface: returns the launch's error (0 = launched); step 0 is the
// update (v = ap), 1 the direction (v = z); grid from fcvm_cg_grid.  block:
// the vectors are an (n, m) block (deflated: the block form of the
// deflation, at any m).
template <typename T>
int cg_pass(int step, int start, double* st, T* part, unsigned* bar, T* x, T* r, T* p, T* v,
            const T* w, const T* kw_inv, T* zs, T* coef, long long n, int m, int kd, int nstore,
            int block, int grid, void* stream) {
  constexpr int kv = Vec<T>::n;
  auto aligned = [](const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; };
  const bool blk = block && kd;
  if (m < 1 || m > kMaxCols || kd < 0 || kd > (block ? kMaxDeflBlock : kMaxDefl) || kd % 4 != 0 ||
      (!block && m != 1) || (kd && !kw_inv) || ((zs || coef) && block) || n < 0 || grid < 1 ||
      (kd && !aligned(w)) || (blk && !allow_block_smem<T>()))
    return static_cast<int>(cudaErrorInvalidValue);
  int q = aligned(x) && aligned(r) && aligned(p) && aligned(v) ? kv : 1;
  const Walk wk = walk_of(n, m, q);
  const bool few = wk.nit <= static_cast<long long>(kFewHeld) * grid * wk.used;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (step == 0) {
    const T *pc = p, *vc = v;
    void* args[] = {&st, &part, &bar, &r, &pc, &vc, &w, &kw_inv, &n, &m, &kd, &q, &start};
    const void* k =
        blk ? (few ? (void*)cg_pass_update_kernel<T, kFewHeld, kFewPre, true>
                   : (void*)cg_pass_update_kernel<T, Many<T>::held, 0, true>)
            : (few ? (void*)cg_pass_update_kernel<T, kFewHeld, kFewPre, false>
                   : (void*)cg_pass_update_kernel<T, Many<T>::held, 0, false>);
    err = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), args,
                                      blk ? block_smem<T>(0, m, kd) : 0, s);
  } else if (step == 1) {
    const T *rc = r, *vc = v;
    void* args[] = {&st, &part, &bar, &x,  &rc, &p,      &vc, &w,     &kw_inv,
                    &zs, &coef, &n,   &m,  &kd, &nstore, &q,  &start};
    const void* k =
        blk ? (few ? (void*)cg_pass_direction_kernel<T, kFewHeld, kFewPre, true>
                   : (void*)cg_pass_direction_kernel<T, Many<T>::held, 0, true>)
            : (few ? (void*)cg_pass_direction_kernel<T, kFewHeld, kFewPre, false>
                   : (void*)cg_pass_direction_kernel<T, Many<T>::held, 0, false>);
    err = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), args,
                                      blk ? block_smem<T>(1, m, kd) : 0, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// the blocks of K6's grid for an (n, m) solve on the current device (block:
// an (n, m) block deflated by kd vectors): as many as stay resident on
// every SM for both passes (at most kMaxBlocksPerSm an SM), and no more
// than one sweep of the items needs; -1 on an error
extern "C" int fcvm_cg_grid(int itemsize, long long n, int m, int kd, int block) {
  if (m < 1 || m > kMaxCols || n < 0 || (itemsize != 4 && itemsize != 8) || kd < 0 ||
      kd > kMaxDeflBlock)
    return -1;
  const bool blk = block && kd;
  const int resident =
      itemsize == 4 ? resident_grid<float>(blk, m, kd) : resident_grid<double>(blk, m, kd);
  if (resident < 1) return -1;
  const int kv = 16 / itemsize;
  const Walk wk = walk_of(n, m, kv);
  const long long need = (wk.nit + wk.used - 1) / wk.used;
  return static_cast<int>(need < 1 ? 1 : (need < resident ? need : resident));
}

// the scratch's layout for a grid of `grid` blocks, in values: out = the
// offsets of the ||r||^2 partials, the W^T r partials and c, the size (the
// one copy the wrapper slices c from and the op checks the size by), and
// the offset of a deflated block's z
extern "C" void fcvm_cg_layout(int grid, int m, int kd, long long n, int block, long long* out) {
  const Layout l = layout_of(grid, m, kd, n, block != 0);
  out[0] = l.y;
  out[1] = l.w;
  out[2] = l.c;
  out[3] = l.size;
  out[4] = l.z;
}

extern "C" int fcvm_cg_pass_f32(int step, int start, double* st, float* part, unsigned* bar,
                                float* x, float* r, float* p, float* v, const float* w,
                                const float* kw_inv, float* zs, float* coef, long long n, int m,
                                int kd, int nstore, int block, int grid, void* stream) {
  return cg_pass<float>(step, start, st, part, bar, x, r, p, v, w, kw_inv, zs, coef, n, m, kd,
                        nstore, block, grid, stream);
}

extern "C" int fcvm_cg_pass_f64(int step, int start, double* st, double* part, unsigned* bar,
                                double* x, double* r, double* p, double* v, const double* w,
                                const double* kw_inv, double* zs, double* coef, long long n,
                                int m, int kd, int nstore, int block, int grid, void* stream) {
  return cg_pass<double>(step, start, st, part, bar, x, r, p, v, w, kw_inv, zs, coef, n, m, kd,
                         nstore, block, grid, stream);
}
