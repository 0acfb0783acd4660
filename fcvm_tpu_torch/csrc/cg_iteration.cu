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
// block form (m <= 64 columns, one state each, no deflation or harvest)
// replaces the same body under the vmap of fcvm_tpu/runtime/buckling.py::
// _kinv (:552-567), whose columns freeze, not drop, once done.
//
// The solve's scalars live in a float64 state row a column (the slots
// below, ops/kernels.py CG_SLOTS), read and written only by the passes, so
// no iteration needs the host: the caller queues iterations and reads the
// flags once per batch.  Four passes an iteration, around K1 (ap = K_hat p)
// and K4 (z4 = M r):
//   (a) p.ap.  Its tail copies `next` to `run` and writes alpha.
//   (b) r -= alpha ap, ||r||^2 and (deflated) W^T r.  Its tail writes
//       rnorm, k, best, since and `next`, the cond of the next iteration
//       decided from this one's r (tolerance, stall and gate compared in
//       float64), and c = K_w^+ (W^T r) (kd x kd, on chip).
//   (c) (deflated) z = z4 + W c, written over z4; then r.z.  Its tail writes
//       beta and rz.
//   (d) x += alpha p and p = z + beta p, reading the old p once for both (x
//       takes the step where the direction is read anyway: nothing between
//       (b) and (d) reads x); in a harvesting solve z into slot min(k, cap)
//       of the harvest and rz, alpha and beta beside it.
// A pass writes nothing of a column whose `run` is 0, so a converged solve
// stays frozen bit for bit while the queued iterations pass; a pass with no
// running column returns at once.  The start of a solve runs (b), (c) and
// (d) in their start form: ||r0||, the tolerance and gate from ||b||, rz0,
// and slot 0 of the harvest.
//
// Sums: a block sums its rows of a column in a fixed order (a thread's rows,
// then a shared-memory tree over the threads of the column), writes one
// partial a column and takes an integer ticket; the block that takes the
// last ticket adds the partials in the same order and writes the state.  No
// float atomics: two runs give the same bits.  The element updates round as
// the plain version's separate product and sum (no contraction to an FMA),
// so x, r and p are its bits given the same scalars.  The sums and the
// state's step lengths stay in the working dtype; the state stores them in
// float64, exactly.
//
// What bounds it: bytes.  An iteration reads and writes 12 vectors of n
// values (p, ap; r, ap, r; r, z; z, p, x, p, x): 24.1 MB in float32 on the
// 502,599-dof plate, 7.2 us at 3.35 TB/s; deflated it also reads W (n, 32)
// twice and writes z, 154.8 MB, 46.2 us (the floor: W^T r needs the new r
// and W c must reach z before r.z); a harvest writes z once more; a block
// of m columns moves 12 m.  The design's answer: each operand read
// once a pass, the deflation products inside the passes that hold r and z
// already, a warp reading W's rows whole (a lane a column), and at most
// kMaxBlocks blocks whose partials stay in L2, the last block loading
// eight blocks' partials at once.  What it cannot hide: four tails an
// iteration (a fence, a ticket and a tree over the partials), latency that
// a kernel per pass pays.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// the state's slots (float64 each), a row of kSlots a column
constexpr int kRz = 0, kAlpha = 1, kBeta = 2, kK = 3, kRnorm = 4, kBest = 5, kSince = 6,
              kRun = 7, kNext = 8, kTol = 9, kGate = 10, kStallLim = 11, kMaxIter = 12,
              kBnorm = 13, kRtol = 14, kAtol = 15, kSlots = 16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kMaxCols = 64;  // columns of a block solve; partial columns of a pass
constexpr int kMaxDefl = 32;  // deflation vectors: a lane each
// scratch: kMaxBlocks x kMaxCols partials, then c (kMaxDefl)
constexpr long long kScratchC = static_cast<long long>(kMaxBlocks) * kMaxCols;
constexpr unsigned kFull = 0xffffffffu;

// the row slots of a block: the largest power of two R with R m <= kThreads;
// thread t takes column t % m at row slot t / m, so a warp reads runs of
// consecutive values of a row-major (n, m) block
__host__ __device__ inline int row_slots(int m) {
  int r = 1;
  while (2 * r * m <= kThreads) r *= 2;
  return r;
}

__host__ __device__ inline int grid_of(long long n, int m) {
  const long long rows = row_slots(m);
  const long long g = (n + rows - 1) / rows;
  return static_cast<int>(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

// products and sums rounded alone (no FMA contraction): the plain version's
__device__ inline float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ inline double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ inline float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ inline double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ inline float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ inline double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ inline float sqrt_of(float a) { return sqrtf(a); }
__device__ inline double sqrt_of(double a) { return sqrt(a); }

// sh[slot m + c] (slot < R) -> sh[c]: the sum over the slots of column c, a
// fixed tree (slot + s into slot).  Every thread of the block calls it.
template <typename T>
__device__ void column_tree(T* sh, int m, int R) {
  __syncthreads();
  for (int s = R / 2; s > 0; s >>= 1) {
    if (static_cast<int>(threadIdx.x) < s * m) sh[threadIdx.x] += sh[threadIdx.x + s * m];
    __syncthreads();
  }
}

// The block's partials: v at thread (slot, c) of the mapping of
// row_slots(m), summed over the slots; columns c < nw go to
// part[block cols + col0 + c].
template <typename T>
__device__ void write_partials(T* sh, T v, int m, T* part, int cols, int col0, int nw) {
  const int R = row_slots(m), t = threadIdx.x;
  if (t < R * m) sh[t] = v;
  column_tree(sh, m, R);
  if (t < nw) part[static_cast<long long>(blockIdx.x) * cols + col0 + t] = sh[t];
  __syncthreads();
}

// After every block wrote its partials: true in the one block that takes the
// last ticket, which sets the ticket back to 0 for the next pass.
__device__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    last = t == gridDim.x - 1;
    if (last) *ticket = 0u;
  }
  __syncthreads();
  return last;
}

// In the last block: sh[c] = the sum over the gridDim.x blocks of column c
// of the partials (cols columns), in block order per slot, then the tree.
// The loads of eight blocks are in flight at once; they are added in order.
template <typename T>
__device__ void sum_partials(T* sh, const T* part, int cols) {
  const int R = row_slots(cols), t = threadIdx.x, nb = gridDim.x;
  if (t < R * cols) {
    const int c = t % cols;
    T acc = 0;
    int b = t / cols;
    for (; b + 7 * R < nb; b += 8 * R) {
      T v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldcg(part + static_cast<long long>(b + k * R) * cols + c);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += v[k];
    }
    for (; b < nb; b += R) acc += __ldcg(part + static_cast<long long>(b) * cols + c);
    sh[t] = acc;
  }
  column_tree(sh, cols, R);
}

// the while_loop's cond on a column's state after its update
__device__ inline double cond_of(const double* s) {
  const double rn = s[kRnorm];
  const bool stalled = s[kSince] >= s[kStallLim] && rn < s[kGate];
  return (rn > s[kTol] && s[kK] < s[kMaxIter] && !stalled) ? 1.0 : 0.0;
}

// One step of transpose_sum: a lane keeps the S rows of v whose bit S
// matches its own and adds its partner's (lane ^ S) copies of them.
template <int S, typename T>
__device__ inline void transpose_step(T (&v)[32], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const T send = upper ? v[i] : v[i + S];
    const T keep = upper ? v[i + S] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, S);
  }
}

// v[i] in each lane, i < 32: returns in lane l the sum over the warp's
// lanes of v[l], a fixed tree of 31 shuffles (each step halves the rows a
// lane carries); every index a constant, so v stays in registers
template <typename T>
__device__ inline T transpose_sum(T (&v)[32]) {
  const int lane = threadIdx.x & 31;
  transpose_step<16>(v, lane);
  transpose_step<8>(v, lane);
  transpose_step<4>(v, lane);
  transpose_step<2>(v, lane);
  transpose_step<1>(v, lane);
  return v[0];
}

// (a) p.ap; the tail: run = next, alpha = rz / (pap == 0 ? 1 : pap)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_pap_kernel(double* __restrict__ st, T* __restrict__ part, unsigned* ticket,
                  const T* __restrict__ p, const T* __restrict__ ap, long long n, int m) {
  __shared__ T sh[kThreads];
  const int t = threadIdx.x;
  if (!__syncthreads_or(t < m && st[t * kSlots + kNext] != 0.0)) {
    if (blockIdx.x == 0 && t < m) st[t * kSlots + kRun] = 0.0;  // no column runs
    return;
  }
  const int R = row_slots(m), c = t % m, slot = t / m;
  T acc = 0;
  if (slot < R)
    for (long long row = static_cast<long long>(blockIdx.x) * R + slot; row < n;
         row += static_cast<long long>(gridDim.x) * R)
      acc += p[row * m + c] * ap[row * m + c];
  write_partials(sh, acc, m, part, m, 0, m);
  if (!last_block(ticket)) return;
  sum_partials(sh, part, m);
  if (t < m) {
    double* s = st + t * kSlots;
    const double next = s[kNext];
    s[kRun] = next;
    if (next != 0.0) {
      const T pap = sh[t];
      s[kAlpha] = static_cast<double>(static_cast<T>(s[kRz]) / (pap == T(0) ? T(1) : pap));
    }
  }
}

// (b) the update, ||r||^2 and W^T r (start: no update); the tail writes the
// norm, the counters, the next flag and c
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_update_kernel(double* __restrict__ st, T* __restrict__ part, unsigned* ticket,
                     T* __restrict__ r, const T* __restrict__ ap, const T* __restrict__ w,
                     const T* __restrict__ kw_inv, long long n, int m, int kd, int start) {
  __shared__ T sh[kThreads];
  __shared__ T skw[kMaxDefl * kMaxDefl];
  const int t = threadIdx.x;
  if (!__syncthreads_or(start || (t < m && st[t * kSlots + kRun] != 0.0))) return;
  const int R = row_slots(m), c = t % m, slot = t / m, lane = t & 31;
  const bool go = !start && st[c * kSlots + kRun] != 0.0;
  const T alpha = static_cast<T>(st[c * kSlots + kAlpha]);
  T rr = 0, wr = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * R; base < n;
       base += static_cast<long long>(gridDim.x) * R) {
    const long long row = base + slot;
    T rv = 0;
    if (slot < R && row < n) {
      const long long i = row * m + c;
      rv = r[i];
      if (go) {
        rv = sub_rn(rv, mul_rn(alpha, ap[i]));
        r[i] = rv;
      }
      rr += rv * rv;
    }
    if (kd) {  // m == 1: a warp holds 32 consecutive rows; lane j adds W[row, j] r[row]
      const long long first = base + (t & ~31);
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const T ri = __shfl_sync(kFull, rv, i);
        if (lane < kd && first + i < n) wr += w[(first + i) * kd + lane] * ri;
      }
    }
  }
  const int cols = kd ? 1 + kd : m;
  write_partials(sh, rr, m, part, cols, 0, m);
  if (kd) write_partials(sh, wr, 32, part, cols, 1, kd);  // lane j of each warp: column 1 + j
  if (!last_block(ticket)) return;
  sum_partials(sh, part, cols);
  if (t < m) {
    double* s = st + t * kSlots;
    if (start || s[kRun] != 0.0) {
      const double rn = static_cast<double>(sqrt_of(sh[t]));
      if (start) {
        const double bn = s[kBnorm];
        s[kK] = 0.0;
        s[kSince] = 0.0;
        s[kBest] = rn;
        s[kTol] = fmax(s[kRtol] * bn, s[kAtol]);
        s[kGate] = 1.0e-3 * bn;
        s[kRun] = 1.0;  // the start's (c) and (d) run whatever the test says
      } else {
        s[kK] += 1.0;
        s[kSince] = rn < 0.999 * s[kBest] ? 0.0 : s[kSince] + 1.0;
        s[kBest] = fmin(s[kBest], rn);
      }
      s[kRnorm] = rn;
      s[kNext] = cond_of(s);
    }
  }
  if (kd) {  // c = K_w^+ (W^T r), each entry a sum in column order
    for (int i = t; i < kd * kd; i += kThreads) skw[i] = kw_inv[i];
    __syncthreads();
    if (t < kd) {
      T acc = 0;
      for (int j = 0; j < kd; ++j) acc += skw[t * kd + j] * sh[1 + j];
      part[kScratchC + t] = acc;
    }
  }
}

// (c) z = z4 + W c (deflated), r.z; the tail writes beta and rz (start: rz)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_rz_kernel(double* __restrict__ st, T* __restrict__ part, unsigned* ticket,
                 const T* __restrict__ r, T* __restrict__ z, const T* __restrict__ w, long long n,
                 int m, int kd, int start) {
  __shared__ T sh[kThreads];
  const int t = threadIdx.x;
  if (!__syncthreads_or(start || (t < m && st[t * kSlots + kRun] != 0.0))) return;
  const int R = row_slots(m), c = t % m, slot = t / m, lane = t & 31;
  const bool go = start || st[c * kSlots + kRun] != 0.0;
  const T cl = (kd && lane < kd) ? __ldcg(part + kScratchC + lane) : T(0);
  T acc = 0;
  for (long long base = static_cast<long long>(blockIdx.x) * R; base < n;
       base += static_cast<long long>(gridDim.x) * R) {
    const long long row = base + slot;
    const bool in = slot < R && row < n;
    const long long i = row * m + c;
    T zv = in ? z[i] : T(0);
    if (kd) {  // m == 1: lane l gets (W c) of the warp's row l
      const long long first = base + (t & ~31);
      T v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k)
        v[k] = (lane < kd && first + k < n) ? w[(first + k) * kd + lane] * cl : T(0);
      zv = add_rn(zv, transpose_sum(v));
      if (in && go) z[i] = zv;
    }
    if (in) acc += r[i] * zv;
  }
  write_partials(sh, acc, m, part, m, 0, m);
  if (!last_block(ticket)) return;
  sum_partials(sh, part, m);
  if (t < m) {
    double* s = st + t * kSlots;
    const T rz_new = sh[t];
    if (start) {
      s[kRz] = static_cast<double>(rz_new);
    } else if (s[kRun] != 0.0) {
      const T rz = static_cast<T>(s[kRz]);
      s[kBeta] = static_cast<double>(rz_new / (rz == T(0) ? T(1) : rz));
      s[kRz] = static_cast<double>(rz_new);
    }
  }
}

// (d) x += alpha p, p = z + beta p, and the harvest's slot (start: slot 0
// alone)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    cg_direction_kernel(const double* __restrict__ st, const T* __restrict__ z,
                        T* __restrict__ x, T* __restrict__ p, T* __restrict__ zs,
                        T* __restrict__ coef, long long n, int m, int nstore, int start) {
  const int t = threadIdx.x;
  if (!__syncthreads_or(start || (t < m && st[t * kSlots + kRun] != 0.0))) return;
  const int R = row_slots(m), c = t % m, slot = t / m;
  const double* s = st + c * kSlots;
  const bool go = start || s[kRun] != 0.0;
  const T alpha = static_cast<T>(s[kAlpha]), beta = static_cast<T>(s[kBeta]);
  // the JAX package's slots: z and rz at min(k, cap), alpha and beta of the
  // step that made them at min(k - 1, cap), k already advanced by (b)
  const long long cap = nstore - 1;
  const long long k = start ? 0 : static_cast<long long>(st[kK]);
  const long long kz = k < cap ? k : cap, kc = k - 1 < cap ? k - 1 : cap;
  if (go && slot < R)
    for (long long row = static_cast<long long>(blockIdx.x) * R + slot; row < n;
         row += static_cast<long long>(gridDim.x) * R) {
      const long long i = row * m + c;
      const T zv = z[i];
      if (!start) {
        const T pv = p[i];
        x[i] = add_rn(x[i], mul_rn(alpha, pv));
        p[i] = add_rn(zv, mul_rn(beta, pv));
      }
      if (zs) zs[kz * n + row] = zv;  // m == 1
    }
  if (coef && blockIdx.x == 0 && t == 0) {  // rows rz, alpha, beta of (3, nstore)
    coef[kz] = static_cast<T>(st[kRz]);
    if (!start) {
      coef[nstore + kc] = static_cast<T>(st[kAlpha]);
      coef[2 * nstore + kc] = static_cast<T>(st[kBeta]);
    }
  }
}

// C interface: returns cudaGetLastError() after the launch (0 = launched);
// step 0-3 is pass (a)-(d); v is ap for (a) and (b), z for (c) and (d).
template <typename T>
int cg_pass(int step, int start, double* st, T* part, unsigned* ticket, T* x, T* r, T* p, T* v,
            const T* w, const T* kw_inv, T* zs, T* coef, long long n, int m, int kd, int nstore,
            void* stream) {
  if (m < 1 || m > kMaxCols || kd < 0 || kd > kMaxDefl || ((kd || zs || coef) && m != 1) ||
      n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = grid_of(n, m);
  switch (step) {
    case 0:
      cg_pap_kernel<T><<<grid, kThreads, 0, s>>>(st, part, ticket, p, v, n, m);
      break;
    case 1:
      cg_update_kernel<T><<<grid, kThreads, 0, s>>>(st, part, ticket, r, v, w, kw_inv, n, m,
                                                    kd, start);
      break;
    case 2:
      cg_rz_kernel<T><<<grid, kThreads, 0, s>>>(st, part, ticket, r, v, w, n, m, kd, start);
      break;
    case 3:
      cg_direction_kernel<T><<<grid, kThreads, 0, s>>>(st, v, x, p, zs, coef, n, m, nstore,
                                                       start);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long fcvm_cg_scratch() { return kScratchC + kMaxDefl; }

extern "C" int fcvm_cg_pass_f32(int step, int start, double* st, float* part, unsigned* ticket,
                                float* x, float* r, float* p, float* v, const float* w,
                                const float* kw_inv, float* zs, float* coef, long long n, int m,
                                int kd, int nstore, void* stream) {
  return cg_pass<float>(step, start, st, part, ticket, x, r, p, v, w, kw_inv, zs, coef, n, m, kd,
                        nstore, stream);
}

extern "C" int fcvm_cg_pass_f64(int step, int start, double* st, double* part, unsigned* ticket,
                                double* x, double* r, double* p, double* v, const double* w,
                                const double* kw_inv, double* zs, double* coef, long long n,
                                int m, int kd, int nstore, void* stream) {
  return cg_pass<double>(step, start, st, part, ticket, x, r, p, v, w, kw_inv, zs, coef, n, m,
                         kd, nstore, stream);
}
