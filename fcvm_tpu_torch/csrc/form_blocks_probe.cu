// A measurement probe, not a kernel of the solver: K3 in other layouts.
//
// The same blocks as K3 (csrc/form_blocks.cu), from its stages 0 and 1
// (geometry), in layouts its production kernel does not take:
//   - K3's node pairs with stage 0 (the gather of each element's nodes into
//     shared memory) in every form and dtype, or in none;
//   - the column layout: five threads an element, thread c taking node
//     columns c and 9 - c (11 pairs each), forming D_g B_b once a column and
//     Gauss point and holding it, in registers, across the column's pairs
//     (a fifth of the pairs' arithmetic), at 16, 32 or 64 elements a block
//     and the blocks an SM its __launch_bounds__ asks for (so its register
//     bound); with its Gauss points split over two lanes (each holding
//     D_g B_b at two of them, the first lane's partial sum handed to the
//     second by a shuffle, so the order of the adds is K3's); with its
//     outputs staged in shared memory and written by a pass of their own;
//     and, for the measurement, in modes that leave out stage 2's stores, its
//     arithmetic, or the whole of stage 2.
// Every layout sums each value in K3's order, so each gives K3's bits.
// Built on its own by fcvm_tpu_torch/tools/k3_probe.py (nvcc, plain C
// interface, ctypes), which times it against K3 on the card; the solver
// never loads it.

#include <cuda_runtime.h>

#include "form_blocks.cu"

namespace {

constexpr int kCols = 5;                 // column pairs an element: c and 9 - c
constexpr int kSmallShared = 48 * 1024;  // above: the launch asks for it

// A column layout: kE elements a block; kStage: stage 0 gathers the nodes;
// kMinBlocks: the blocks an SM its __launch_bounds__ asks for; kHalves: the
// threads an element's column pair takes; kOut: outputs staged in shared
// memory; kMode: 0 the blocks, 1 stage 2's arithmetic without its stores, 2
// its stores of zeros without its arithmetic, 3 stages 0 and 1 alone.
template <int kE_, bool kStage_, int kMinBlocks_, int kHalves_, bool kOut_ = false,
          int kMode_ = 0>
struct Tile {
  static constexpr int kE = kE_, kMinBlocks = kMinBlocks_, kHalves = kHalves_, kMode = kMode_;
  static constexpr bool kStage = kStage_, kOut = kOut_;
  static constexpr int kThreads = kCols * kHalves * kE;
  // with two halves in a warp (Gauss points 0, 1 and 2, 3) the rows padded so
  // that the halves' float reads fall in other banks
  static constexpr int kStride = kE + (kHalves == 2 ? 4 : 0);
};

// the block's shared memory, in values of T
template <typename T, int kForm, typename S>
constexpr long long shared_values() {
  return kTable + static_cast<long long>(kGauss) * (3 * kNodes + dq_values(kForm)) * S::kStride +
         3 * kNodes * S::kE + (S::kOut ? (kNPack + kNodes * kDiag) * S::kE : 0);
}

// K3's Out, or with ob the upper values and sectors into shared memory,
// ob[q kE] and sec[slot 8 kE]
template <typename T, int kE>
struct ColumnOut {
  Out<T> out;
  T* ob;
  T* sec;

  __device__ __forceinline__ T store(int i, int j, T x) const {
    if (!ob) return out.store(i, j, x);
    if (out.a.weights) x *= out.w;
    ob[packed_index(i, j) * kE] = out.real ? x : T(0);
    return x;
  }

  __device__ __forceinline__ void sector(int slot, const T (&d)[kDiag]) const {
    if (!ob) return out.sector(slot, d);
#pragma unroll
    for (int q = 0; q < kDiag; ++q) sec[slot * kDiag * kE + q] = d[q];
  }
};

// 16 bytes of T
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

// ((0 + x_0) + x_1) + ... over this thread's Gauss points; with two halves
// the first half's partial sum goes to the second (lane ^ 1), which adds its
// own: every value is the same sum in the same order as with one thread
template <int kHalves, typename T, int kG>
__device__ __forceinline__ T gauss_sum(const T (&x)[kG]) {
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < kG; ++j) acc += x[j];
  if (kHalves == 2) {
    acc = __shfl_xor_sync(0xffffffffu, acc, 1);
#pragma unroll
    for (int j = 0; j < kG; ++j) acc += x[j];
  }
  return acc;
}

template <typename T, int kForm, typename S>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks) column_kernel(const Args<T> a) {
  constexpr int kE = S::kE, kThreadsB = S::kThreads, kP = S::kStride, kH = S::kHalves;
  constexpr int kG = kGauss / kH;  // the Gauss points a thread takes
  constexpr int kDq = dq_values(kForm);
  extern __shared__ __align__(16) unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  T* dx = tab + kTable;
  T* dq = dx + kGauss * 3 * kNodes * kP;
  T* xs = dq + kGauss * kDq * kP;
  T* ob = xs + 3 * kNodes * kE;  // kOut: [q][lane], then [slot][lane][8]
  T* obd = ob + kNPack * kE;
  for (int i = threadIdx.x; i < kTable; i += kThreadsB) tab[i] = static_cast<T>(kDshp[i]);
  const long long e0 = static_cast<long long>(blockIdx.x) * kE;
  geometry<T, kForm, kE, kP, S::kStage, kThreadsB>(a, tab, dx, dq, xs, e0);
  if (S::kMode == 3) return;

  // 2. columns c and 9 - c of the lane's element, this thread's Gauss points
  const int c = threadIdx.x / (kH * kE), lane = threadIdx.x % (kH * kE) / kH;
  const int half = threadIdx.x % kH, g0 = half * kG;
  const long long e = e0 + lane;
  // the thread that holds the sums and stores them; lanes past the padded
  // tiles store nothing but take part in the halves' exchange
  const bool last = half == kH - 1 && e < a.npad;
  const ColumnOut<T, kE> out{Out<T>(a, e), S::kOut ? ob + lane : nullptr,
                             S::kOut ? obd + lane * kDiag : nullptr};
  const T* dxl = dx + g0 * 3 * kNodes * kP + lane;
  const T* dql = dq + g0 * kDq * kP + lane;
  T sink = T(0);  // kMode 1: the values, summed in place of their stores
#pragma unroll 1
  for (int col = 0; col < 2; ++col) {
    const int nb = col == 0 ? c : kNodes - 1 - c;
    T sec[kDiag] = {};
    if (kForm == kGeometric) {
      T sdb[kG][3];  // sigma_g dN_b
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        T db[3], s[6];
#pragma unroll
        for (int i = 0; i < 3; ++i) db[i] = dxl[(j * 3 * kNodes + 3 * nb + i) * kP];
#pragma unroll
        for (int v = 0; v < 6; ++v) s[v] = dql[(j * kDq + v) * kP];
        const T st[3][3] = {{s[0], s[3], s[4]}, {s[3], s[1], s[5]}, {s[4], s[5], s[2]}};
#pragma unroll
        for (int i = 0; i < 3; ++i) sdb[j][i] = st[i][0] * db[0] + st[i][1] * db[1] +
                                                st[i][2] * db[2];
      }
#pragma unroll 1
      for (int na = 0; na <= nb; ++na) {
        T m[kG];
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          m[j] = T(0);
#pragma unroll
          for (int i = 0; i < 3; ++i) m[j] += dxl[(j * 3 * kNodes + 3 * na + i) * kP] * sdb[j][i];
        }
        const T acc = S::kMode == 2 ? T(0) : gauss_sum<kH>(m);
        if (S::kMode == 1) sink += acc;
        if (last && S::kMode != 1) {
#pragma unroll
          for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              if (na == nb && q < r) continue;
              const T x = out.store(3 * na + r, 3 * nb + q, r == q ? acc : T(0));
              if (na == nb) sec[upper3(r, q)] = x;
            }
        }
      }
    } else {
      T dbm[kG][6][3];  // D_g B_b at this thread's Gauss points, once a column
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        T db[3], d[21];
#pragma unroll
        for (int i = 0; i < 3; ++i) db[i] = dxl[(j * 3 * kNodes + 3 * nb + i) * kP];
#pragma unroll
        for (int u = 0; u < 21; ++u) d[u] = dql[(j * 21 + u) * kP];
        auto sym = [&d](int k, int l) { return k <= l ? d[upper6(k, l)] : d[upper6(l, k)]; };
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          dbm[j][k][0] = sym(k, 0) * db[0] + sym(k, 3) * db[1] + sym(k, 4) * db[2];
          dbm[j][k][1] = sym(k, 1) * db[1] + sym(k, 3) * db[0] + sym(k, 5) * db[2];
          dbm[j][k][2] = sym(k, 2) * db[2] + sym(k, 4) * db[0] + sym(k, 5) * db[1];
        }
      }
#pragma unroll 1
      for (int na = 0; na <= nb; ++na) {
        T da[kG][3];
#pragma unroll
        for (int j = 0; j < kG; ++j)
#pragma unroll
          for (int i = 0; i < 3; ++i) da[j][i] = dxl[(j * 3 * kNodes + 3 * na + i) * kP];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) {
            if (na == nb && cc < r) continue;  // the diagonal block's lower half: its mirror
            T x[kG];
#pragma unroll
            for (int j = 0; j < kG; ++j) {
              if (r == 0)
                x[j] = da[j][0] * dbm[j][0][cc] + da[j][1] * dbm[j][3][cc] +
                       da[j][2] * dbm[j][4][cc];
              if (r == 1)
                x[j] = da[j][1] * dbm[j][1][cc] + da[j][0] * dbm[j][3][cc] +
                       da[j][2] * dbm[j][5][cc];
              if (r == 2)
                x[j] = da[j][2] * dbm[j][2][cc] + da[j][0] * dbm[j][4][cc] +
                       da[j][1] * dbm[j][5][cc];
            }
            const T acc = S::kMode == 2 ? T(0) : gauss_sum<kH>(x);
            if (S::kMode == 1) sink += acc;
            if (last && S::kMode != 1) {
              const T v = out.store(3 * na + r, 3 * nb + cc, acc);
              if (na == nb) sec[upper3(r, cc)] = v;
            }
          }
      }
    }
    if (last && S::kMode != 1) out.sector(nb, sec);
  }
  if (S::kMode == 1 && sink == T(-1.25e-30)) a.diag[0] = sink;  // keeps the arithmetic
  if (!S::kOut || S::kMode == 1) return;

  // 3. kOut: the tile's outputs from shared memory (packed rows in 16-byte
  //    words, element-major rows, the diagonal's sectors)
  __syncthreads();
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const int tile = static_cast<int>(a.tile);
  if (a.packed) {
    T* base = a.packed + (e0 / tile) * kNPack * tile + e0 % tile;
    for (int i = threadIdx.x; i < kNPack * (kE / kV); i += kThreadsB) {
      const int q = i / (kE / kV), m = i % (kE / kV) * kV;
      copy16(base + q * tile + m, ob + q * kE + m);
    }
  }
  const int live = a.ne - e0 < kE ? static_cast<int>(a.ne - e0) : kE;
  if (a.full) {
    for (int i = threadIdx.x; i < 900 * kE; i += kThreadsB) {
      const int ij = i / kE, l = i % kE, r = ij / 30, q = ij % 30;
      const int u = r <= q ? packed_index(r, q) : packed_index(q, r);
      if (l < live) a.full[ij * a.ne + e0 + l] = ob[u * kE + l];
    }
  }
  if (a.diag) {
    for (int i = threadIdx.x; i < kNodes * kE * (kDiag / kV); i += kThreadsB) {
      const int slot = i / (kE * (kDiag / kV)), l = i % (kE * (kDiag / kV)) / (kDiag / kV);
      const int m = i % (kDiag / kV) * kV;
      if (l < live) copy16(a.diag + (slot * a.ne + e0 + l) * kDiag + m,
                           obd + (slot * kE + l) * kDiag + m);
    }
  }
}

template <typename T, int kForm, typename S>
int column_launch(const Args<T>& a, unsigned grid, cudaStream_t s) {
  const auto kernel = column_kernel<T, kForm, S>;
  const int bytes = static_cast<int>(shared_values<T, kForm, S>() * sizeof(T));
  if (bytes > kSmallShared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, S::kThreads, bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K3's node pairs with stage 0 in every form (kStage) or in none
template <typename T, bool kStage>
int pairs_run(int form, const Args<T>& a, void* stream) {
  if (a.ne <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>((a.npad + kTile<T> - 1) / kTile<T>);
  if (form == kElastic)
    form_blocks_kernel<T, kElastic, kStage><<<grid, kThreads, 0, s>>>(a);
  else if (form == kTangent)
    form_blocks_kernel<T, kTangent, kStage><<<grid, kThreads, 0, s>>>(a);
  else if (form == kGeometric)
    form_blocks_kernel<T, kGeometric, kStage><<<grid, kThreads, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int column_run(int form, const Args<T>& a, void* stream) {
  if (a.ne <= 0) return 0;
  const long long blocks = (a.npad + S::kE - 1) / S::kE;
  if (blocks > 0x7fffffffLL || (a.packed && a.tile % S::kE != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid = static_cast<unsigned>(blocks);
  if (form == kElastic) return column_launch<T, kElastic, S>(a, grid, s);
  if (form == kTangent) return column_launch<T, kTangent, S>(a, grid, s);
  if (form == kGeometric) return column_launch<T, kGeometric, S>(a, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// variant: a row of fcvm_tpu_torch/tools/k3_probe.py's VARIANTS
template <typename T>
int variant_run(int variant, int form, const Args<T>& a, void* stream) {
  switch (variant) {
    case 0: return pairs_run<T, false>(form, a, stream);
    case 13: return pairs_run<T, true>(form, a, stream);
    case 1: return column_run<T, Tile<64, true, 1, 1>>(form, a, stream);
    case 2: return column_run<T, Tile<32, true, 3, 1>>(form, a, stream);
    case 3: return column_run<T, Tile<32, true, 1, 1>>(form, a, stream);
    case 4: return column_run<T, Tile<64, true, 2, 1>>(form, a, stream);
    case 5: return column_run<T, Tile<16, true, 3, 2>>(form, a, stream);
    case 6: return column_run<T, Tile<32, true, 2, 2>>(form, a, stream);
    case 7: return column_run<T, Tile<16, false, 3, 2>>(form, a, stream);
    case 8: return column_run<T, Tile<32, true, 2, 1, true>>(form, a, stream);
    case 9: return column_run<T, Tile<16, true, 2, 2, true>>(form, a, stream);
    case 10: return column_run<T, Tile<32, true, 3, 1, false, 1>>(form, a, stream);
    case 11: return column_run<T, Tile<32, true, 3, 1, false, 2>>(form, a, stream);
    case 12: return column_run<T, Tile<32, true, 3, 1, false, 3>>(form, a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fcvm_k3_probe_f32(int variant, int form, const float* coords, const float* disp,
                                 const int* table, long long nt, const long long* perm,
                                 const float* dmat, long long dstride, const float* sig,
                                 const unsigned char* pgp, const float* g, const float* h,
                                 double g3fac_s, const float* weights, float* full,
                                 float* packed, float* diag, long long ne, long long npad,
                                 long long tile, void* stream) {
  return variant_run<float>(variant, form,
                            args(coords, disp, table, nt, perm, dmat, dstride, sig, pgp, g, h,
                                 g3fac_s, weights, full, packed, diag, ne, npad, tile),
                            stream);
}

extern "C" int fcvm_k3_probe_f64(int variant, int form, const double* coords,
                                 const double* disp, const int* table, long long nt,
                                 const long long* perm, const double* dmat, long long dstride,
                                 const double* sig, const unsigned char* pgp, const double* g,
                                 const double* h, double g3fac_s, const double* weights,
                                 double* full, double* packed, double* diag, long long ne,
                                 long long npad, long long tile, void* stream) {
  return variant_run<double>(variant, form,
                             args(coords, disp, table, nt, perm, dmat, dstride, sig, pgp, g, h,
                                  g3fac_s, weights, full, packed, diag, ne, npad, tile),
                             stream);
}
