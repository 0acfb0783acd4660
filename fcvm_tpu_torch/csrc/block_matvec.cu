// K0: batched 30x30 element-block matvec, element-major, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fcvm_tpu/ops/pallas_kernels.py::block_matvec
// (body _block_matvec_kernel).  It computes
//
//     out[i, e] = sum_j esm_t[i, j, e] * ue_t[j, e]
//
// with esm_t (30, 30, ne), ue_t (30, ne) and out (30, ne), all contiguous.
//
// What bounds it: every block entry is read once and used once (two flops per
// eight bytes in f64, per four in f32), so the kernel is bound by device-memory
// reads of esm_t.  The design keeps those reads coalesced and nothing else in
// the way:
//   * neighbouring threads take neighbouring elements, so each esm_t[i, j, :]
//     row is read as contiguous 128-byte (f32) or 256-byte (f64) warp loads;
//   * a thread keeps its element's 30 ue values in registers and produces
//     ROWS outputs, so ue is read 30 / ROWS times rather than 30 times, and
//     the grid has enough blocks (3 per 256 elements) to fill all SMs;
//   * the element count needs no padding: the ragged edge is bounds-checked
//     (the TPU kernel padded to 2048-element VMEM tiles).
// Sums accumulate in the input type; nothing is lowered in precision.
//
// C interface: returns cudaGetLastError() after the launch (0 = launched).
// The caller owns all memory and the stream; the kernel does not synchronise.
// csrc/ops.cpp binds it to PyTorch as torch.ops.fcvm.block_matvec.

#include <cuda_runtime.h>

namespace {

constexpr int kDofs = 30;         // 10 nodes x 3 components per tet10 element
constexpr int kRows = 10;         // output rows per thread (30 / kRows blocks in y)
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_matvec_kernel(const T* __restrict__ esm_t, const T* __restrict__ ue_t,
                    T* __restrict__ out, long long ne) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= ne) return;
  const int i0 = blockIdx.y * kRows;

  T u[kDofs];
#pragma unroll
  for (int j = 0; j < kDofs; ++j) u[j] = ue_t[j * ne + e];

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const T* row = esm_t + static_cast<long long>(i0 + r) * kDofs * ne + e;
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < kDofs; ++j) acc += row[j * ne] * u[j];
    out[(i0 + r) * ne + e] = acc;
  }
}

template <typename T>
int launch(const T* esm_t, const T* ue_t, T* out, long long ne, void* stream) {
  if (ne <= 0) return 0;
  const long long nblk = (ne + kThreads - 1) / kThreads;
  if (nblk > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(nblk), kDofs / kRows);
  block_matvec_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      esm_t, ue_t, out, ne);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fcvm_block_matvec_f32(const float* esm_t, const float* ue_t,
                                     float* out, long long ne, void* stream) {
  return launch<float>(esm_t, ue_t, out, ne, stream);
}

extern "C" int fcvm_block_matvec_f64(const double* esm_t, const double* ue_t,
                                     double* out, long long ne, void* stream) {
  return launch<double>(esm_t, ue_t, out, ne, stream);
}
