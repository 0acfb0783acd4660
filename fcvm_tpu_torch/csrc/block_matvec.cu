// K0: batched 30x30 element-block matvec, element-major, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fcvm_tpu/ops/pallas_kernels.py::block_matvec
// (body _block_matvec_kernel).  It computes
//
//     out[i, e] = sum_j esm_t[i, j, e] * ue_t[j, e]
//
// with esm_t (30, 30, ne), ue_t (30, ne) and out (30, ne), all contiguous.
//
// The kernel is the element pass of csrc/element_pass.cuh (a persistent
// grid streaming the blocks through a cp.async ring), with the element's 30
// values read from ue_t, once a tile (the earlier design, three blocks of
// ten rows an element, read them three times).  What bounds it: reading
// esm_t from device memory.  On the H100 it reads at 73-77% of 3.35 TB/s in
// f32 and 79-85% in f64 at the paths' element counts; rows of 2 or 4 KB a
// copy, 6 slots, or K0p's thread over all 30 rows read no faster (PERF.md).
// K1 (csrc/khat_matvec.cu) runs the same element pass on gathered values;
// the solver's K_hat·v goes through K1, and K0 serves the bandwidth probe.
//
// C interface: returns cudaGetLastError() after the launch (0 = launched).
// The caller owns all memory and the stream; the kernel does not synchronise.
// csrc/ops.cpp binds it to PyTorch as torch.ops.fcvm.block_matvec.

#include <cuda_runtime.h>

#include "element_pass.cuh"

namespace {

// The element's 30 values from the dense (30, ne) array.
template <typename T>
struct DenseU {
  const T* __restrict__ ue_t;

  __device__ __forceinline__ void operator()(long long e, long long ne,
                                             T (&u)[fcvm_element::kDofs]) const {
#pragma unroll
    for (int j = 0; j < fcvm_element::kDofs; ++j) u[j] = ue_t[j * ne + e];
  }
};

}  // namespace

extern "C" int fcvm_block_matvec_f32(const float* esm_t, const float* ue_t,
                                     float* out, long long ne, void* stream) {
  return fcvm_element::launch<float>(esm_t, DenseU<float>{ue_t},
                                    fcvm_element::DenseStore<float>{out}, ne, stream);
}

extern "C" int fcvm_block_matvec_f64(const double* esm_t, const double* ue_t,
                                     double* out, long long ne, void* stream) {
  return fcvm_element::launch<double>(esm_t, DenseU<double>{ue_t},
                                     fcvm_element::DenseStore<double>{out}, ne, stream);
}
