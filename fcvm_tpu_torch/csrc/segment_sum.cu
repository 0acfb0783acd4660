// K8: the fixed-order segment sum, for Hopper (sm_90a).
//
// Replaces the node reductions of the JAX package: the ScatterPlan's
// fcvm_tpu/ops/assembly.py::scatter_node_rows (a gather of each node's
// incident rows, summed in a fixed order) and jax.ops.segment_sum
// (fcvm_tpu/ops/stress_update.py:151-157 and the loads, the block-Jacobi
// rebuild, the coarse Galerkin table).  It computes, in place,
//
//     out[segs[u], c] += sum_{p = offsets[u]}^{offsets[u+1]-1} vals[order[p], c]
//
// for vals (n, w) and out (nseg, w), row-major, with the plan (order,
// offsets, segs) built once by a stable sort of the rows' keys; rows of out
// that no key names keep their value.  Each sum starts from out's value and
// adds the rows in plan order, as a sequential index_add_ does.
// What bounds it: bytes; it reads vals and the plan once and reads and
// writes the touched rows of out once (no arithmetic to speak of).  One
// thread a (segment, column), neighbouring threads on neighbouring columns of
// one segment, so a wide row (the coarse table's 144 columns) is read
// coalesced; the sums are fcvm_segment::gather_sum, K1's node pass.  No
// atomics: every output value is written by one thread, so two calls give
// the same bits.
//
// C interface: returns cudaGetLastError() after the launch (0 = launched).
// The caller owns all memory and the stream; nothing here synchronises.
// csrc/ops.cpp binds it as torch.ops.fcvm.segment_sum.

#include <cuda_runtime.h>

#include "segment.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ vals, const int* __restrict__ order,
                   const int* __restrict__ offsets, const int* __restrict__ segs,
                   T* __restrict__ out, long long nu, long long w) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= nu * w) return;
  const long long u = t / w, c = t - u * w;
  T* dst = out + segs[u] * w + c;
  T s[1] = {*dst};
  fcvm_segment::gather_sum<T, 1>(s, vals + c, order, offsets[u], offsets[u + 1], w, 0);
  *dst = s[0];
}

template <typename T>
int run(const T* vals, const int* order, const int* offsets, const int* segs, T* out,
        long long nu, long long w, void* stream) {
  if (nu <= 0 || w <= 0) return 0;
  const long long blocks = (nu * w + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  segment_sum_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(vals, order, offsets, segs,
                                                               out, nu, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fcvm_segment_sum_f32(const float* vals, const int* order, const int* offsets,
                                    const int* segs, float* out, long long nu, long long w,
                                    void* stream) {
  return run<float>(vals, order, offsets, segs, out, nu, w, stream);
}

extern "C" int fcvm_segment_sum_f64(const double* vals, const int* order, const int* offsets,
                                    const int* segs, double* out, long long nu, long long w,
                                    void* stream) {
  return run<double>(vals, order, offsets, segs, out, nu, w, stream);
}
