// A measurement probe, not a kernel of the solver: K1's atomic variant.
//
// The same K_hat·v as K1 (csrc/khat_matvec.cu), masked form, in one pass
// over the elements that adds each element row straight into the zeroed
// output with red.global.add (atomicAdd, its result unused), then the mask
// pass.  It skips K1's (30, ne) element output and its node pass, at the
// price of sums whose order changes from run to run.  Built on its own by
// fcvm_tpu_torch/tools/k1_atomic.py (nvcc, plain C interface, ctypes), which
// times it against K1 on the card; the solver never loads it.

#include <cuda_runtime.h>

#include "khat_matvec.cu"

namespace {

// y[3 node + c] += v for element e's row i = 3 slot + c.
template <typename T>
struct AtomicStore {
  const int* __restrict__ elnodes_t;
  T* __restrict__ y;

  __device__ __forceinline__ void operator()(int i, long long e, long long ne, T v) const {
    atomicAdd(y + 3LL * elnodes_t[(i / 3) * ne + e] + i % 3, v);
  }
};

template <typename T>
__global__ void mask_kernel(const T* __restrict__ x, const T* __restrict__ fixmask,
                            T* __restrict__ y, long long n) {
  const long long d = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (d < n) y[d] = fixmask[d] * y[d] + (T(1) - fixmask[d]) * x[d];
}

template <typename T>
int atomic_run(const T* esm_t, const int* elnodes_t, const T* x, const T* fixmask, T* y,
               long long ne, long long nn, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(y, 0, 3 * nn * sizeof(T), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = fcvm_element::launch<T>(esm_t, GatherU<T, true>{elnodes_t, x, fixmask},
                                         AtomicStore<T>{elnodes_t, y}, ne, stream);
  if (rc != 0) return rc;
  const long long n = 3 * nn;
  mask_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(x, fixmask, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fcvm_khat_atomic_f32(const float* esm_t, const int* elnodes_t, const float* x,
                                    const float* fixmask, float* y, long long ne, long long nn,
                                    void* stream) {
  return atomic_run<float>(esm_t, elnodes_t, x, fixmask, y, ne, nn, stream);
}

extern "C" int fcvm_khat_atomic_f64(const double* esm_t, const int* elnodes_t,
                                    const double* x, const double* fixmask, double* y,
                                    long long ne, long long nn, void* stream) {
  return atomic_run<double>(esm_t, elnodes_t, x, fixmask, y, ne, nn, stream);
}
