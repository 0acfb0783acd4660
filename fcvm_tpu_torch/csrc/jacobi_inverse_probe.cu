// A measurement probe, not a kernel of the solver: K5 with its threads
// taking a given table of units.
//
// The same rebuild as K5 (csrc/jacobi_inverse.cu), from the same kernel,
// with each thread's unit (its begin and end in the plan's order and its
// row) read from a (3, nu) table in the order the table gives: the plan's
// walk (longest first) or any other permutation of the units.  Each node's
// adds keep the plan's order, so every table gives K5's bits.  Built on its
// own by fcvm_tpu_torch/tools/k3_probe.py (nvcc, plain C interface,
// ctypes), which times it against K5's row order on the card; the solver
// never loads it.

#include <cuda_runtime.h>

#include "jacobi_inverse.cu"

namespace {

template <typename T>
int walk_run(int form, const T* diag, const int* order, const int* walk, const int* holes,
             long long nu, long long nholes, long long ne, const long long* cols,
             const T* fixmask, T* out, void* stream) {
  const Args<T> a{diag, order, nullptr, nullptr, holes, walk,
                  nu,   nholes, ne,     cols,    fixmask, nullptr, out};
  return run<T, true>(form, a, stream);
}

}  // namespace

// form 0 (fused) or 1 (sum); walk (3, nu) int32: the units in the order the
// threads take them.
extern "C" int fcvm_k5_probe_f32(int form, const float* diag, const int* order, const int* walk,
                                 const int* holes, long long nu, long long nholes, long long ne,
                                 const long long* cols, const float* fixmask, float* out,
                                 void* stream) {
  return walk_run<float>(form, diag, order, walk, holes, nu, nholes, ne, cols, fixmask, out,
                         stream);
}

extern "C" int fcvm_k5_probe_f64(int form, const double* diag, const int* order,
                                 const int* walk, const int* holes, long long nu,
                                 long long nholes, long long ne, const long long* cols,
                                 const double* fixmask, double* out, void* stream) {
  return walk_run<double>(form, diag, order, walk, holes, nu, nholes, ne, cols, fixmask, out,
                          stream);
}
