// A measurement probe, not a kernel of the solver: K8 under other schedules.
//
// The same sums as K8 (csrc/segment_sum.cu), from the same kernels, with
// the template parameters its schedule fixes set otherwise: the register
// path with K = 3, 9 or 24 columns a thread (each node segment's whole row
// in registers, each order entry read once), for the write form; the ring
// path with 2 or 8 slots of up to 32 rows, or 4 slots of up to 16 or 8 rows,
// for the accumulating form.  Every one keeps the plan's order of adds, so
// each gives K8's bits.  Built on its own by
// fcvm_tpu_torch/tools/k8_schedule.py (nvcc, plain C interface, ctypes),
// which times it against K8 on the card; the solver never loads it.

#include <cuda_runtime.h>

#include "segment_sum.cu"

namespace {

template <typename T>
int register_variant(const T* vals, const Plan& plan, T* out, int columns, cudaStream_t s) {
  switch (columns) {
    case 3: return launch_register<T, true, 3>(vals, plan, out, s);
    case 9: return launch_register<T, true, 9>(vals, plan, out, s);
    case 24: return launch_register<T, true, 24>(vals, plan, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr long long kMaxSharedBytes = 227 * 1024;  // a block's dynamic shared memory on sm_90

// -1 where the ring does not fit a block's shared memory.
template <typename T>
int ring_variant(const T* vals, const Plan& plan, T* out, int slots, int rows, cudaStream_t s) {
  const long long row_bytes = plan.w * static_cast<long long>(sizeof(T));
  const long long smem = slots * (rows == 32   ? stage_rows<32>(row_bytes)
                                  : rows == 16 ? stage_rows<16>(row_bytes)
                                               : stage_rows<8>(row_bytes)) * row_bytes;
  if (smem > kMaxSharedBytes) return -1;
  if (slots == 2 && rows == 32) return launch_ring<T, false, 2, 32>(vals, plan, out, s);
  if (slots == 8 && rows == 32) return launch_ring<T, false, 8, 32>(vals, plan, out, s);
  if (slots == 4 && rows == 16) return launch_ring<T, false, 4, 16>(vals, plan, out, s);
  if (slots == 4 && rows == 8) return launch_ring<T, false, 4, 8>(vals, plan, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// columns > 1: the write form, every segment on the register path (nlong 0),
// K = columns.  Otherwise the accumulating form, its first nlong segments
// on a ring of `slots` slots of up to `rows` rows, the rest as in K8.
template <typename T>
int probe_run(const T* vals, const int* order, const int* walk, const int* holes, T* out,
              long long nu, long long nlong, long long nholes, long long w, int columns,
              int slots, int rows, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  Plan plan{};
  const bool write = columns > 1;
  if (!make_plan(order, walk, holes, nu, nlong, nholes, w, write, &plan) ||
      (write && (nlong != 0 || w % columns != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (write) return register_variant<T>(vals, plan, out, columns, s);
  if (nlong > 0) {
    const int err = ring_variant<T>(vals, plan, out, slots, rows, s);
    if (err != 0) return err;
  }
  return launch_register<T, false>(vals, plan, out, s);
}

}  // namespace

extern "C" int fcvm_k8_probe_f32(const float* vals, const int* order, const int* walk,
                                 const int* holes, float* out, long long nu, long long nlong,
                                 long long nholes, long long w, int columns, int slots, int rows,
                                 void* stream) {
  return probe_run<float>(vals, order, walk, holes, out, nu, nlong, nholes, w, columns, slots,
                          rows, stream);
}

extern "C" int fcvm_k8_probe_f64(const double* vals, const int* order, const int* walk,
                                 const int* holes, double* out, long long nu, long long nlong,
                                 long long nholes, long long w, int columns, int slots, int rows,
                                 void* stream) {
  return probe_run<double>(vals, order, walk, holes, out, nu, nlong, nholes, w, columns, slots,
                           rows, stream);
}
