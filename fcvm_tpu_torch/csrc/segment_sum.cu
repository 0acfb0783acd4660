// K8: the fixed-order segment sum, for Hopper (sm_90a).
//
// Replaces the node reductions of the JAX package: the ScatterPlan and
// scatter_node_rows of fcvm_tpu/ops/assembly.py:324-397 (a gather of each
// node's incident rows, summed in a fixed order) and jax.ops.segment_sum in
// fcvm_tpu/ops/stress_update.py:151-157 (and in the loads, the block-Jacobi
// rebuild, the coarse Galerkin table).  For vals (n, w) and out (nout, w),
// row-major, and a plan built once from the rows' keys by a stable sort
// (ops/kernels.py::segment_plan), it computes
//
//     accumulate:  out[seg_u, c] += sum_{p in segment u} vals[order[p], c]
//     write:       out[seg_u, c]  = sum_{p in segment u} vals[order[p], c],
//                  and 0 in every row of out that no key names,
//
// each sum adding its rows one after another in plan order (ascending row)
// onto out's value or onto a register zero: the bits of a sequential
// index_add_ into out or into zeros, on every run.  No sum is split into
// partial sums and nothing is atomic.
//
// What bounds it: bytes.  It reads the summed rows of vals, the plan (order,
// and three ints a segment) and, accumulating, the touched rows of out, and
// writes those rows (writing: every row of out) once; no arithmetic to speak
// of.  A sum is a chain of dependent adds, so what the design answers is
// latency: keeping enough loads in flight while each chain keeps its order.
// The plan lists the segments longest first (its `walk`), and the wrapper
// splits that list by a threshold on rows x width:
//   1. the ring path, for the long segments of rows that are 16-byte
//      multiples at 16-byte aligned addresses (the coarse Galerkin table's
//      144-wide pair blocks, thousands of rows in one segment): a persistent
//      grid, each block summing whole segments, taken in a snake over the
//      longest-first list (block b: b, 2G - 1 - b, 2G + b, ...).  Warp 0
//      is the producer: its lanes copy one row each of a stage (up to 32
//      rows of one segment and 40 KB, in plan order) with cp.async.bulk into
//      a slot of a 4-slot shared-memory ring, each slot with a full mbarrier
//      (its bytes landed) and an empty one (every consumer warp is done with
//      it), an L2 evict-first hint on the rows, the next stage's order
//      entries loaded while the slot is awaited.  The other warps are
//      consumers, thread c owning column c: it adds the stage's rows in
//      order from the ring.  So one segment streams with up to a ring of
//      stages in flight (4 of 32 rows: 72 KB of 576-byte rows), and the
//      block moves on to its next segment without a pause;
//   2. the register path, for the rest: a persistent grid-stride over
//      (segment, column) units in the same longest-first order, so a warp's
//      chains have like lengths.  One thread a column, neighbouring threads
//      on neighbouring columns, so a warp's loads of a row are coalesced.  A
//      thread issues the loads of a batch of 8 rows before it adds them in
//      order (fcvm_segment::gather_sum).  The write form's rows that no key
//      names (the plan's `holes`) are zeroed by the same grid, after its
//      sums.
// The kernels take other ring shapes and K columns a register thread as
// template parameters; this file instantiates only the schedule above.
// csrc/segment_schedule_probe.cu instantiates the others for
// tools/k8_schedule.py, which times them against this schedule (PERF.md:
// none wins at most sites).
//
// C interface: returns a cudaError_t (0 = launched) after the launches;
// nlong, the segments on the ring path, is the caller's
// (ops/kernels.py::ring_groups, which owns the threshold and keeps the
// ring to rows it takes) and is checked here.  The caller owns all memory and
// the stream; nothing here synchronises.
// csrc/ops.cpp binds it as torch.ops.fcvm.segment_sum.

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk.cuh"
#include "ring.cuh"
#include "segment.cuh"

namespace {

constexpr int kThreads = 256;         // the register path's blocks
constexpr int kMaxThreads = 1024;     // a block's most: the ring path's rows take 31 warps at most
constexpr int kRingSlots = 4;         // the ring's slots
constexpr int kStageRows = 32;        // rows a stage at most: one a producer lane
constexpr int kStageBytes = 40 * 1024;
constexpr int kDepth = 8;             // rows a register batch

struct Plan {
  const int* order;  // (nsum,) value rows, each segment's in ascending row order
  const int* walk;   // (3, nu): each segment's begin and end in order, its output row
  const int* holes;  // (nholes,) the output rows no key names
  long long nu, nlong, nholes, w;
};

// Block b's r-th segment of G blocks in the longest-first list.
__device__ __forceinline__ long long snake(long long r, long long b, long long g) {
  return r * g + ((r & 1) ? g - 1 - b : b);
}

// Rows a ring stage for rows of `row_bytes`: kStageBytes' worth, 1 to kRows.
template <int kRows>
__host__ __device__ constexpr int stage_rows(long long row_bytes) {
  return kStageBytes / row_bytes < 1 ? 1 : kStageBytes / row_bytes > kRows
      ? kRows : static_cast<int>(kStageBytes / row_bytes);
}

// The ring path over segments [0, nlong), kSlots slots of stages of up to
// kRows rows.
template <typename T, bool kWrite, int kSlots = kRingSlots, int kRows = kStageRows>
__global__ void __launch_bounds__(kMaxThreads)
ring_kernel(const T* __restrict__ vals, const Plan plan, T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kSlots], empty[kSlots];
  T* const ring = reinterpret_cast<T*>(smem);
  const long long w = plan.w;
  const int lane = threadIdx.x & 31;
  const int rows = stage_rows<kRows>(w * static_cast<long long>(sizeof(T)));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      fcvm_bulk::mbar_init(full + s, 1);
      fcvm_bulk::mbar_init(empty + s, blockDim.x / 32 - 1);
    }
    fcvm_bulk::fence_barrier_init();
  }
  __syncthreads();

  long long k = 0;  // the block's stages so far: stage k fills slot k % kSlots
  if (threadIdx.x < 32) {  // the producer warp
    const uint64_t policy = fcvm_bulk::evict_first_policy();
    const uint32_t row_bytes = static_cast<uint32_t>(w * sizeof(T));
    for (long long r = 0;; ++r) {
      const long long j = snake(r, blockIdx.x, gridDim.x);
      if (j >= plan.nlong) break;
      const int begin = plan.walk[j], end = plan.walk[plan.nu + j];
      int row = plan.order[lane < end - begin ? begin + lane : begin];
      for (int p = begin; p < end; p += rows, ++k) {
        const int n = min(rows, end - p), q = p + rows;
        const int next = q < end ? plan.order[lane < end - q ? q + lane : q] : 0;
        const int slot = static_cast<int>(k % kSlots);
        if (k >= kSlots)
          fcvm_bulk::mbar_wait(empty + slot, static_cast<uint32_t>((k / kSlots - 1) & 1));
        if (lane == 0) fcvm_bulk::mbar_expect_tx(full + slot, n * row_bytes);
        __syncwarp();
        if (lane < n) {
          fcvm_bulk::fence_proxy_async();  // the consumers' reads before the refill
          T* const dst = ring + (static_cast<long long>(slot) * rows + lane) * w;
          fcvm_bulk::bulk_copy_g2s_hint(dst, vals + static_cast<long long>(row) * w, row_bytes,
                                        full + slot, policy);
        }
        row = next;
      }
    }
    return;
  }

  const long long c = threadIdx.x - 32;  // this consumer's column
  for (long long r = 0;; ++r) {
    const long long j = snake(r, blockIdx.x, gridDim.x);
    if (j >= plan.nlong) break;
    const int begin = plan.walk[j], end = plan.walk[plan.nu + j];
    T* const dst = out + static_cast<long long>(plan.walk[2 * plan.nu + j]) * w + c;
    T s = T(0);
    if (!kWrite && c < w) s = *dst;
    for (int p = begin; p < end; p += rows, ++k) {
      const int n = min(rows, end - p);
      const int slot = static_cast<int>(k % kSlots);
      fcvm_bulk::mbar_wait(full + slot, static_cast<uint32_t>((k / kSlots) & 1));
      if (c < w) {
        const T* src = ring + static_cast<long long>(slot) * rows * w + c;
        if (n == kRows) {  // a whole stage: its loads issued ahead of the adds
#pragma unroll
          for (int i = 0; i < kRows; ++i) s += src[i * w];
        } else {
          for (int i = 0; i < n; ++i) s += src[i * w];
        }
      }
      __syncwarp();
      if (lane == 0) fcvm_bulk::mbar_arrive(empty + slot);
    }
    if (c < w) *dst = s;
  }
}

// The register path over segments [nlong, nu), K columns a thread, then the
// write form's holes.
template <typename T, bool kWrite, int K = 1>
__global__ void __launch_bounds__(kThreads)
register_kernel(const T* __restrict__ vals, const Plan plan, T* __restrict__ out) {
  const long long w = plan.w, groups = w / K;
  const long long nsum = (plan.nu - plan.nlong) * groups;
  const long long units = nsum + (kWrite ? plan.nholes * w : 0);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < units;
       t += stride) {
    if (t < nsum) {
      const long long u = t / groups, g = t - u * groups, j = plan.nlong + u;
      T* const dst = out + static_cast<long long>(plan.walk[2 * plan.nu + j]) * w + g * K;
      T s[K];
#pragma unroll
      for (int c = 0; c < K; ++c) s[c] = kWrite ? T(0) : dst[c];
      fcvm_segment::gather_sum<T, K, (K * sizeof(T) <= 96 ? kDepth : kDepth / 2)>(
          s, vals + g * K, plan.order, plan.walk[j], plan.walk[plan.nu + j], w, 1);
#pragma unroll
      for (int c = 0; c < K; ++c) dst[c] = s[c];
    } else {
      const long long z = t - nsum, h = z / w;
      out[static_cast<long long>(plan.holes[h]) * w + (z - h * w)] = T(0);
    }
  }
}

// Launches the ring path.  Its grid is the blocks resident at once (by the
// kernel's shared memory, which follows the row width), at most one a
// segment; the count is kept per device for the last width launched.
template <typename T, bool kWrite, int kSlots = kRingSlots, int kRows = kStageRows>
int launch_ring(const T* vals, const Plan& plan, T* out, cudaStream_t stream) {
  struct Resident {
    long long w;
    int blocks;
  };
  static Resident resident[fcvm_ring::kMaxDevices];
  const long long row_bytes = plan.w * static_cast<long long>(sizeof(T));
  const int threads = static_cast<int>(32 * (1 + (plan.w + 31) / 32));
  if (row_bytes % 16 != 0 || reinterpret_cast<uintptr_t>(vals) % 16 != 0 ||
      threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(kSlots * stage_rows<kRows>(row_bytes) * row_bytes);
  const auto kernel = ring_kernel<T, kWrite, kSlots, kRows>;
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return static_cast<int>(got);
  if (dev >= fcvm_ring::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev].w != plan.w) {
    int blocks = 0;
    const int err = fcvm_ring::resident_blocks(kernel, threads, smem, &blocks);
    if (err != 0) return err;
    resident[dev] = {plan.w, blocks};
  }
  const int grid = static_cast<int>(plan.nlong < resident[dev].blocks ? plan.nlong
                                                                      : resident[dev].blocks);
  kernel<<<grid, threads, static_cast<size_t>(smem), stream>>>(vals, plan, out);
  return static_cast<int>(cudaGetLastError());
}

// Launches the register path: the short segments and the write form's holes.
template <typename T, bool kWrite, int K = 1>
int launch_register(const T* vals, const Plan& plan, T* out, cudaStream_t stream) {
  const long long units = (plan.nu - plan.nlong) * (plan.w / K) + plan.nholes * plan.w;
  if (units <= 0) return 0;
  const auto kernel = register_kernel<T, kWrite, K>;
  static int resident[fcvm_ring::kMaxDevices];
  int grid = 0;
  const int err = fcvm_ring::persistent_grid(kernel, kThreads, 0, (units + kThreads - 1) / kThreads,
                                             resident, &grid);
  if (err != 0) return err;
  kernel<<<grid, kThreads, 0, stream>>>(vals, plan, out);
  return static_cast<int>(cudaGetLastError());
}

// The plan's arguments, checked; false where they do not hold.
inline bool make_plan(const int* order, const int* walk, const int* holes, long long nu,
                      long long nlong, long long nholes, long long w, bool write, Plan* plan) {
  if (w <= 0 || nlong < 0 || nlong > nu || nholes < 0 || (write && nholes > 0 && !holes))
    return false;
  *plan = Plan{order, walk, holes, nu, nlong, write ? nholes : 0, w};
  return true;
}

template <typename T, bool kWrite>
int run(const T* vals, const Plan& plan, T* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (plan.nlong > 0) {
    const int err = launch_ring<T, kWrite>(vals, plan, out, s);
    if (err != 0) return err;
  }
  return launch_register<T, kWrite>(vals, plan, out, s);
}

template <typename T>
int run(const T* vals, const int* order, const int* walk, const int* holes, T* out, long long nu,
        long long nlong, long long nholes, long long w, bool write, void* stream) {
  Plan plan{};
  if (!make_plan(order, walk, holes, nu, nlong, nholes, w, write, &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  return write ? run<T, true>(vals, plan, out, stream) : run<T, false>(vals, plan, out, stream);
}

}  // namespace

extern "C" int fcvm_segment_sum_f32(const float* vals, const int* order, const int* walk,
                                    const int* holes, float* out, long long nu, long long nlong,
                                    long long nholes, long long w, int write, void* stream) {
  return run<float>(vals, order, walk, holes, out, nu, nlong, nholes, w, write != 0, stream);
}

extern "C" int fcvm_segment_sum_f64(const double* vals, const int* order, const int* walk,
                                    const int* holes, double* out, long long nu, long long nlong,
                                    long long nholes, long long w, int write, void* stream) {
  return run<double>(vals, order, walk, holes, out, nu, nlong, nholes, w, write != 0, stream);
}
