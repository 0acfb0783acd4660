// The element pass over packed symmetric blocks, shared by K1
// (khat_matvec.cu) and K1m (khat_matmat.cu).
//
// A block's packed copy is its upper triangle i <= j, 465 values in
// row-major order (ops/kernels.py::pack_blocks); the kernels stream it in
// stages of kRows packed entries through a ring of shared-memory slots,
// each with a full mbarrier (the stage's bytes landed) and an empty one
// (every consumer warp is done with the slot).  A consumer thread keeps an
// element's 30 input values u and 30 sums y in registers and, for each
// packed entry k = K[i][j], adds k u_j to y_i and, off the diagonal, k u_i
// to y_j; the entry indices are compile-time, so the 60 values never leave
// the registers.  Each sum takes its entries in packed order, so two runs
// give the same bits.

#pragma once

#include <cstdint>
#include <utility>

#include "bulk.cuh"

namespace fcvm_packed {

constexpr int kNodes = 10;                // tet10
constexpr int kDofs = 30;
constexpr int kPacked = 465;              // 30 * 31 / 2 entries a block
constexpr int kRows = 31;                 // packed entries a stage
constexpr int kStages = kPacked / kRows;  // 15 stages a block
static_assert(kStages * kRows == kPacked, "a block is a whole number of stages");

// Packed entry q -> its row i and column j (i <= j, row-major).
__host__ __device__ constexpr int entry_row(int q) {
  int i = 0;
  while (q >= kDofs - i) q -= kDofs - i++;
  return i;
}
__host__ __device__ constexpr int entry_col(int q) {
  int i = 0;
  while (q >= kDofs - i) q -= kDofs - i++;
  return i + q;
}

template <int kI, int kJ, typename T>
__device__ __forceinline__ void entry(T k, T (&y)[kDofs], const T (&u)[kDofs]) {
  y[kI] = fma(k, u[kJ], y[kI]);
  if constexpr (kI != kJ) y[kJ] = fma(k, u[kI], y[kJ]);
}

// The kRows entries of stage kS, in order, from a slot of the ring whose
// entry r of this thread's element sits at slot[r * kStride].
template <int kS, int kStride, typename T, int... kR>
__device__ __forceinline__ void stage_sum(const T* slot, T (&y)[kDofs], const T (&u)[kDofs],
                                          std::integer_sequence<int, kR...>) {
  (entry<entry_row(kS * kRows + kR), entry_col(kS * kRows + kR)>(slot[kR * kStride], y, u),
   ...);
}

struct Ring {
  uint64_t* full;   // kSlots: the stage's bytes have landed
  uint64_t* empty;  // kSlots: every consumer warp is done with the slot
};

// A consumer's whole block, stage by stage: wait for the slot, sum its
// entries, release the slot (one arrival a warp).  k0 is the block's first
// stage in the ring's sequence; a slot holds kRows rows of kStride values
// and this thread's element sits at offset `lane` in each.
template <int kStride, int kSlots, typename T, int... kS>
__device__ __forceinline__ void block_sum(const T* ring, Ring bars, long long k0, int lane,
                                          T (&y)[kDofs], const T (&u)[kDofs],
                                          std::integer_sequence<int, kS...>) {
  const auto one = [&](auto stage) {
    constexpr int s = decltype(stage)::value;
    const long long k = k0 + s;
    const int slot = static_cast<int>(k % kSlots);
    fcvm_bulk::mbar_wait(bars.full + slot, static_cast<uint32_t>((k / kSlots) & 1));
    stage_sum<s, kStride>(ring + slot * kRows * kStride + lane, y, u,
                          std::make_integer_sequence<int, kRows>{});
    __syncwarp();
    if ((threadIdx.x & 31) == 0) fcvm_bulk::mbar_arrive(bars.empty + slot);
  };
  (one(std::integral_constant<int, kS>{}), ...);
}

// The same sums on kPer columns of one element (K1m): each packed entry
// read once from shared memory feeds 2 kPer FMAs, and each column's sums
// take the entries in packed order, as entry() does.
template <int kI, int kJ, int kPer, typename T>
__device__ __forceinline__ void entry_cols(T k, T (&y)[kPer][kDofs], const T (&u)[kPer][kDofs]) {
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    y[c][kI] = fma(k, u[c][kJ], y[c][kI]);
    if constexpr (kI != kJ) y[c][kJ] = fma(k, u[c][kI], y[c][kJ]);
  }
}

template <int kS, int kStride, int kPer, typename T, int... kR>
__device__ __forceinline__ void stage_sum_cols(const T* slot, T (&y)[kPer][kDofs],
                                               const T (&u)[kPer][kDofs],
                                               std::integer_sequence<int, kR...>) {
  (entry_cols<entry_row(kS * kRows + kR), entry_col(kS * kRows + kR), kPer>(
       slot[kR * kStride], y, u),
   ...);
}

// block_sum on kPer columns, a slot kSlotVals values whose entry r of this
// thread's element sits at slot[lane + r kStride]; the slots are released
// only where `release` (K1m walks a resident sub-tile once for each chunk
// of columns and releases it after the last).
template <int kStride, int kSlotVals, int kSlots, int kPer, typename T, int... kS>
__device__ __forceinline__ void block_sum_cols(const T* ring, Ring bars, long long k0, int lane,
                                               T (&y)[kPer][kDofs], const T (&u)[kPer][kDofs],
                                               bool release, std::integer_sequence<int, kS...>) {
  const auto one = [&](auto stage) {
    constexpr int s = decltype(stage)::value;
    const long long k = k0 + s;
    const int slot = static_cast<int>(k % kSlots);
    fcvm_bulk::mbar_wait(bars.full + slot, static_cast<uint32_t>((k / kSlots) & 1));
    stage_sum_cols<s, kStride, kPer>(ring + slot * kSlotVals + lane, y, u,
                                     std::make_integer_sequence<int, kRows>{});
    if (release) {
      __syncwarp();
      if ((threadIdx.x & 31) == 0) fcvm_bulk::mbar_arrive(bars.empty + slot);
    }
  };
  (one(std::integral_constant<int, kS>{}), ...);
}

}  // namespace fcvm_packed
