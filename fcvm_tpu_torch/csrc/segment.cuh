// The fixed-order gather-sum shared by K1's node pass (khat_matvec.cu) and
// K8's register path (segment_sum.cu): an output row's sum over its
// incidences, in the order of a CSR built once with a stable sort (the JAX
// package's ScatterPlan order), with no atomics, so two runs give the same
// bits.

#pragma once

namespace fcvm_segment {

// s[c] += src[idx[p] * row_stride + c * col_stride] for p = begin .. end - 1
// in that order, c = 0 .. K - 1.  The loads of kDepth incidences are issued
// before their adds, which keeps the order of the adds.  A batch past the
// end reloads incidence `begin` (a valid row, read again from the L1) and
// adds nothing of it, so the loads carry no branch.
template <typename T, int K, int kDepth = 2>
__device__ __forceinline__ void gather_sum(T (&s)[K], const T* __restrict__ src,
                                           const int* __restrict__ idx, int begin, int end,
                                           long long row_stride, long long col_stride) {
  for (int p = begin; p < end; p += kDepth) {
    const int n = end - p;
    T v[kDepth][K];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const T* a = src + idx[d < n ? p + d : begin] * row_stride;
#pragma unroll
      for (int c = 0; c < K; ++c) v[d][c] = a[c * col_stride];
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (d < n) {
#pragma unroll
        for (int c = 0; c < K; ++c) s[c] += v[d][c];
      }
    }
  }
}

}  // namespace fcvm_segment
