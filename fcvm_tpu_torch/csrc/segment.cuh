// The fixed-order gather-sum shared by K1's node pass (khat_matvec.cu) and
// K8 (segment_sum.cu): an output row's sum over its incidences, in the order
// of a CSR built once with a stable sort (the JAX package's ScatterPlan
// order), with no atomics, so two runs give the same bits.

#pragma once

namespace fcvm_segment {

// s[c] += src[idx[p] * row_stride + c * col_stride] for p = begin .. end - 1
// in that order, c = 0 .. K - 1.  Two incidences' loads are issued before
// their adds, which keeps the order of the adds.
template <typename T, int K>
__device__ __forceinline__ void gather_sum(T (&s)[K], const T* __restrict__ src,
                                           const int* __restrict__ idx, int begin, int end,
                                           long long row_stride, long long col_stride) {
  int p = begin;
  for (; p + 1 < end; p += 2) {
    const T* a = src + idx[p] * row_stride;
    const T* b = src + idx[p + 1] * row_stride;
    T va[K], vb[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      va[c] = a[c * col_stride];
      vb[c] = b[c * col_stride];
    }
#pragma unroll
    for (int c = 0; c < K; ++c) s[c] = (s[c] + va[c]) + vb[c];
  }
  if (p < end) {
    const T* a = src + idx[p] * row_stride;
#pragma unroll
    for (int c = 0; c < K; ++c) s[c] += a[c * col_stride];
  }
}

}  // namespace fcvm_segment
