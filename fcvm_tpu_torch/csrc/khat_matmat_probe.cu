// A measurement probe, not a kernel of the solver: K1m with its element
// pass in a layout of the caller's choice.
//
// K1m (csrc/khat_matmat.cu) picks, for each dtype and chunk width, one of
// two layouts of its element pass (layout_of): collapse or direct.  This
// file runs either one at any width, with the node pass that reads its
// rows, so both can be timed in one process.  Both keep the packed order
// of every sum and K1's order of every node sum, so each gives K1m's bits.
// Built on its own by fcvm_tpu_torch/tools/k1m_layout.py (nvcc, plain C
// interface, ctypes); the solver never loads it.

#include <cuda_runtime.h>

#include "khat_matmat.cu"

// The rows of element output `layout` (0 collapse, 1 direct) writes.
extern "C" long long fcvm_k1m_probe_rows(int layout, long long ne, long long rows) {
  return layout == kDirect ? 10 * ne : rows;
}

// K1m's call (fcvm_khat_matmat_f32) with the element pass in `layout`:
// returns a cudaError_t, or -2 for a layout that does not exist.
extern "C" int fcvm_k1m_probe_f32(int layout, const void* maps, const int* elnodes_t,
                                  const int* offsets, const int* pos, const int* ents,
                                  const int* ent_rows, const int* node_offsets,
                                  const int* node_rows, const float* x, const float* fixmask,
                                  float* fe, float* y, long long ne, long long nn, int m,
                                  int form, int negate, void* stream) {
  const Tables tab{elnodes_t, offsets, pos, ents, ent_rows, node_offsets, node_rows};
  if (layout == kCollapse)
    return run<kCollapse, float>(maps, tab, x, fixmask, fe, y, ne, nn, m, form, negate, stream);
  if (layout == kDirect)
    return run<kDirect, float>(maps, tab, x, fixmask, fe, y, ne, nn, m, form, negate, stream);
  return -2;
}

extern "C" int fcvm_k1m_probe_f64(int layout, const void* maps, const int* elnodes_t,
                                  const int* offsets, const int* pos, const int* ents,
                                  const int* ent_rows, const int* node_offsets,
                                  const int* node_rows, const double* x, const double* fixmask,
                                  double* fe, double* y, long long ne, long long nn, int m,
                                  int form, int negate, void* stream) {
  const Tables tab{elnodes_t, offsets, pos, ents, ent_rows, node_offsets, node_rows};
  if (layout == kCollapse)
    return run<kCollapse, double>(maps, tab, x, fixmask, fe, y, ne, nn, m, form, negate, stream);
  if (layout == kDirect)
    return run<kDirect, double>(maps, tab, x, fixmask, fe, y, ne, nn, m, form, negate, stream);
  return -2;
}
