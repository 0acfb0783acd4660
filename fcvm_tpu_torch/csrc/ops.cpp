// PyTorch operator bindings of the port's CUDA kernels.
//
// Registers with the dispatcher, for CUDA tensors:
//   fcvm::block_matvec  K0   csrc/block_matvec.cu
//   fcvm::block_matmat  K0m  csrc/block_matmat.cu
//   fcvm::khat_matvec   K1   csrc/khat_matvec.cu
//   fcvm::khat_matmat   K1m  csrc/khat_matmat.cu (khat_matmat_map: its tensor maps)
//   fcvm::two_level_apply  K4  csrc/two_level.cu (with K4c)
//   fcvm::two_level_apply_block  K4m  csrc/two_level.cu (with K4c)
//   fcvm::coarse_product  K4c  csrc/two_level.cu (alone)
//   fcvm::segment_sum   K8   csrc/segment_sum.cu (in place: accumulate or write)
//   fcvm::cg_pass       K6   csrc/cg_iteration.cu (one pass of a CG iteration, in place;
//                            cg_grid: its resident grid; cg_layout: its scratch)
//   fcvm::stress_update K2   csrc/stress_update.cu (the element pass: the stress update
//                            and elv; with no du the given-stress form, elv alone)
//   fcvm::node_force    K2   csrc/stress_update.cu (the node pass: qin; with glv the
//                            residual form, r and its norm too)
//   fcvm::form_blocks   K3   csrc/form_blocks.cu (the element blocks, elastic, tangent
//                            or geometric: K1's packed tiles, the element-major
//                            blocks and the compact diagonal, any of them)
//   fcvm::jacobi_inverse  K5  csrc/jacobi_inverse.cu (the block-Jacobi rebuild on K3's
//                            compact diagonal: fused, or its sum and its tail around
//                            the caller's reduce)
//   fcvm::soa_matvec    K0p  csrc/bw_probe.cu
//   fcvm::bw_read       Kbw  csrc/bw_probe.cu
// so each is called as torch.ops.fcvm.<name>.  The kernels themselves keep a
// plain C interface and include no PyTorch header; this file checks the
// tensors, picks the dtype, allocates outputs and scratch and passes the
// current stream.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <algorithm>
#include <cstdint>
#include <optional>
#include <string>
#include <vector>

extern "C" int fcvm_block_matvec_f32(const float* esm_t, const float* ue_t,
                                     float* out, long long ne, void* stream);
extern "C" int fcvm_block_matvec_f64(const double* esm_t, const double* ue_t,
                                     double* out, long long ne, void* stream);
extern "C" int fcvm_block_matmat_f32(const float* esm_t, const float* ue, float* out,
                                     long long ne, int m, void* stream);
extern "C" int fcvm_block_matmat_f64(const double* esm_t, const double* ue, double* out,
                                     long long ne, int m, void* stream);
extern "C" int fcvm_khat_matvec_f32(const float* packed, const int* elnodes_t,
                                    const int* offsets, const int* pos, const float* x,
                                    const float* fixmask, float* fe, float* y, long long ne,
                                    long long nn, long long ntiles, void* stream);
extern "C" int fcvm_khat_matvec_f64(const double* packed, const int* elnodes_t,
                                    const int* offsets, const int* pos, const double* x,
                                    const double* fixmask, double* fe, double* y, long long ne,
                                    long long nn, long long ntiles, void* stream);
extern "C" int fcvm_khat_matmat_map_bytes();
extern "C" int fcvm_khat_matmat_map_f32(const float* packed, long long ntiles, void* maps);
extern "C" int fcvm_khat_matmat_map_f64(const double* packed, long long ntiles, void* maps);
extern "C" long long fcvm_khat_matmat_rows(int itemsize, int m, long long ne, long long rows);
extern "C" int fcvm_khat_matmat_f32(const void* maps, const int* elnodes_t, const int* offsets,
                                    const int* pos, const int* ents, const int* ent_rows,
                                    const int* node_offsets, const int* node_rows,
                                    const float* x, const float* fixmask, float* fe, float* y,
                                    long long ne, long long nn, int m, int form, int negate,
                                    void* stream);
extern "C" int fcvm_khat_matmat_f64(const void* maps, const int* elnodes_t, const int* offsets,
                                    const int* pos, const int* ents, const int* ent_rows,
                                    const int* node_offsets, const int* node_rows,
                                    const double* x, const double* fixmask, double* fe,
                                    double* y, long long ne, long long nn, int m, int form,
                                    int negate, void* stream);
extern "C" int fcvm_segment_sum_f32(const float* vals, const int* order, const int* walk,
                                    const int* holes, float* out, long long nu, long long nlong,
                                    long long nholes, long long w, int write, void* stream);
extern "C" int fcvm_segment_sum_f64(const double* vals, const int* order, const int* walk,
                                    const int* holes, double* out, long long nu, long long nlong,
                                    long long nholes, long long w, int write, void* stream);
extern "C" int fcvm_two_level_restrict_f32(const float* r, const float* fixmask,
                                           const float* qmat, const float* pinv, float* z,
                                           float* rc, long long nn, int cs, int ncl, int nm,
                                           void* stream);
extern "C" int fcvm_two_level_restrict_f64(const double* r, const double* fixmask,
                                           const double* qmat, const double* pinv, double* z,
                                           double* rc, long long nn, int cs, int ncl, int nm,
                                           void* stream);
extern "C" int fcvm_two_level_prolong_f32(const float* qmat, const float* zc,
                                          const float* fixmask, const float* z_fine, float* z,
                                          long long nn, int cs, int ncl, int nm, void* stream);
extern "C" int fcvm_two_level_prolong_f64(const double* qmat, const double* zc,
                                          const double* fixmask, const double* z_fine,
                                          double* z, long long nn, int cs, int ncl, int nm,
                                          void* stream);
extern "C" int fcvm_two_level_restrict_block_f32(const float* r, const float* fixmask,
                                                 const float* qmat, const float* pinv, float* z,
                                                 float* rc, long long nn, int cs, int ncl,
                                                 int nm, int m, void* stream);
extern "C" int fcvm_two_level_restrict_block_f64(const double* r, const double* fixmask,
                                                 const double* qmat, const double* pinv,
                                                 double* z, double* rc, long long nn, int cs,
                                                 int ncl, int nm, int m, void* stream);
extern "C" int fcvm_two_level_prolong_block_f32(const float* qmat, const float* zc,
                                                const float* fixmask, const float* z_fine,
                                                float* z, long long nn, int cs, int ncl, int nm,
                                                int m, void* stream);
extern "C" int fcvm_two_level_prolong_block_f64(const double* qmat, const double* zc,
                                                const double* fixmask, const double* z_fine,
                                                double* z, long long nn, int cs, int ncl, int nm,
                                                int m, void* stream);
extern "C" int fcvm_coarse_plan(int itemsize, int m, long long n, int* nruns, int* maxseg);
extern "C" int fcvm_coarse_product_f32(const float* tiles, const float* x, float* y, float* sv,
                                       float* su, long long n, int m, int nruns, int maxseg,
                                       void* stream);
extern "C" int fcvm_coarse_product_f64(const double* tiles, const double* x, double* y,
                                       double* sv, double* su, long long n, int m, int nruns,
                                       int maxseg, void* stream);
extern "C" int fcvm_cg_grid(int itemsize, long long n, int m, int kd, int block);
extern "C" void fcvm_cg_layout(int grid, int m, int kd, long long n, int block, long long* out);
extern "C" int fcvm_cg_pass_f32(int step, int start, double* st, float* part, unsigned* bar,
                                float* x, float* r, float* p, float* v, const float* w,
                                const float* kw_inv, float* zs, float* coef, long long n, int m,
                                int kd, int nstore, int block, int grid, void* stream);
extern "C" int fcvm_cg_pass_f64(int step, int start, double* st, double* part, unsigned* bar,
                                double* x, double* r, double* p, double* v, const double* w,
                                const double* kw_inv, double* zs, double* coef, long long n,
                                int m, int kd, int nstore, int block, int grid, void* stream);
extern "C" int fcvm_stress_update_f32(const float* coords, const int* table,
                                      const float* disp, const float* du, const float* sig,
                                      const float* sig_yield, const float* dmat,
                                      long long dstride, const float* g, const float* h3g,
                                      double g_s, double h3g_s, const float* weights,
                                      float* sig_new, float* sig_test, uint32_t* pgp,
                                      float* elv, long long ne, int large_disp, void* stream);
extern "C" int fcvm_stress_update_f64(const double* coords, const int* table,
                                      const double* disp, const double* du, const double* sig,
                                      const double* sig_yield, const double* dmat,
                                      long long dstride, const double* g, const double* h3g,
                                      double g_s, double h3g_s, const double* weights,
                                      double* sig_new, double* sig_test, uint32_t* pgp,
                                      double* elv, long long ne, int large_disp, void* stream);
extern "C" long long fcvm_node_force_blocks(long long units);
extern "C" int fcvm_node_force_f32(const float* elv, const int* order, const int* offsets,
                                   const int* segs, const int* holes, long long nu,
                                   long long nholes, float* qin, const float* glv,
                                   const float* fixmask, float* r, double* partials,
                                   unsigned* ticket, float* error, double lbd1, double relax,
                                   double qnorm, void* stream);
extern "C" int fcvm_node_force_f64(const double* elv, const int* order, const int* offsets,
                                   const int* segs, const int* holes, long long nu,
                                   long long nholes, double* qin, const double* glv,
                                   const double* fixmask, double* r, double* partials,
                                   unsigned* ticket, double* error, double lbd1, double relax,
                                   double qnorm, void* stream);
extern "C" int fcvm_form_blocks_f32(int form, const float* coords, const float* disp,
                                    const int* table, long long nt, const long long* perm,
                                    const float* dmat, long long dstride, const float* sig,
                                    const unsigned char* pgp, const float* g, const float* h,
                                    double g3fac_s, const float* weights, float* full,
                                    float* packed, float* diag, long long ne, long long npad,
                                    long long tile, void* stream);
extern "C" int fcvm_form_blocks_f64(int form, const double* coords, const double* disp,
                                    const int* table, long long nt, const long long* perm,
                                    const double* dmat, long long dstride, const double* sig,
                                    const unsigned char* pgp, const double* g, const double* h,
                                    double g3fac_s, const double* weights, double* full,
                                    double* packed, double* diag, long long ne, long long npad,
                                    long long tile, void* stream);
extern "C" int fcvm_jacobi_inverse_f32(int form, const float* diag, const int* order,
                                       const int* offsets, const int* segs, const int* holes,
                                       long long nu, long long nholes, long long ne,
                                       const long long* cols, const float* fixmask,
                                       const float* nodal, float* out, void* stream);
extern "C" int fcvm_jacobi_inverse_f64(int form, const double* diag, const int* order,
                                       const int* offsets, const int* segs, const int* holes,
                                       long long nu, long long nholes, long long ne,
                                       const long long* cols, const double* fixmask,
                                       const double* nodal, double* out, void* stream);
extern "C" int fcvm_soa_matvec_f32(const float* esm_t, const float* ue_t, float* out,
                                   long long ne, int tile, void* stream);
extern "C" int fcvm_bw_read_blocks(long long rows, long long chunk_rows, int device);
extern "C" int fcvm_bw_read_f32(const float* x, float* partial, float* out, long long rows,
                                long long chunk_rows, int k, int nblocks, void* stream);

namespace {

at::Tensor block_matvec(const at::Tensor& esm_t, const at::Tensor& ue_t) {
  TORCH_CHECK(esm_t.is_cuda() && ue_t.device() == esm_t.device(),
              "block_matvec: both tensors must be on one CUDA device");
  TORCH_CHECK(esm_t.scalar_type() == ue_t.scalar_type(),
              "block_matvec: esm_t and ue_t differ in dtype");
  TORCH_CHECK(esm_t.dim() == 3 && esm_t.size(0) == 30 && esm_t.size(1) == 30 &&
                  ue_t.dim() == 2 && ue_t.size(0) == 30 &&
                  ue_t.size(1) == esm_t.size(2),
              "block_matvec: expected esm_t (30, 30, ne) and ue_t (30, ne)");
  TORCH_CHECK(esm_t.is_contiguous() && ue_t.is_contiguous(),
              "block_matvec: inputs must be contiguous");
  const c10::cuda::CUDAGuard guard(esm_t.device());
  at::Tensor out = at::empty_like(ue_t);
  const long long ne = esm_t.size(2);
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  int err = 0;
  switch (esm_t.scalar_type()) {
    case at::kFloat:
      err = fcvm_block_matvec_f32(esm_t.data_ptr<float>(), ue_t.data_ptr<float>(),
                                  out.data_ptr<float>(), ne, stream);
      break;
    case at::kDouble:
      err = fcvm_block_matvec_f64(esm_t.data_ptr<double>(), ue_t.data_ptr<double>(),
                                  out.data_ptr<double>(), ne, stream);
      break;
    default:
      TORCH_CHECK(false, "block_matvec: dtype must be float32 or float64, got ",
                  esm_t.scalar_type());
  }
  TORCH_CHECK(err == 0, "block_matvec: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return out;
}

at::Tensor block_matmat(const at::Tensor& esm_t, const at::Tensor& ue) {
  TORCH_CHECK(esm_t.is_cuda() && ue.device() == esm_t.device(),
              "block_matmat: both tensors must be on one CUDA device");
  TORCH_CHECK(esm_t.scalar_type() == ue.scalar_type(),
              "block_matmat: esm_t and ue differ in dtype");
  TORCH_CHECK(esm_t.dim() == 3 && esm_t.size(0) == 30 && esm_t.size(1) == 30 &&
                  ue.dim() == 3 && ue.size(0) == esm_t.size(2) && ue.size(1) == 30 &&
                  ue.size(2) >= 1 && ue.size(2) <= 0x7fffffff,
              "block_matmat: expected esm_t (30, 30, ne) and ue (ne, 30, m), m >= 1");
  TORCH_CHECK(esm_t.is_contiguous() && ue.is_contiguous(),
              "block_matmat: inputs must be contiguous");
  const c10::cuda::CUDAGuard guard(esm_t.device());
  at::Tensor out = at::empty_like(ue);
  const long long ne = esm_t.size(2);
  const int m = static_cast<int>(ue.size(2));
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  int err = 0;
  switch (esm_t.scalar_type()) {
    case at::kFloat:
      err = fcvm_block_matmat_f32(esm_t.data_ptr<float>(), ue.data_ptr<float>(),
                                  out.data_ptr<float>(), ne, m, stream);
      break;
    case at::kDouble:
      err = fcvm_block_matmat_f64(esm_t.data_ptr<double>(), ue.data_ptr<double>(),
                                  out.data_ptr<double>(), ne, m, stream);
      break;
    default:
      TORCH_CHECK(false, "block_matmat: dtype must be float32 or float64, got ",
                  esm_t.scalar_type());
  }
  TORCH_CHECK(err == 0, "block_matmat: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return out;
}

// K1: y = P K (P x) + (I - P) x with fixmask, K x without; K from the
// packed symmetric blocks (ntiles, 465, E), E = 1024 / sizeof(T)
// (ops/kernels.py::pack_blocks), and the int32 tables: elnodes_t (10, ne),
// the node-incidence CSR offsets (nn + 1) and pos (10 ne).
at::Tensor khat_matvec(const at::Tensor& packed, const at::Tensor& elnodes_t,
                       const at::Tensor& offsets, const at::Tensor& pos, const at::Tensor& x,
                       const std::optional<at::Tensor>& fixmask) {
  TORCH_CHECK(packed.is_cuda() && elnodes_t.device() == packed.device() &&
                  offsets.device() == packed.device() && pos.device() == packed.device() &&
                  x.device() == packed.device() &&
                  (!fixmask || fixmask->device() == packed.device()),
              "khat_matvec: all tensors must be on one CUDA device");
  TORCH_CHECK(x.scalar_type() == packed.scalar_type() &&
                  (!fixmask || fixmask->scalar_type() == packed.scalar_type()),
              "khat_matvec: packed, x and fixmask differ in dtype");
  TORCH_CHECK(elnodes_t.scalar_type() == at::kInt && offsets.scalar_type() == at::kInt &&
                  pos.scalar_type() == at::kInt,
              "khat_matvec: elnodes_t, offsets and pos must be int32");
  const long long tile = static_cast<long long>(1024 / packed.element_size());
  const long long ne = elnodes_t.dim() == 2 ? elnodes_t.size(1) : -1;
  const long long nn = offsets.dim() == 1 ? offsets.size(0) - 1 : -1;
  const long long ntiles = packed.dim() == 3 ? packed.size(0) : -1;
  TORCH_CHECK(packed.dim() == 3 && packed.size(1) == 465 && packed.size(2) == tile &&
                  (ntiles - 1) * tile < ne && ne <= ntiles * tile && elnodes_t.size(0) == 10 &&
                  nn >= 0 && pos.dim() == 1 && pos.size(0) == 10 * ne && x.dim() == 1 &&
                  x.size(0) == 3 * nn && (!fixmask || fixmask->sizes() == x.sizes()) &&
                  30 * ne <= 0x7fffffffLL,
              "khat_matvec: expected packed (ntiles, 465, 1024 / itemsize) covering ne "
              "elements, elnodes_t (10, ne), offsets (nn + 1), pos (10 ne), x and fixmask "
              "(3 nn), 30 ne < 2^31");
  TORCH_CHECK(packed.is_contiguous() && elnodes_t.is_contiguous() && offsets.is_contiguous() &&
                  pos.is_contiguous() && x.is_contiguous() &&
                  (!fixmask || fixmask->is_contiguous()) &&
                  reinterpret_cast<uintptr_t>(packed.data_ptr()) % 16 == 0,
              "khat_matvec: inputs must be contiguous, packed 16-byte aligned");
  const c10::cuda::CUDAGuard guard(packed.device());
  at::Tensor fe = at::empty({30, ne}, x.options());
  at::Tensor y = at::empty_like(x);
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  const int* tables[3] = {elnodes_t.data_ptr<int>(), offsets.data_ptr<int>(),
                          pos.data_ptr<int>()};
  int err = 0;
  switch (packed.scalar_type()) {
    case at::kFloat:
      err = fcvm_khat_matvec_f32(packed.data_ptr<float>(), tables[0], tables[1], tables[2],
                                 x.data_ptr<float>(),
                                 fixmask ? fixmask->data_ptr<float>() : nullptr,
                                 fe.data_ptr<float>(), y.data_ptr<float>(), ne, nn, ntiles,
                                 stream);
      break;
    case at::kDouble:
      err = fcvm_khat_matvec_f64(packed.data_ptr<double>(), tables[0], tables[1], tables[2],
                                 x.data_ptr<double>(),
                                 fixmask ? fixmask->data_ptr<double>() : nullptr,
                                 fe.data_ptr<double>(), y.data_ptr<double>(), ne, nn, ntiles,
                                 stream);
      break;
    default:
      TORCH_CHECK(false, "khat_matvec: dtype must be float32 or float64, got ",
                  packed.scalar_type());
  }
  TORCH_CHECK(err == 0, "khat_matvec: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return y;
}

// K1m's tensor maps of a packed copy (ntiles, 465, 1024 / itemsize), on the
// CPU, encoded once per operator and valid while the copy lives: the maps'
// bytes, then the copy's address and tile count, which khat_matmat checks.
at::Tensor khat_matmat_map(const at::Tensor& packed) {
  const long long tile = static_cast<long long>(1024 / packed.element_size());
  TORCH_CHECK(packed.is_cuda() && packed.dim() == 3 && packed.size(1) == 465 &&
                  packed.size(2) == tile && packed.is_contiguous() &&
                  reinterpret_cast<uintptr_t>(packed.data_ptr()) % 16 == 0,
              "khat_matmat_map: expected a contiguous, 16-byte aligned CUDA packed copy "
              "(ntiles, 465, 1024 / itemsize)");
  const c10::cuda::CUDAGuard guard(packed.device());
  const long long nbytes = fcvm_khat_matmat_map_bytes();
  at::Tensor map = at::empty({nbytes + 16}, at::TensorOptions().dtype(at::kByte));
  int err = 0;
  switch (packed.scalar_type()) {
    case at::kFloat:
      err = fcvm_khat_matmat_map_f32(packed.data_ptr<float>(), packed.size(0), map.data_ptr());
      break;
    case at::kDouble:
      err = fcvm_khat_matmat_map_f64(packed.data_ptr<double>(), packed.size(0), map.data_ptr());
      break;
    default:
      TORCH_CHECK(false, "khat_matmat_map: dtype must be float32 or float64, got ",
                  packed.scalar_type());
  }
  TORCH_CHECK(err == 0, "khat_matmat_map: encoding the tensor map failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  auto* tail = reinterpret_cast<int64_t*>(map.data_ptr<uint8_t>() + nbytes);
  tail[0] = static_cast<int64_t>(reinterpret_cast<uintptr_t>(packed.data_ptr()));
  tail[1] = packed.size(0);
  return map;
}

// K1m: Y = P K (P X) + (I - P) X (identity) or P K (P X) with fixmask, K X
// without; each negated with negate.  X (3 nn, m), row-major; packed and its
// maps (khat_matmat_map); K1's node table and incidence CSR (offsets, pos)
// and K1m's compacted tables (ops/kernels.py::K1mTables), whose contents
// ops/kernels.py::khat_matmat_plan checks once: here their sizes, dtypes
// and devices, and that the maps are the copy's.
at::Tensor khat_matmat(const at::Tensor& packed, const at::Tensor& map,
                       const at::Tensor& elnodes_t, const at::Tensor& offsets,
                       const at::Tensor& pos, const at::Tensor& ents, const at::Tensor& ent_rows,
                       const at::Tensor& node_offsets, const at::Tensor& node_rows,
                       const at::Tensor& x, const std::optional<at::Tensor>& fixmask,
                       bool identity, bool negate) {
  const at::Tensor* ints[7] = {&elnodes_t, &offsets, &pos, &ents, &ent_rows, &node_offsets,
                               &node_rows};
  bool ok = packed.is_cuda() && x.device() == packed.device() &&
            (!fixmask || fixmask->device() == packed.device());
  for (const at::Tensor* t : ints)
    ok = ok && t->device() == packed.device() && t->scalar_type() == at::kInt &&
         t->is_contiguous();
  TORCH_CHECK(ok, "khat_matmat: all tensors must be on one CUDA device, the tables int32 and "
              "contiguous");
  TORCH_CHECK(x.scalar_type() == packed.scalar_type() &&
                  (!fixmask || fixmask->scalar_type() == packed.scalar_type()),
              "khat_matmat: packed, x and fixmask differ in dtype");
  const long long tile = static_cast<long long>(1024 / packed.element_size());
  const long long ne = elnodes_t.dim() == 2 ? elnodes_t.size(1) : -1;
  const long long nn = offsets.dim() == 1 ? offsets.size(0) - 1 : -1;
  const long long ntiles = packed.dim() == 3 ? packed.size(0) : -1;
  const long long rows = node_rows.dim() == 1 ? node_rows.size(0) : -1;
  const long long m = x.dim() == 2 ? x.size(1) : -1;
  TORCH_CHECK(packed.dim() == 3 && packed.size(1) == 465 && packed.size(2) == tile &&
                  packed.is_contiguous() && (ntiles - 1) * tile < ne && ne <= ntiles * tile &&
                  elnodes_t.size(0) == 10 && nn >= 0 && pos.dim() == 1 &&
                  pos.size(0) == 10 * ne && ents.dim() == 1 && ents.size(0) == 10 * ne &&
                  ent_rows.dim() == 1 && ent_rows.size(0) == 10 * ne &&
                  node_offsets.dim() == 1 && node_offsets.size(0) == nn + 1 && rows >= 0 &&
                  rows <= 10 * ne && x.dim() == 2 && x.size(0) == 3 * nn && m >= 1 &&
                  m <= 0x7fffffffLL && x.is_contiguous() &&
                  (!fixmask || (fixmask->dim() == 1 && fixmask->size(0) == 3 * nn &&
                                fixmask->is_contiguous())) &&
                  30 * ne <= 0x7fffffffLL,
              "khat_matmat: expected packed (ntiles, 465, 1024 / itemsize) covering ne "
              "elements, elnodes_t (10, ne), offsets and node_offsets (nn + 1), pos, ents and "
              "ent_rows (10 ne), node_rows (R <= 10 ne), x (3 nn, m) with m >= 1, fixmask "
              "(3 nn), all contiguous, 30 ne < 2^31");
  const long long nbytes = fcvm_khat_matmat_map_bytes();
  TORCH_CHECK(map.is_cpu() && map.scalar_type() == at::kByte && map.numel() == nbytes + 16 &&
                  map.is_contiguous(),
              "khat_matmat: map must be the copy's khat_matmat_map");
  const auto* tail = reinterpret_cast<const int64_t*>(map.data_ptr<uint8_t>() + nbytes);
  TORCH_CHECK(tail[0] == static_cast<int64_t>(reinterpret_cast<uintptr_t>(packed.data_ptr())) &&
                  tail[1] == ntiles,
              "khat_matmat: map encodes another packed copy than the one given");
  const c10::cuda::CUDAGuard guard(packed.device());
  const long long fe_rows = fcvm_khat_matmat_rows(static_cast<int>(packed.element_size()),
                                                  static_cast<int>(m), ne, rows);
  at::Tensor fe = at::empty({fe_rows, 3, m}, x.options());
  at::Tensor y = at::empty_like(x);
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  const int* tab[7];
  for (int i = 0; i < 7; ++i) tab[i] = ints[i]->data_ptr<int>();
  const int form = !fixmask ? 0 : identity ? 2 : 1;
  int err = 0;
  if (packed.scalar_type() == at::kFloat)
    err = fcvm_khat_matmat_f32(map.data_ptr(), tab[0], tab[1], tab[2], tab[3], tab[4], tab[5],
                               tab[6], x.data_ptr<float>(),
                               fixmask ? fixmask->data_ptr<float>() : nullptr,
                               fe.data_ptr<float>(), y.data_ptr<float>(), ne, nn,
                               static_cast<int>(m), form, negate, stream);
  else
    err = fcvm_khat_matmat_f64(map.data_ptr(), tab[0], tab[1], tab[2], tab[3], tab[4], tab[5],
                               tab[6], x.data_ptr<double>(),
                               fixmask ? fixmask->data_ptr<double>() : nullptr,
                               fe.data_ptr<double>(), y.data_ptr<double>(), ne, nn,
                               static_cast<int>(m), form, negate, stream);
  TORCH_CHECK(err == 0, "khat_matmat: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return y;
}

// K8: out[seg_u, :] (+)= sum over the rows p of segment u of vals[order[p], :],
// in place; accumulating onto out's rows (write false) or onto zeros, with
// every row of out that no key names (holes) written 0 (write true).  vals
// (n, ...) and out (nout, ...) contiguous with the same trailing shape; the
// plan int32: order, walk (3, nu) (each segment's begin and end in order and
// its output row, longest first), holes; nlong from
// ops/kernels.py::ring_groups: the first nlong segments take the ring
// path (rows of 16-byte multiples at a 16-byte aligned vals), the rest the
// register path.
void segment_sum(const at::Tensor& vals, const at::Tensor& order, const at::Tensor& walk,
                 const std::optional<at::Tensor>& holes, at::Tensor& out, int64_t nlong,
                 bool write) {
  TORCH_CHECK(out.is_cuda() && vals.device() == out.device() && order.device() == out.device() &&
                  walk.device() == out.device() && (!holes || holes->device() == out.device()),
              "segment_sum: all tensors must be on one CUDA device");
  TORCH_CHECK(vals.scalar_type() == out.scalar_type(), "segment_sum: vals and out differ in dtype");
  TORCH_CHECK(order.scalar_type() == at::kInt && walk.scalar_type() == at::kInt &&
                  (!holes || holes->scalar_type() == at::kInt),
              "segment_sum: order, walk and holes must be int32");
  TORCH_CHECK(vals.dim() >= 1 && out.dim() == vals.dim() &&
                  out.sizes().slice(1) == vals.sizes().slice(1) && order.dim() == 1 &&
                  order.size(0) <= vals.size(0) && walk.dim() == 2 && walk.size(0) == 3 &&
                  (!holes || holes->dim() == 1) && out.size(0) <= 0x7fffffffLL,
              "segment_sum: expected vals (n, ...), out (nout, ...), order (at most n), walk "
              "(3, nu), holes (nholes)");
  TORCH_CHECK(vals.is_contiguous() && out.is_contiguous() && order.is_contiguous() &&
                  walk.is_contiguous() && (!holes || holes->is_contiguous()),
              "segment_sum: inputs must be contiguous");
  TORCH_CHECK(!write || holes, "segment_sum: the write form needs the plan's holes");
  const long long nu = walk.size(1);
  const long long w = out.size(0) > 0 ? out.numel() / out.size(0) : 0;
  TORCH_CHECK(nlong >= 0 && nlong <= nu && w > 0, "segment_sum: nlong ", nlong, " of ", nu,
              " segments at width ", w, "; expected 0 <= nlong <= nu and a width");
  TORCH_CHECK(nlong == 0 || ((w * vals.element_size()) % 16 == 0 &&
                             reinterpret_cast<uintptr_t>(vals.data_ptr()) % 16 == 0),
              "segment_sum: the ring path needs rows of a multiple of 16 bytes at a 16-byte "
              "aligned address");
  const c10::cuda::CUDAGuard guard(out.device());
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  const long long nholes = holes ? holes->size(0) : 0;
  const int* holes_ptr = holes ? holes->data_ptr<int>() : nullptr;
  int err = 0;
  switch (out.scalar_type()) {
    case at::kFloat:
      err = fcvm_segment_sum_f32(vals.data_ptr<float>(), order.data_ptr<int>(),
                                 walk.data_ptr<int>(), holes_ptr, out.data_ptr<float>(), nu,
                                 nlong, nholes, w, write, stream);
      break;
    case at::kDouble:
      err = fcvm_segment_sum_f64(vals.data_ptr<double>(), order.data_ptr<int>(),
                                 walk.data_ptr<int>(), holes_ptr, out.data_ptr<double>(), nu,
                                 nlong, nholes, w, write, stream);
      break;
    default:
      TORCH_CHECK(false, "segment_sum: dtype must be float32 or float64, got ",
                  out.scalar_type());
  }
  TORCH_CHECK(err == 0, "segment_sum: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

constexpr long long kCoarseTile = 128;  // K4c's tile, csrc/two_level.cu

// Check K4c's packed tiles of an (n, n) coarse inverse against x's device
// and dtype: (nb (nb + 1) / 2, 128, 128), nb = ceil(n / 128), dense, 16-byte
// aligned.
void check_tiles(const char* name, const at::Tensor& tiles, long long n, const at::Tensor& x) {
  const long long nb = (n + kCoarseTile - 1) / kCoarseTile;
  TORCH_CHECK(tiles.device() == x.device(), name, ": the tiles are on another device");
  TORCH_CHECK(tiles.scalar_type() == x.scalar_type(), name, ": the tiles differ in dtype");
  TORCH_CHECK(n > 0 && n <= 0x7fffffffLL && tiles.dim() == 3 &&
                  tiles.size(0) == nb * (nb + 1) / 2 && tiles.size(1) == kCoarseTile &&
                  tiles.size(2) == kCoarseTile,
              name, ": expected the packed tiles (nb (nb + 1) / 2, 128, 128) of n = ", n,
              " coarse dofs, nb = ", nb);
  TORCH_CHECK(tiles.is_contiguous() && reinterpret_cast<uintptr_t>(tiles.data_ptr()) % 16 == 0,
              name, ": the tiles must be contiguous and 16-byte aligned");
}

// K4c on a dense (n, m) x: zc (n, m), with its scratch.
at::Tensor coarse_apply(const char* name, const at::Tensor& tiles, const at::Tensor& x,
                        long long n, long long m, void* stream) {
  int nruns = 0, maxseg = 0;
  int err = fcvm_coarse_plan(static_cast<int>(x.element_size()), static_cast<int>(m), n, &nruns,
                             &maxseg);
  TORCH_CHECK(err == 0, name, ": coarse product plan failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  at::Tensor y = at::empty({n, m}, x.options());
  at::Tensor sv = at::empty({tiles.size(0) * kCoarseTile * m}, x.options());
  at::Tensor su = at::empty({static_cast<long long>(nruns) * maxseg * kCoarseTile * m},
                            x.options());
  if (x.scalar_type() == at::kFloat)
    err = fcvm_coarse_product_f32(tiles.data_ptr<float>(), x.data_ptr<float>(),
                                  y.data_ptr<float>(), sv.data_ptr<float>(), su.data_ptr<float>(),
                                  n, static_cast<int>(m), nruns, maxseg, stream);
  else
    err = fcvm_coarse_product_f64(tiles.data_ptr<double>(), x.data_ptr<double>(),
                                  y.data_ptr<double>(), sv.data_ptr<double>(),
                                  su.data_ptr<double>(), n, static_cast<int>(m), nruns, maxseg,
                                  stream);
  TORCH_CHECK(err == 0, name, ": coarse product launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return y;
}

// K4c alone: Kc^-1 x for x (n,) or (n, m), n = x.size(0).
at::Tensor coarse_product(const at::Tensor& tiles, const at::Tensor& x) {
  TORCH_CHECK(x.is_cuda(), "coarse_product: x must be on a CUDA device");
  TORCH_CHECK(x.scalar_type() == at::kFloat || x.scalar_type() == at::kDouble,
              "coarse_product: dtype must be float32 or float64, got ", x.scalar_type());
  TORCH_CHECK((x.dim() == 1 || (x.dim() == 2 && x.size(1) >= 1 && x.size(1) <= 0x7fffffffLL)) &&
                  x.is_contiguous(),
              "coarse_product: expected a dense x (n,) or (n, m), m >= 1");
  const long long n = x.size(0), m = x.dim() == 2 ? x.size(1) : 1;
  check_tiles("coarse_product", tiles, n, x);
  const c10::cuda::CUDAGuard guard(x.device());
  at::Tensor y = coarse_apply("coarse_product", tiles, x, n, m,
                              c10::cuda::getCurrentCUDAStream().stream());
  return x.dim() == 1 ? y.reshape({n}) : y;
}

// K4: z = z_fine + P Q Kc^-1 Q^T (P r), z_fine = pinv r per node unless given.
at::Tensor two_level_apply(const at::Tensor& pinv, const at::Tensor& qmat,
                           const at::Tensor& coarse, int64_t ncf, const at::Tensor& fixmask,
                           const at::Tensor& r, const std::optional<at::Tensor>& z_fine) {
  TORCH_CHECK(r.is_cuda() && pinv.device() == r.device() && qmat.device() == r.device() &&
                  fixmask.device() == r.device() &&
                  (!z_fine || z_fine->device() == r.device()),
              "two_level_apply: all tensors must be on one CUDA device");
  const auto dt = r.scalar_type();
  TORCH_CHECK(pinv.scalar_type() == dt && qmat.scalar_type() == dt &&
                  fixmask.scalar_type() == dt && (!z_fine || z_fine->scalar_type() == dt),
              "two_level_apply: the tensors differ in dtype");
  const long long nn = r.dim() == 1 ? r.size(0) / 3 : -1;
  const long long nm = qmat.dim() == 3 ? qmat.size(2) : -1;
  const long long ncl = nm > 0 ? ncf / nm : -1;
  TORCH_CHECK(r.dim() == 1 && r.size(0) == 3 * nn && fixmask.sizes() == r.sizes() &&
                  (!z_fine || z_fine->sizes() == r.sizes()) && pinv.dim() == 3 &&
                  pinv.size(0) == nn && pinv.size(1) == 3 && pinv.size(2) == 3 &&
                  (nm == 6 || nm == 12) && qmat.size(1) == 3 && ncl > 0 && ncf == nm * ncl &&
                  qmat.size(0) % ncl == 0 && qmat.size(0) >= nn &&
                  qmat.size(0) / ncl <= 0x7fffffffLL && ncl <= 0x7fffffffLL,
              "two_level_apply: expected r, fixmask (3 nn), pinv (nn, 3, 3), qmat (ncl cs, 3, "
              "nm) with nm 6 or 12 and ncl cs >= nn, ncf = nm ncl coarse dofs");
  TORCH_CHECK(pinv.is_contiguous() && qmat.is_contiguous() && fixmask.is_contiguous() &&
                  r.is_contiguous() && (!z_fine || z_fine->is_contiguous()),
              "two_level_apply: inputs must be contiguous");
  check_tiles("two_level_apply", coarse, ncf, r);
  const c10::cuda::CUDAGuard guard(r.device());
  const int cs = static_cast<int>(qmat.size(0) / ncl);
  at::Tensor rc = at::empty({nm * ncl}, r.options());
  at::Tensor z = at::empty_like(r);
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  int err = 0;
  switch (dt) {
    case at::kFloat:
      err = fcvm_two_level_restrict_f32(r.data_ptr<float>(), fixmask.data_ptr<float>(),
                                        qmat.data_ptr<float>(),
                                        z_fine ? nullptr : pinv.data_ptr<float>(),
                                        z.data_ptr<float>(), rc.data_ptr<float>(), nn, cs,
                                        static_cast<int>(ncl), static_cast<int>(nm), stream);
      break;
    case at::kDouble:
      err = fcvm_two_level_restrict_f64(r.data_ptr<double>(), fixmask.data_ptr<double>(),
                                        qmat.data_ptr<double>(),
                                        z_fine ? nullptr : pinv.data_ptr<double>(),
                                        z.data_ptr<double>(), rc.data_ptr<double>(), nn, cs,
                                        static_cast<int>(ncl), static_cast<int>(nm), stream);
      break;
    default:
      TORCH_CHECK(false, "two_level_apply: dtype must be float32 or float64, got ", dt);
  }
  TORCH_CHECK(err == 0, "two_level_apply: restrict launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  const at::Tensor zc = coarse_apply("two_level_apply", coarse, rc, ncf, 1, stream);
  const at::Tensor& fine = z_fine ? *z_fine : z;
  if (dt == at::kFloat)
    err = fcvm_two_level_prolong_f32(qmat.data_ptr<float>(), zc.data_ptr<float>(),
                                     fixmask.data_ptr<float>(), fine.data_ptr<float>(),
                                     z.data_ptr<float>(), nn, cs, static_cast<int>(ncl),
                                     static_cast<int>(nm), stream);
  else
    err = fcvm_two_level_prolong_f64(qmat.data_ptr<double>(), zc.data_ptr<double>(),
                                     fixmask.data_ptr<double>(), fine.data_ptr<double>(),
                                     z.data_ptr<double>(), nn, cs, static_cast<int>(ncl),
                                     static_cast<int>(nm), stream);
  TORCH_CHECK(err == 0, "two_level_apply: prolong launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return z;
}

// K4m: K4 on the m columns of r (3 nn, m), z_fine (3 nn, m) or none.
at::Tensor two_level_apply_block(const at::Tensor& pinv, const at::Tensor& qmat,
                                 const at::Tensor& coarse, int64_t ncf,
                                 const at::Tensor& fixmask, const at::Tensor& r,
                                 const std::optional<at::Tensor>& z_fine) {
  TORCH_CHECK(r.is_cuda() && pinv.device() == r.device() && qmat.device() == r.device() &&
                  fixmask.device() == r.device() &&
                  (!z_fine || z_fine->device() == r.device()),
              "two_level_apply_block: all tensors must be on one CUDA device");
  const auto dt = r.scalar_type();
  TORCH_CHECK(pinv.scalar_type() == dt && qmat.scalar_type() == dt &&
                  fixmask.scalar_type() == dt && (!z_fine || z_fine->scalar_type() == dt),
              "two_level_apply_block: the tensors differ in dtype");
  const long long nn = r.dim() == 2 ? r.size(0) / 3 : -1;
  const long long m = r.dim() == 2 ? r.size(1) : -1;
  const long long nm = qmat.dim() == 3 ? qmat.size(2) : -1;
  const long long ncl = nm > 0 ? ncf / nm : -1;
  TORCH_CHECK(r.dim() == 2 && r.size(0) == 3 * nn && m >= 1 && m <= 0x7fffffffLL &&
                  fixmask.dim() == 1 && fixmask.size(0) == 3 * nn &&
                  (!z_fine || z_fine->sizes() == r.sizes()) && pinv.dim() == 3 &&
                  pinv.size(0) == nn && pinv.size(1) == 3 && pinv.size(2) == 3 &&
                  (nm == 6 || nm == 12) && qmat.size(1) == 3 && ncl > 0 && ncf == nm * ncl &&
                  qmat.size(0) % ncl == 0 && qmat.size(0) >= nn &&
                  qmat.size(0) / ncl <= 0x7fffffffLL && ncl <= 0x7fffffffLL,
              "two_level_apply_block: expected r and z_fine (3 nn, m) with m >= 1, fixmask "
              "(3 nn), pinv (nn, 3, 3), qmat (ncl cs, 3, nm) with nm 6 or 12 and ncl cs >= nn, "
              "ncf = nm ncl coarse dofs");
  TORCH_CHECK(pinv.is_contiguous() && qmat.is_contiguous() && fixmask.is_contiguous() &&
                  r.is_contiguous() && (!z_fine || z_fine->is_contiguous()),
              "two_level_apply_block: inputs must be contiguous");
  check_tiles("two_level_apply_block", coarse, ncf, r);
  const c10::cuda::CUDAGuard guard(r.device());
  const int cs = static_cast<int>(qmat.size(0) / ncl);
  at::Tensor rc = at::empty({nm * ncl, m}, r.options());
  at::Tensor z = at::empty_like(r);
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  const int ncl_i = static_cast<int>(ncl), nm_i = static_cast<int>(nm), m_i = static_cast<int>(m);
  int err = 0;
  switch (dt) {
    case at::kFloat:
      err = fcvm_two_level_restrict_block_f32(
          r.data_ptr<float>(), fixmask.data_ptr<float>(), qmat.data_ptr<float>(),
          z_fine ? nullptr : pinv.data_ptr<float>(), z.data_ptr<float>(), rc.data_ptr<float>(),
          nn, cs, ncl_i, nm_i, m_i, stream);
      break;
    case at::kDouble:
      err = fcvm_two_level_restrict_block_f64(
          r.data_ptr<double>(), fixmask.data_ptr<double>(), qmat.data_ptr<double>(),
          z_fine ? nullptr : pinv.data_ptr<double>(), z.data_ptr<double>(),
          rc.data_ptr<double>(), nn, cs, ncl_i, nm_i, m_i, stream);
      break;
    default:
      TORCH_CHECK(false, "two_level_apply_block: dtype must be float32 or float64, got ", dt);
  }
  TORCH_CHECK(err == 0, "two_level_apply_block: restrict launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  const at::Tensor zc = coarse_apply("two_level_apply_block", coarse, rc, ncf, m, stream);
  const at::Tensor& fine = z_fine ? *z_fine : z;
  if (dt == at::kFloat)
    err = fcvm_two_level_prolong_block_f32(qmat.data_ptr<float>(), zc.data_ptr<float>(),
                                           fixmask.data_ptr<float>(), fine.data_ptr<float>(),
                                           z.data_ptr<float>(), nn, cs, ncl_i, nm_i, m_i, stream);
  else
    err = fcvm_two_level_prolong_block_f64(qmat.data_ptr<double>(), zc.data_ptr<double>(),
                                           fixmask.data_ptr<double>(), fine.data_ptr<double>(),
                                           z.data_ptr<double>(), nn, cs, ncl_i, nm_i, m_i,
                                           stream);
  TORCH_CHECK(err == 0, "two_level_apply_block: prolong launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return z;
}

// K6: the blocks of its resident grid for an (n, m) solve of `itemsize`-byte
// values on the current device (block: an (n, m) block, deflated by kd
// vectors).
int64_t cg_grid(int64_t itemsize, int64_t n, int64_t m, int64_t kd, bool block) {
  TORCH_CHECK((itemsize == 4 || itemsize == 8) && n >= 0 && m >= 1 && m <= 64 && kd >= 0 &&
                  kd <= 64,
              "cg_grid: expected itemsize 4 or 8, n >= 0, 1 <= m <= 64 and 0 <= kd <= 64");
  return fcvm_cg_grid(static_cast<int>(itemsize), n, static_cast<int>(m), static_cast<int>(kd),
                      block ? 1 : 0);
}

// K6: the offsets, in values, of its scratch's regions for a grid of `grid`
// blocks on m columns with kd deflation vectors (||r||^2 partials, W^T r
// partials, c), its size, and the offset of a deflated block's z (n rows:
// its size counts them).
std::vector<int64_t> cg_layout(int64_t grid, int64_t m, int64_t kd, int64_t n, bool block) {
  TORCH_CHECK(grid >= 1 && grid <= 0x7fffffff && m >= 1 && m <= 64 && kd >= 0 &&
                  kd <= (block ? 64 : 32) && n >= 0,
              "cg_layout: expected grid >= 1, 1 <= m <= 64, n >= 0 and 0 <= kd <= 32 (64 on a "
              "block)");
  long long out[5];
  fcvm_cg_layout(static_cast<int>(grid), static_cast<int>(m), static_cast<int>(kd), n,
                 block ? 1 : 0, out);
  return {out[0], out[1], out[2], out[3], out[4]};
}

// K6: pass `step` (0: the update, 1: the direction) of a CG iteration on
// state (m, 16) float64, in place, a cooperative launch of `grid` blocks;
// x, r, p, v (n,) for m = 1 or (n, m); v is ap for step 0, z for step 1.
// Deflation: w (n, kd), kw_inv (kd, kd), kd a multiple of 4 up to 32 on a
// vector, 64 on a block, w 16-byte aligned; the harvest (zs (nstore, n),
// coef (3, nstore)) only on a vector.  Tensors a pass does not read may be any of the vectors.  Returns the
// launch's CUDA error (0: launched), which the caller turns into an
// exception: a refused launch (a grid past residency) is not thrown from
// here.
template <typename T>
T* ptr(const std::optional<at::Tensor>& t) {
  return t ? t->data_ptr<T>() : nullptr;
}

int64_t cg_pass(int64_t step, bool start, const at::Tensor& state, const at::Tensor& scratch,
                const at::Tensor& barrier, const at::Tensor& x, const at::Tensor& r,
                const at::Tensor& p, const at::Tensor& v, const std::optional<at::Tensor>& w,
                const std::optional<at::Tensor>& kw_inv, const std::optional<at::Tensor>& zs,
                const std::optional<at::Tensor>& coef, int64_t grid) {
  const auto dev = state.device();
  const auto dt = x.scalar_type();
  TORCH_CHECK(state.is_cuda(), "cg_pass: the state must be on a CUDA device");
  for (const at::Tensor* t : {&scratch, &barrier, &x, &r, &p, &v})
    TORCH_CHECK(t->device() == dev && t->is_contiguous(),
                "cg_pass: every tensor must be contiguous and on the state's device");
  for (const auto* t : {&w, &kw_inv, &zs, &coef})
    TORCH_CHECK(!*t || ((*t)->device() == dev && (*t)->is_contiguous() &&
                        (*t)->scalar_type() == dt),
                "cg_pass: w, kw_inv, zs and coef must be contiguous, on the state's device and "
                "of the vectors' dtype");
  TORCH_CHECK(dt == at::kFloat || dt == at::kDouble, "cg_pass: dtype must be float32 or "
              "float64, got ", dt);
  TORCH_CHECK(r.scalar_type() == dt && p.scalar_type() == dt && v.scalar_type() == dt &&
                  scratch.scalar_type() == dt,
              "cg_pass: x, r, p, v and the scratch differ in dtype");
  TORCH_CHECK(state.scalar_type() == at::kDouble && state.dim() == 2 && state.size(1) == 16 &&
                  state.size(0) >= 1 && state.size(0) <= 64,
              "cg_pass: expected a float64 state (m, 16), 1 <= m <= 64");
  TORCH_CHECK(barrier.scalar_type() == at::kInt && barrier.numel() == 1,
              "cg_pass: expected an int32 barrier word");
  TORCH_CHECK(step >= 0 && step <= 1, "cg_pass: step must be 0 or 1");
  TORCH_CHECK(grid >= 1 && grid <= 0x7fffffff, "cg_pass: grid must be at least 1");
  const long long m = state.size(0), n = x.dim() >= 1 ? x.size(0) : -1;
  const bool vec = x.dim() == 1;
  TORCH_CHECK((vec ? m == 1 : (x.dim() == 2 && x.size(1) == m)) && r.sizes() == x.sizes() &&
                  p.sizes() == x.sizes() && v.sizes() == x.sizes(),
              "cg_pass: expected x, r, p, v of one shape, (n,) with one state row or (n, m) "
              "with m");
  TORCH_CHECK(!w == !kw_inv && !zs == !coef, "cg_pass: give w with kw_inv, zs with coef");
  const long long kd = w ? w->size(w->dim() - 1) : 0;
  TORCH_CHECK(!w || (w->dim() == 2 && w->size(0) == n && kd >= 4 && kd <= (vec ? 32 : 64) &&
                     kd % 4 == 0 && reinterpret_cast<uintptr_t>(w->data_ptr()) % 16 == 0 &&
                     kw_inv->dim() == 2 && kw_inv->size(0) == kd && kw_inv->size(1) == kd),
              "cg_pass: expected w (n, kd), 16-byte aligned, kd a multiple of 4 up to 32 on a "
              "vector and 64 on a block, and kw_inv (kd, kd)");
  const long long nstore = coef ? coef->size(coef->dim() - 1) : 0;
  TORCH_CHECK(!zs || (vec && zs->dim() == 2 && zs->size(1) == n && coef->dim() == 2 &&
                      coef->size(0) == 3 && nstore == zs->size(0) && nstore >= 1 &&
                      nstore <= 0x7fffffffLL),
              "cg_pass: expected zs (nstore, n) and coef (3, nstore), with a vector");
  const long long need = cg_layout(grid, m, kd, n, !vec)[3];
  TORCH_CHECK(scratch.dim() == 1 && scratch.size(0) >= need, "cg_pass: the scratch needs ",
              need, " values for a grid of ", grid);
  const c10::cuda::CUDAGuard guard(dev);
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  auto* st = state.data_ptr<double>();
  auto* bar = reinterpret_cast<unsigned*>(barrier.data_ptr<int>());
  int err = 0;
  if (dt == at::kFloat)
    err = fcvm_cg_pass_f32(static_cast<int>(step), start, st, scratch.data_ptr<float>(), bar,
                           x.data_ptr<float>(), r.data_ptr<float>(), p.data_ptr<float>(),
                           v.data_ptr<float>(), ptr<float>(w), ptr<float>(kw_inv),
                           ptr<float>(zs), ptr<float>(coef), n, static_cast<int>(m),
                           static_cast<int>(kd), static_cast<int>(nstore), vec ? 0 : 1,
                           static_cast<int>(grid), stream);
  else
    err = fcvm_cg_pass_f64(static_cast<int>(step), start, st, scratch.data_ptr<double>(), bar,
                           x.data_ptr<double>(), r.data_ptr<double>(), p.data_ptr<double>(),
                           v.data_ptr<double>(), ptr<double>(w), ptr<double>(kw_inv),
                           ptr<double>(zs), ptr<double>(coef), n, static_cast<int>(m),
                           static_cast<int>(kd), static_cast<int>(nstore), vec ? 0 : 1,
                           static_cast<int>(grid), stream);
  return err;
}

// K2's element pass: the stress update of every Gauss point and each
// element's internal force rows elv (ne, 30).  coords (nn, 3), table int32
// (10, ne) (the element-major node table), sig (ne, 4, 6) 16-byte aligned;
// disp (3 n,) under large_disp.  With du (3 n,): sig is sig_old, and
// sig_yield (ne, 4), dmat (6, 6) or (ne, 6, 6), the shear moduli g and
// H + 3 G h3g (each (ne,) or its scalar) are read; the result is [sig_new,
// sig_test, pgp (bool), elv].  Without du: sig is the given stress and the
// result is [elv].  weights (ne,) scales elv.
std::vector<at::Tensor> stress_update(const at::Tensor& coords, const at::Tensor& table,
                                      const std::optional<at::Tensor>& disp,
                                      const std::optional<at::Tensor>& du, const at::Tensor& sig,
                                      const std::optional<at::Tensor>& sig_yield,
                                      const std::optional<at::Tensor>& dmat,
                                      const std::optional<at::Tensor>& g,
                                      const std::optional<at::Tensor>& h3g, double g_s,
                                      double h3g_s, const std::optional<at::Tensor>& weights,
                                      bool large_disp) {
  const auto dev = coords.device();
  const auto dt = coords.scalar_type();
  TORCH_CHECK(coords.is_cuda(), "stress_update: coords must be on a CUDA device");
  TORCH_CHECK(dt == at::kFloat || dt == at::kDouble,
              "stress_update: dtype must be float32 or float64, got ", dt);
  const bool given = !du;
  TORCH_CHECK(!large_disp || disp, "stress_update: large_disp reads disp");
  TORCH_CHECK(given || (sig_yield && dmat), "stress_update: the update reads sig_yield and dmat");
  const std::optional<at::Tensor>* floats[] = {&disp, &du, &sig_yield, &dmat, &g, &h3g, &weights};
  TORCH_CHECK(table.device() == dev && sig.device() == dev && sig.scalar_type() == dt,
              "stress_update: table and sig must be on coords' device, sig of its dtype");
  for (const auto* t : floats)
    TORCH_CHECK(!*t || ((*t)->device() == dev && (*t)->scalar_type() == dt &&
                        (*t)->is_contiguous()),
                "stress_update: every float tensor must be contiguous, on coords' device and "
                "of its dtype");
  TORCH_CHECK(table.scalar_type() == at::kInt, "stress_update: the node table must be int32");
  const long long ne = table.dim() == 2 ? table.size(1) : -1;
  TORCH_CHECK(coords.dim() == 2 && coords.size(1) == 3 && coords.size(0) <= 0x7fffffffLL &&
                  ne >= 0 && table.size(0) == 10 && sig.dim() == 3 && sig.size(0) == ne &&
                  sig.size(1) == 4 && sig.size(2) == 6,
              "stress_update: expected coords (nn, 3), table (10, ne), sig (ne, 4, 6)");
  TORCH_CHECK(coords.is_contiguous() && table.is_contiguous() && sig.is_contiguous() &&
                  reinterpret_cast<uintptr_t>(sig.data_ptr()) % 16 == 0,
              "stress_update: coords, table and sig must be contiguous, sig 16-byte aligned");
  // the node rows of disp and du: every node of coords
  for (const auto* t : {&disp, &du})
    TORCH_CHECK(!*t || ((*t)->dim() == 1 && (*t)->size(0) % 3 == 0 &&
                        (*t)->size(0) >= 3 * coords.size(0)),
                "stress_update: expected disp and du (3 n,), n at least coords' rows");
  long long dstride = 0;
  if (!given) {
    TORCH_CHECK(sig_yield->dim() == 2 && sig_yield->size(0) == ne && sig_yield->size(1) == 4,
                "stress_update: expected sig_yield (ne, 4)");
    TORCH_CHECK((dmat->dim() == 2 && dmat->size(0) == 6 && dmat->size(1) == 6) ||
                    (dmat->dim() == 3 && dmat->size(0) == ne && dmat->size(1) == 6 &&
                     dmat->size(2) == 6),
                "stress_update: expected dmat (6, 6) or (ne, 6, 6)");
    dstride = dmat->dim() == 3 ? 36 : 0;
  }
  for (const auto* t : {&g, &h3g, &weights})
    TORCH_CHECK(!*t || ((*t)->dim() == 1 && (*t)->size(0) == ne),
                "stress_update: expected g, h3g and weights (ne,)");
  const c10::cuda::CUDAGuard guard(dev);
  at::Tensor elv = at::empty({ne, 30}, coords.options());
  at::Tensor sig_new, sig_test, pgp;
  if (!given) {
    sig_new = at::empty_like(sig);
    sig_test = at::empty_like(sig);
    pgp = at::empty({ne, 4}, coords.options().dtype(at::kBool));
  }
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  const int* nodes = table.data_ptr<int>();
  auto* flags = given ? nullptr : reinterpret_cast<uint32_t*>(pgp.data_ptr<bool>());
  const int large = large_disp ? 1 : 0;
  int err = 0;
  if (dt == at::kFloat)
    err = fcvm_stress_update_f32(
        coords.data_ptr<float>(), nodes, ptr<float>(disp), ptr<float>(du),
        sig.data_ptr<float>(), ptr<float>(sig_yield), ptr<float>(dmat), dstride, ptr<float>(g),
        ptr<float>(h3g), g_s, h3g_s, ptr<float>(weights),
        given ? nullptr : sig_new.data_ptr<float>(), given ? nullptr : sig_test.data_ptr<float>(),
        flags, elv.data_ptr<float>(), ne, large, stream);
  else
    err = fcvm_stress_update_f64(
        coords.data_ptr<double>(), nodes, ptr<double>(disp), ptr<double>(du),
        sig.data_ptr<double>(), ptr<double>(sig_yield), ptr<double>(dmat), dstride,
        ptr<double>(g), ptr<double>(h3g), g_s, h3g_s, ptr<double>(weights),
        given ? nullptr : sig_new.data_ptr<double>(),
        given ? nullptr : sig_test.data_ptr<double>(), flags, elv.data_ptr<double>(), ne, large,
        stream);
  TORCH_CHECK(err == 0, "stress_update: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  if (given) return {elv};
  return {sig_new, sig_test, pgp, elv};
}

// K2's node pass over a write-form segment plan of elv's 3-wide rows (order,
// offsets, segs, holes: every one of the rows output rows a group or a
// hole): [qin (3 rows,)], or with glv, fixmask and ticket (int32 (1,), 0
// before and after) the residual form's [qin, relax (fixmask (lbd1 glv -
// qin)), error (0-dim)], error = ||fixmask (lbd1 glv - qin)|| / qnorm.
std::vector<at::Tensor> node_force(const at::Tensor& elv, const at::Tensor& order,
                                   const at::Tensor& offsets, const at::Tensor& segs,
                                   const at::Tensor& holes, int64_t rows,
                                   const std::optional<at::Tensor>& glv,
                                   const std::optional<at::Tensor>& fixmask,
                                   const std::optional<at::Tensor>& ticket, double lbd1,
                                   double relax, double qnorm) {
  const auto dev = elv.device();
  const auto dt = elv.scalar_type();
  TORCH_CHECK(elv.is_cuda(), "node_force: elv must be on a CUDA device");
  TORCH_CHECK(dt == at::kFloat || dt == at::kDouble,
              "node_force: dtype must be float32 or float64, got ", dt);
  const bool residual = glv.has_value();
  TORCH_CHECK(residual == fixmask.has_value() && residual == ticket.has_value(),
              "node_force: the residual form takes glv, fixmask and ticket together");
  for (const at::Tensor* t : {&order, &offsets, &segs, &holes})
    TORCH_CHECK(t->device() == dev && t->scalar_type() == at::kInt && t->dim() == 1 &&
                    t->is_contiguous(),
                "node_force: the plan's order, offsets, segs and holes must be contiguous "
                "int32 vectors on elv's device");
  const long long nu = segs.size(0), nholes = holes.size(0);
  TORCH_CHECK(elv.is_contiguous() && elv.numel() % 3 == 0 && offsets.size(0) == nu + 1 &&
                  order.size(0) <= elv.numel() / 3 && nu + nholes == rows,
              "node_force: expected contiguous elv of 3-wide rows, offsets (nu + 1,), order "
              "at most its rows, and segs and holes covering the ", rows, " output rows");
  if (residual) {
    for (const at::Tensor* t : {&*glv, &*fixmask})
      TORCH_CHECK(t->device() == dev && t->scalar_type() == dt && t->dim() == 1 &&
                      t->size(0) == 3 * rows && t->is_contiguous(),
                  "node_force: glv and fixmask must be contiguous (3 rows,) of elv's dtype "
                  "and device");
    TORCH_CHECK(ticket->device() == dev && ticket->scalar_type() == at::kInt &&
                    ticket->numel() == 1,
                "node_force: ticket must be one int32 on elv's device");
  }
  const c10::cuda::CUDAGuard guard(dev);
  at::Tensor qin = at::empty({3 * rows}, elv.options());
  at::Tensor r, error, partials;
  if (residual) {
    r = at::empty({3 * rows}, elv.options());
    error = at::empty({}, elv.options());
    partials = at::empty({std::max<long long>(fcvm_node_force_blocks(rows), 1)},
                         elv.options().dtype(at::kDouble));
  }
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  auto* part = residual ? partials.data_ptr<double>() : nullptr;
  auto* tick = residual ? reinterpret_cast<unsigned*>(ticket->data_ptr<int>()) : nullptr;
  const int* tabs[4] = {order.data_ptr<int>(), offsets.data_ptr<int>(), segs.data_ptr<int>(),
                        holes.data_ptr<int>()};
  int err = 0;
  if (dt == at::kFloat)
    err = fcvm_node_force_f32(elv.data_ptr<float>(), tabs[0], tabs[1], tabs[2], tabs[3], nu,
                              nholes, qin.data_ptr<float>(), ptr<float>(glv),
                              ptr<float>(fixmask), residual ? r.data_ptr<float>() : nullptr,
                              part, tick, residual ? error.data_ptr<float>() : nullptr, lbd1,
                              relax, qnorm, stream);
  else
    err = fcvm_node_force_f64(elv.data_ptr<double>(), tabs[0], tabs[1], tabs[2], tabs[3], nu,
                              nholes, qin.data_ptr<double>(), ptr<double>(glv),
                              ptr<double>(fixmask), residual ? r.data_ptr<double>() : nullptr,
                              part, tick, residual ? error.data_ptr<double>() : nullptr, lbd1,
                              relax, qnorm, stream);
  TORCH_CHECK(err == 0, "node_force: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  if (!residual) return {qin};
  return {qin, r, error};
}

// K3: the element blocks of the elements ne (perm's length, or the table's
// columns) of one form (0 elastic, 1 tangent, 2 geometric), from coords (nn,
// 3) (plus disp (3 n,) when given), the int32 node table (10, nt) and, by
// input element, dmat (6, 6) or (nt, 6, 6) (elastic, tangent), sig (nt, 4,
// 6) (tangent, geometric), pgp bool (nt, 4) and g and h (nt,) or neither
// (then g3fac_s) (tangent), weights (nt,); perm (ne,) int64: the input
// element of each output element.  Returns [the element-major blocks (30, 30,
// ne)] when full, then [K1's packed tiles (ceil(ne / tile), 465, tile)]
// when tile > 0, then [the compact diagonal (10, ne, 8)] when diag, in that
// order.
std::vector<at::Tensor> form_blocks(int64_t form, const at::Tensor& coords,
                                    const std::optional<at::Tensor>& disp,
                                    const at::Tensor& table, const std::optional<at::Tensor>& perm,
                                    const std::optional<at::Tensor>& dmat,
                                    const std::optional<at::Tensor>& sig,
                                    const std::optional<at::Tensor>& pgp,
                                    const std::optional<at::Tensor>& g,
                                    const std::optional<at::Tensor>& h, double g3fac_s,
                                    const std::optional<at::Tensor>& weights, bool full,
                                    int64_t tile, bool diag) {
  const auto dev = coords.device();
  const auto dt = coords.scalar_type();
  TORCH_CHECK(coords.is_cuda(), "form_blocks: coords must be on a CUDA device");
  TORCH_CHECK(dt == at::kFloat || dt == at::kDouble,
              "form_blocks: dtype must be float32 or float64, got ", dt);
  TORCH_CHECK(form >= 0 && form <= 2, "form_blocks: form must be 0, 1 or 2, got ", form);
  TORCH_CHECK(full || tile > 0 || diag, "form_blocks: nothing to write");
  TORCH_CHECK(tile == 0 || tile % (128 / static_cast<int64_t>(coords.element_size())) == 0,
              "form_blocks: tile ", tile, " is not a multiple of the kernel's element tile");
  TORCH_CHECK(coords.dim() == 2 && coords.size(1) == 3 && coords.is_contiguous(),
              "form_blocks: expected contiguous coords (nn, 3)");
  TORCH_CHECK(table.device() == dev && table.scalar_type() == at::kInt && table.dim() == 2 &&
                  table.size(0) == 10 && table.is_contiguous(),
              "form_blocks: the node table must be a contiguous int32 (10, nt) on coords' "
              "device");
  const long long nt = table.size(1);
  long long ne = nt;
  if (perm) {
    TORCH_CHECK(perm->device() == dev && perm->scalar_type() == at::kLong &&
                    perm->dim() == 1 && perm->is_contiguous(),
                "form_blocks: perm must be a contiguous int64 vector on coords' device");
    ne = perm->size(0);
  }
  TORCH_CHECK(ne < (1LL << 31) / 30, "form_blocks: ", ne, " elements are too many");
  const bool tangent = form == 1, reads_d = form != 2, reads_sig = form != 0;
  TORCH_CHECK(!reads_d || dmat, "form_blocks: the elastic and tangent forms read dmat");
  TORCH_CHECK(!reads_sig || sig, "form_blocks: the tangent and geometric forms read sig");
  TORCH_CHECK(!tangent || pgp, "form_blocks: the tangent form reads pgp");
  TORCH_CHECK(g.has_value() == h.has_value(), "form_blocks: g and h come together");
  const std::optional<at::Tensor>* floats[] = {&disp, &dmat, &sig, &g, &h, &weights};
  for (const auto* t : floats)
    TORCH_CHECK(!*t || ((*t)->device() == dev && (*t)->scalar_type() == dt &&
                        (*t)->is_contiguous()),
                "form_blocks: every float tensor must be contiguous, on coords' device and of "
                "its dtype");
  TORCH_CHECK(!disp || (disp->dim() == 1 && disp->size(0) % 3 == 0 &&
                        disp->size(0) >= 3 * coords.size(0)),
              "form_blocks: expected disp (3 n,), n at least coords' rows");
  long long dstride = 0;
  if (reads_d) {
    TORCH_CHECK((dmat->dim() == 2 && dmat->size(0) == 6 && dmat->size(1) == 6) ||
                    (dmat->dim() == 3 && dmat->size(0) == nt && dmat->size(1) == 6 &&
                     dmat->size(2) == 6),
                "form_blocks: expected dmat (6, 6) or (nt, 6, 6)");
    dstride = dmat->dim() == 3 ? 36 : 0;
  }
  TORCH_CHECK(!reads_sig || (sig->dim() == 3 && sig->size(0) == nt && sig->size(1) == 4 &&
                             sig->size(2) == 6),
              "form_blocks: expected sig (nt, 4, 6)");
  if (tangent)
    TORCH_CHECK(pgp->device() == dev && pgp->scalar_type() == at::kBool && pgp->dim() == 2 &&
                    pgp->size(0) == nt && pgp->size(1) == 4 && pgp->is_contiguous(),
                "form_blocks: expected a contiguous bool pgp (nt, 4)");
  for (const auto* t : {&g, &h, &weights})
    TORCH_CHECK(!*t || ((*t)->dim() == 1 && (*t)->size(0) == nt),
                "form_blocks: expected g, h and weights (nt,)");
  const c10::cuda::CUDAGuard guard(dev);
  std::vector<at::Tensor> out;
  at::Tensor esm_t, packed, sectors;
  if (full) {
    esm_t = at::empty({30, 30, ne}, coords.options());
    out.push_back(esm_t);
  }
  const long long npad = tile > 0 ? (ne + tile - 1) / tile * tile : ne;
  if (tile > 0) {
    packed = at::empty({npad / tile, 465, tile}, coords.options());
    out.push_back(packed);
  }
  if (diag) {
    sectors = at::empty({10, ne, 8}, coords.options());
    out.push_back(sectors);
  }
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  const int* nodes = table.data_ptr<int>();
  const auto* pm =
      perm ? reinterpret_cast<const long long*>(perm->data_ptr<int64_t>()) : nullptr;
  const auto* flags = tangent ? reinterpret_cast<const unsigned char*>(pgp->data_ptr<bool>())
                              : nullptr;
  int err = 0;
  if (dt == at::kFloat)
    err = fcvm_form_blocks_f32(static_cast<int>(form), coords.data_ptr<float>(), ptr<float>(disp),
                               nodes, nt, pm, reads_d ? ptr<float>(dmat) : nullptr, dstride,
                               reads_sig ? ptr<float>(sig) : nullptr, flags,
                               tangent ? ptr<float>(g) : nullptr,
                               tangent ? ptr<float>(h) : nullptr, g3fac_s, ptr<float>(weights),
                               full ? esm_t.data_ptr<float>() : nullptr,
                               tile > 0 ? packed.data_ptr<float>() : nullptr,
                               diag ? sectors.data_ptr<float>() : nullptr, ne, npad, tile,
                               stream);
  else
    err = fcvm_form_blocks_f64(static_cast<int>(form), coords.data_ptr<double>(),
                               ptr<double>(disp), nodes, nt, pm,
                               reads_d ? ptr<double>(dmat) : nullptr, dstride,
                               reads_sig ? ptr<double>(sig) : nullptr, flags,
                               tangent ? ptr<double>(g) : nullptr,
                               tangent ? ptr<double>(h) : nullptr, g3fac_s,
                               ptr<double>(weights), full ? esm_t.data_ptr<double>() : nullptr,
                               tile > 0 ? packed.data_ptr<double>() : nullptr,
                               diag ? sectors.data_ptr<double>() : nullptr, ne, npad, tile,
                               stream);
  TORCH_CHECK(err == 0, "form_blocks: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return out;
}

// K5: the inverse 3x3 nodal blocks (rows, 3, 3) of block Jacobi (form 0,
// fused), their unmasked sums (form 1) or the inverses of given sums nodal
// (rows, 3, 3) (form 2, the tail).  Forms 0 and 1 read K3's compact diagonal
// (10, ne, 8) of ne elements over the write-form plan (order, offsets, segs,
// holes) of their slot-major keys into rows (cols (ne,) int64, when given: the
// diagonal's element of each plan element); forms 0 and 2 read fixmask
// (3 rows,).
at::Tensor jacobi_inverse(int64_t form, const std::optional<at::Tensor>& diag,
                          const std::optional<at::Tensor>& order,
                          const std::optional<at::Tensor>& offsets,
                          const std::optional<at::Tensor>& segs,
                          const std::optional<at::Tensor>& holes, int64_t rows,
                          const std::optional<at::Tensor>& cols,
                          const std::optional<at::Tensor>& fixmask,
                          const std::optional<at::Tensor>& nodal) {
  TORCH_CHECK(form >= 0 && form <= 2, "jacobi_inverse: form must be 0, 1 or 2, got ", form);
  const bool tail = form == 2;
  TORCH_CHECK(tail ? nodal.has_value() : diag.has_value(),
              "jacobi_inverse: the sum reads diag, the tail nodal");
  const at::Tensor& src = tail ? *nodal : *diag;
  const auto dev = src.device();
  const auto dt = src.scalar_type();
  TORCH_CHECK(src.is_cuda(), "jacobi_inverse: its input must be on a CUDA device");
  TORCH_CHECK(dt == at::kFloat || dt == at::kDouble,
              "jacobi_inverse: dtype must be float32 or float64, got ", dt);
  TORCH_CHECK(rows >= 0 && rows < (1LL << 31), "jacobi_inverse: rows out of range");
  if (form != 1)
    TORCH_CHECK(fixmask && fixmask->device() == dev && fixmask->scalar_type() == dt &&
                    fixmask->dim() == 1 && fixmask->size(0) == 3 * rows &&
                    fixmask->is_contiguous(),
                "jacobi_inverse: fixmask must be a contiguous (3 rows,) of the blocks' dtype "
                "and device");
  long long nu = rows, nholes = 0, ne = 0;
  const int* tabs[4] = {nullptr, nullptr, nullptr, nullptr};
  if (tail) {
    TORCH_CHECK(nodal->dim() == 3 && nodal->size(0) == rows && nodal->size(1) == 3 &&
                    nodal->size(2) == 3 && nodal->is_contiguous(),
                "jacobi_inverse: expected contiguous nodal blocks (rows, 3, 3)");
  } else {
    TORCH_CHECK(diag->dim() == 3 && diag->size(0) == 10 && diag->size(2) == 8 &&
                    diag->is_contiguous() &&
                    reinterpret_cast<uintptr_t>(diag->data_ptr()) % 16 == 0,
                "jacobi_inverse: expected K3's contiguous, 16-byte aligned diagonal (10, ne, 8)");
    ne = diag->size(1);
    TORCH_CHECK(ne > 0 && 10 * ne < (1LL << 31), "jacobi_inverse: ne out of range");
    const std::optional<at::Tensor>* plan[] = {&order, &offsets, &segs, &holes};
    for (int i = 0; i < 4; ++i) {
      const auto& t = *plan[i];
      TORCH_CHECK(t && t->device() == dev && t->scalar_type() == at::kInt && t->dim() == 1 &&
                      t->is_contiguous(),
                  "jacobi_inverse: the plan's order, offsets, segs and holes must be "
                  "contiguous int32 vectors on the diagonal's device");
      tabs[i] = t->data_ptr<int>();
    }
    nu = segs->size(0);
    nholes = holes->size(0);
    TORCH_CHECK(!cols || (cols->device() == dev && cols->scalar_type() == at::kLong &&
                          cols->dim() == 1 && cols->size(0) == ne && cols->is_contiguous()),
                "jacobi_inverse: cols must be a contiguous int64 (ne,) on the diagonal's device");
    TORCH_CHECK(offsets->size(0) == nu + 1 && order->size(0) <= 10 * ne && nu + nholes == rows,
                "jacobi_inverse: expected offsets (nu + 1,), order at most 10 ne and segs and "
                "holes covering the ", rows, " rows");
  }
  const auto* cols_ptr =
      tail || !cols ? nullptr : reinterpret_cast<const long long*>(cols->data_ptr<int64_t>());
  const c10::cuda::CUDAGuard guard(dev);
  at::Tensor out = at::empty({rows, 3, 3}, src.options());
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  int err = 0;
  if (dt == at::kFloat)
    err = fcvm_jacobi_inverse_f32(static_cast<int>(form), tail ? nullptr : diag->data_ptr<float>(),
                                  tabs[0], tabs[1], tabs[2], tabs[3], nu, nholes, ne, cols_ptr,
                                  ptr<float>(fixmask), tail ? nodal->data_ptr<float>() : nullptr,
                                  out.data_ptr<float>(), stream);
  else
    err = fcvm_jacobi_inverse_f64(static_cast<int>(form),
                                  tail ? nullptr : diag->data_ptr<double>(), tabs[0], tabs[1],
                                  tabs[2], tabs[3], nu, nholes, ne, cols_ptr,
                                  ptr<double>(fixmask),
                                  tail ? nodal->data_ptr<double>() : nullptr,
                                  out.data_ptr<double>(), stream);
  TORCH_CHECK(err == 0, "jacobi_inverse: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return out;
}

// the name and text of a CUDA error code
std::string cuda_error(int64_t code) {
  const auto e = static_cast<cudaError_t>(code);
  return std::string(cudaGetErrorName(e)) + ": " + cudaGetErrorString(e);
}

at::Tensor soa_matvec(const at::Tensor& esm_t, const at::Tensor& ue_t, int64_t tile) {
  TORCH_CHECK(esm_t.is_cuda() && ue_t.device() == esm_t.device(),
              "soa_matvec: both tensors must be on one CUDA device");
  TORCH_CHECK(esm_t.scalar_type() == at::kFloat && ue_t.scalar_type() == at::kFloat,
              "soa_matvec: esm_t and ue_t must be float32");
  TORCH_CHECK(esm_t.dim() == 3 && esm_t.size(0) == 30 && esm_t.size(1) == 30 &&
                  ue_t.dim() == 2 && ue_t.size(0) == 30 &&
                  ue_t.size(1) == esm_t.size(2),
              "soa_matvec: expected esm_t (30, 30, ne) and ue_t (30, ne)");
  TORCH_CHECK(esm_t.is_contiguous() && ue_t.is_contiguous(),
              "soa_matvec: inputs must be contiguous");
  const long long ne = esm_t.size(2);
  TORCH_CHECK(tile > 0 && tile <= 0x7fffffff && ne % tile == 0,
              "soa_matvec: ne = ", ne, " is not a multiple of tile = ", tile);
  const c10::cuda::CUDAGuard guard(esm_t.device());
  at::Tensor out = at::empty_like(ue_t);
  const int err = fcvm_soa_matvec_f32(esm_t.data_ptr<float>(), ue_t.data_ptr<float>(),
                                      out.data_ptr<float>(), ne, static_cast<int>(tile),
                                      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "soa_matvec: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return out;
}

at::Tensor bw_read(const at::Tensor& x, int64_t k, int64_t chunk_rows) {
  TORCH_CHECK(x.is_cuda(), "bw_read: x must be on a CUDA device");
  TORCH_CHECK(x.scalar_type() == at::kFloat, "bw_read: x must be float32");
  TORCH_CHECK(x.dim() == 2 && x.size(1) == 128 && x.size(0) > 0,
              "bw_read: expected x (rows, 128)");
  TORCH_CHECK(x.is_contiguous() && reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0,
              "bw_read: x must be contiguous and 16-byte aligned");
  TORCH_CHECK(chunk_rows > 0 && x.size(0) % chunk_rows == 0,
              "bw_read: rows = ", x.size(0), " is not a multiple of chunk_rows = ",
              chunk_rows);
  TORCH_CHECK(k >= 1 && k <= 8, "bw_read: k must be in 1..8, got ", k);
  const c10::cuda::CUDAGuard guard(x.device());
  const int nblocks = fcvm_bw_read_blocks(x.size(0), chunk_rows, x.get_device());
  TORCH_CHECK(nblocks > 0, "bw_read: could not read the device's SM count");
  at::Tensor partial = at::empty({nblocks}, x.options());
  at::Tensor out = at::empty({8, 128}, x.options());
  const int err = fcvm_bw_read_f32(x.data_ptr<float>(), partial.data_ptr<float>(),
                                   out.data_ptr<float>(), x.size(0), chunk_rows,
                                   static_cast<int>(k), nblocks,
                                   c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "bw_read: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return out;
}

}  // namespace

TORCH_LIBRARY(fcvm, m) {
  m.def("block_matvec(Tensor esm_t, Tensor ue_t) -> Tensor");
  m.def("block_matmat(Tensor esm_t, Tensor ue) -> Tensor");
  m.def("khat_matvec(Tensor packed, Tensor elnodes_t, Tensor offsets, Tensor pos, Tensor x, "
        "Tensor? fixmask) -> Tensor");
  m.def("khat_matmat_map(Tensor packed) -> Tensor");
  m.def("khat_matmat(Tensor packed, Tensor map, Tensor elnodes_t, Tensor offsets, Tensor pos, "
        "Tensor ents, Tensor ent_rows, Tensor node_offsets, Tensor node_rows, Tensor x, "
        "Tensor? fixmask, bool identity, bool negate) -> Tensor");
  m.def("segment_sum(Tensor vals, Tensor order, Tensor walk, Tensor? holes, Tensor(a!) out, "
        "int nlong, bool write) -> ()");
  m.def("two_level_apply(Tensor pinv, Tensor qmat, Tensor coarse, int ncf, Tensor fixmask, "
        "Tensor r, Tensor? z_fine) -> Tensor");
  m.def("two_level_apply_block(Tensor pinv, Tensor qmat, Tensor coarse, int ncf, "
        "Tensor fixmask, Tensor r, Tensor? z_fine) -> Tensor");
  m.def("coarse_product(Tensor tiles, Tensor x) -> Tensor");
  m.def("cg_grid(int itemsize, int n, int m, int kd=0, bool block=False) -> int",
        &cg_grid);  // no tensor: any backend
  m.def("cg_layout(int grid, int m, int kd, int n=0, bool block=False) -> int[]", &cg_layout);
  m.def("cg_pass(int step, bool start, Tensor(a!) state, Tensor(b!) scratch, "
        "Tensor(c!) barrier, Tensor(d!) x, Tensor(e!) r, Tensor(f!) p, Tensor(g!) v, Tensor? w, "
        "Tensor? kw_inv, Tensor(h!)? zs, Tensor(i!)? coef, int grid) -> int");
  m.def("stress_update(Tensor coords, Tensor table, Tensor? disp, Tensor? du, Tensor sig, "
        "Tensor? sig_yield, Tensor? dmat, Tensor? g, Tensor? h3g, float g_s, float h3g_s, "
        "Tensor? weights, bool large_disp) -> Tensor[]");
  m.def("node_force(Tensor elv, Tensor order, Tensor offsets, Tensor segs, Tensor holes, "
        "int rows, Tensor? glv, Tensor? fixmask, Tensor(a!)? ticket, float lbd1, float relax, "
        "float qnorm) -> Tensor[]");
  m.def("form_blocks(int form, Tensor coords, Tensor? disp, Tensor table, Tensor? perm, "
        "Tensor? dmat, Tensor? sig, Tensor? pgp, Tensor? g, Tensor? h, float g3fac_s, "
        "Tensor? weights, bool full, int tile, bool diag) -> Tensor[]");
  m.def("jacobi_inverse(int form, Tensor? diag, Tensor? order, Tensor? offsets, Tensor? segs, "
        "Tensor? holes, int rows, Tensor? cols, Tensor? fixmask, Tensor? nodal) -> Tensor");
  m.def("cuda_error(int code) -> str", &cuda_error);
  m.def("soa_matvec(Tensor esm_t, Tensor ue_t, int tile) -> Tensor");
  m.def("bw_read(Tensor x, int k, int chunk_rows) -> Tensor");
}

TORCH_LIBRARY_IMPL(fcvm, CUDA, m) {
  m.impl("block_matvec", &block_matvec);
  m.impl("block_matmat", &block_matmat);
  m.impl("khat_matvec", &khat_matvec);
  m.impl("khat_matmat_map", &khat_matmat_map);
  m.impl("khat_matmat", &khat_matmat);
  m.impl("two_level_apply", &two_level_apply);
  m.impl("two_level_apply_block", &two_level_apply_block);
  m.impl("coarse_product", &coarse_product);
  m.impl("segment_sum", &segment_sum);
  m.impl("cg_pass", &cg_pass);
  m.impl("stress_update", &stress_update);
  m.impl("node_force", &node_force);
  m.impl("form_blocks", &form_blocks);
  m.impl("jacobi_inverse", &jacobi_inverse);
  m.impl("soa_matvec", &soa_matvec);
  m.impl("bw_read", &bw_read);
}
