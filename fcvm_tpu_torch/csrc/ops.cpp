// PyTorch operator bindings of the port's CUDA kernels.
//
// Registers with the dispatcher, for CUDA tensors:
//   fcvm::block_matvec  K0   csrc/block_matvec.cu
//   fcvm::block_matmat  K0m  csrc/block_matmat.cu
//   fcvm::khat_matvec   K1   csrc/khat_matvec.cu
//   fcvm::two_level_apply  K4  csrc/two_level.cu (around at::mv)
//   fcvm::soa_matvec    K0p  csrc/bw_probe.cu
//   fcvm::bw_read       Kbw  csrc/bw_probe.cu
// so each is called as torch.ops.fcvm.<name>.  The kernels themselves keep a
// plain C interface and include no PyTorch header; this file checks the
// tensors, picks the dtype, allocates outputs and scratch and passes the
// current stream.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <ATen/ops/mv.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <cstdint>
#include <optional>

extern "C" int fcvm_block_matvec_f32(const float* esm_t, const float* ue_t,
                                     float* out, long long ne, void* stream);
extern "C" int fcvm_block_matvec_f64(const double* esm_t, const double* ue_t,
                                     double* out, long long ne, void* stream);
extern "C" int fcvm_block_matmat_f32(const float* esm_t, const float* ue, float* out,
                                     long long ne, int m, void* stream);
extern "C" int fcvm_block_matmat_f64(const double* esm_t, const double* ue, double* out,
                                     long long ne, int m, void* stream);
extern "C" int fcvm_khat_matvec_f32(const float* esm_t, const int* elnodes_t,
                                    const int* offsets, const int* pos, const float* x,
                                    const float* fixmask, float* fe, float* y, long long ne,
                                    long long nn, void* stream);
extern "C" int fcvm_khat_matvec_f64(const double* esm_t, const int* elnodes_t,
                                    const int* offsets, const int* pos, const double* x,
                                    const double* fixmask, double* fe, double* y, long long ne,
                                    long long nn, void* stream);
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
// element-major blocks esm_t (30, 30, ne) and the int32 tables: elnodes_t
// (10, ne), the node-incidence CSR offsets (nn + 1) and pos (10 ne).
at::Tensor khat_matvec(const at::Tensor& esm_t, const at::Tensor& elnodes_t,
                       const at::Tensor& offsets, const at::Tensor& pos, const at::Tensor& x,
                       const std::optional<at::Tensor>& fixmask) {
  TORCH_CHECK(esm_t.is_cuda() && elnodes_t.device() == esm_t.device() &&
                  offsets.device() == esm_t.device() && pos.device() == esm_t.device() &&
                  x.device() == esm_t.device() &&
                  (!fixmask || fixmask->device() == esm_t.device()),
              "khat_matvec: all tensors must be on one CUDA device");
  TORCH_CHECK(x.scalar_type() == esm_t.scalar_type() &&
                  (!fixmask || fixmask->scalar_type() == esm_t.scalar_type()),
              "khat_matvec: esm_t, x and fixmask differ in dtype");
  TORCH_CHECK(elnodes_t.scalar_type() == at::kInt && offsets.scalar_type() == at::kInt &&
                  pos.scalar_type() == at::kInt,
              "khat_matvec: elnodes_t, offsets and pos must be int32");
  const long long ne = esm_t.dim() == 3 ? esm_t.size(2) : -1;
  const long long nn = offsets.dim() == 1 ? offsets.size(0) - 1 : -1;
  TORCH_CHECK(esm_t.dim() == 3 && esm_t.size(0) == 30 && esm_t.size(1) == 30 &&
                  elnodes_t.dim() == 2 && elnodes_t.size(0) == 10 && elnodes_t.size(1) == ne &&
                  nn >= 0 && pos.dim() == 1 && pos.size(0) == 10 * ne && x.dim() == 1 &&
                  x.size(0) == 3 * nn && (!fixmask || fixmask->sizes() == x.sizes()) &&
                  30 * ne <= 0x7fffffffLL,
              "khat_matvec: expected esm_t (30, 30, ne), elnodes_t (10, ne), offsets "
              "(nn + 1), pos (10 ne), x and fixmask (3 nn), 30 ne < 2^31");
  TORCH_CHECK(esm_t.is_contiguous() && elnodes_t.is_contiguous() && offsets.is_contiguous() &&
                  pos.is_contiguous() && x.is_contiguous() &&
                  (!fixmask || fixmask->is_contiguous()),
              "khat_matvec: inputs must be contiguous");
  const c10::cuda::CUDAGuard guard(esm_t.device());
  at::Tensor fe = at::empty({30, ne}, x.options());
  at::Tensor y = at::empty_like(x);
  void* stream = c10::cuda::getCurrentCUDAStream().stream();
  const int* tables[3] = {elnodes_t.data_ptr<int>(), offsets.data_ptr<int>(),
                          pos.data_ptr<int>()};
  int err = 0;
  switch (esm_t.scalar_type()) {
    case at::kFloat:
      err = fcvm_khat_matvec_f32(esm_t.data_ptr<float>(), tables[0], tables[1], tables[2],
                                 x.data_ptr<float>(),
                                 fixmask ? fixmask->data_ptr<float>() : nullptr,
                                 fe.data_ptr<float>(), y.data_ptr<float>(), ne, nn, stream);
      break;
    case at::kDouble:
      err = fcvm_khat_matvec_f64(esm_t.data_ptr<double>(), tables[0], tables[1], tables[2],
                                 x.data_ptr<double>(),
                                 fixmask ? fixmask->data_ptr<double>() : nullptr,
                                 fe.data_ptr<double>(), y.data_ptr<double>(), ne, nn, stream);
      break;
    default:
      TORCH_CHECK(false, "khat_matvec: dtype must be float32 or float64, got ",
                  esm_t.scalar_type());
  }
  TORCH_CHECK(err == 0, "khat_matvec: kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  return y;
}

// K4: z = z_fine + P Q Kc^-1 Q^T (P r), z_fine = pinv r per node unless given.
at::Tensor two_level_apply(const at::Tensor& pinv, const at::Tensor& qmat,
                           const at::Tensor& coarse_inv, const at::Tensor& fixmask,
                           const at::Tensor& r, const std::optional<at::Tensor>& z_fine) {
  TORCH_CHECK(r.is_cuda() && pinv.device() == r.device() && qmat.device() == r.device() &&
                  coarse_inv.device() == r.device() && fixmask.device() == r.device() &&
                  (!z_fine || z_fine->device() == r.device()),
              "two_level_apply: all tensors must be on one CUDA device");
  const auto dt = r.scalar_type();
  TORCH_CHECK(pinv.scalar_type() == dt && qmat.scalar_type() == dt &&
                  coarse_inv.scalar_type() == dt && fixmask.scalar_type() == dt &&
                  (!z_fine || z_fine->scalar_type() == dt),
              "two_level_apply: the tensors differ in dtype");
  const long long nn = r.dim() == 1 ? r.size(0) / 3 : -1;
  const long long nm = qmat.dim() == 3 ? qmat.size(2) : -1;
  const long long ncl = nm > 0 && coarse_inv.dim() == 2 ? coarse_inv.size(0) / nm : -1;
  TORCH_CHECK(r.dim() == 1 && r.size(0) == 3 * nn && fixmask.sizes() == r.sizes() &&
                  (!z_fine || z_fine->sizes() == r.sizes()) && pinv.dim() == 3 &&
                  pinv.size(0) == nn && pinv.size(1) == 3 && pinv.size(2) == 3 &&
                  (nm == 6 || nm == 12) && qmat.size(1) == 3 && ncl > 0 &&
                  coarse_inv.size(0) == nm * ncl && coarse_inv.size(1) == nm * ncl &&
                  qmat.size(0) % ncl == 0 && qmat.size(0) >= nn &&
                  qmat.size(0) / ncl <= 0x7fffffffLL && ncl <= 0x7fffffffLL,
              "two_level_apply: expected r, fixmask (3 nn), pinv (nn, 3, 3), qmat (ncl cs, 3, "
              "nm) with nm 6 or 12 and ncl cs >= nn, coarse_inv (nm ncl, nm ncl)");
  // coarse_inv reaches only at::mv, which takes any layout (cholesky_inverse
  // gives column-major)
  TORCH_CHECK(pinv.is_contiguous() && qmat.is_contiguous() && fixmask.is_contiguous() &&
                  r.is_contiguous() && (!z_fine || z_fine->is_contiguous()),
              "two_level_apply: inputs other than coarse_inv must be contiguous");
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
  const at::Tensor zc = at::mv(coarse_inv, rc);
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
  m.def("khat_matvec(Tensor esm_t, Tensor elnodes_t, Tensor offsets, Tensor pos, Tensor x, "
        "Tensor? fixmask) -> Tensor");
  m.def("two_level_apply(Tensor pinv, Tensor qmat, Tensor coarse_inv, Tensor fixmask, "
        "Tensor r, Tensor? z_fine) -> Tensor");
  m.def("soa_matvec(Tensor esm_t, Tensor ue_t, int tile) -> Tensor");
  m.def("bw_read(Tensor x, int k, int chunk_rows) -> Tensor");
}

TORCH_LIBRARY_IMPL(fcvm, CUDA, m) {
  m.impl("block_matvec", &block_matvec);
  m.impl("block_matmat", &block_matmat);
  m.impl("khat_matvec", &khat_matvec);
  m.impl("two_level_apply", &two_level_apply);
  m.impl("soa_matvec", &soa_matvec);
  m.impl("bw_read", &bw_read);
}
