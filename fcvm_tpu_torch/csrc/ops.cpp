// PyTorch operator bindings of the port's CUDA kernels.
//
// Registers fcvm::block_matvec (K0, csrc/block_matvec.cu) with the dispatcher
// for CUDA tensors, so it is called as torch.ops.fcvm.block_matvec.  The
// kernels themselves keep a plain C interface and include no PyTorch header;
// this file checks the tensors, picks the dtype and passes the current stream.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

extern "C" int fcvm_block_matvec_f32(const float* esm_t, const float* ue_t,
                                     float* out, long long ne, void* stream);
extern "C" int fcvm_block_matvec_f64(const double* esm_t, const double* ue_t,
                                     double* out, long long ne, void* stream);

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

}  // namespace

TORCH_LIBRARY(fcvm, m) {
  m.def("block_matvec(Tensor esm_t, Tensor ue_t) -> Tensor");
}

TORCH_LIBRARY_IMPL(fcvm, CUDA, m) {
  m.impl("block_matvec", &block_matvec);
}
