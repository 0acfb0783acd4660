// PyTorch operator bindings of the port's CUDA kernels.
//
// Registers with the dispatcher, for CUDA tensors:
//   fcvm::block_matvec  K0   csrc/block_matvec.cu
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

#include <cstdint>

extern "C" int fcvm_block_matvec_f32(const float* esm_t, const float* ue_t,
                                     float* out, long long ne, void* stream);
extern "C" int fcvm_block_matvec_f64(const double* esm_t, const double* ue_t,
                                     double* out, long long ne, void* stream);
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
  m.def("soa_matvec(Tensor esm_t, Tensor ue_t, int tile) -> Tensor");
  m.def("bw_read(Tensor x, int k, int chunk_rows) -> Tensor");
}

TORCH_LIBRARY_IMPL(fcvm, CUDA, m) {
  m.impl("block_matvec", &block_matvec);
  m.impl("soa_matvec", &soa_matvec);
  m.impl("bw_read", &bw_read);
}
