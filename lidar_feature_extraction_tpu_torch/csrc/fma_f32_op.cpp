// The PyTorch operator of fma_f32 (csrc/fma_f32.cu):
//
//   lidar_port::fma_f32(Tensor? a, float a_value, Tensor b, Tensor c) -> Tensor
//
// out = fma(a, b, c) elementwise in float32, rounded once, for CUDA float32
// tensors whose shapes broadcast; with a = None, `a` is the scalar a_value.
// Registered for the CUDA dispatch key only, so one call from Python is one
// dispatcher call: the broadcast shape, the operands' expanded views and
// their strides are worked out here, and the kernel reads each operand
// through its strides, with no copies. Errors raise (TORCH_CHECK).
//
// Built with fma_f32.cu into one library by ops/fma_cuda.py::build (nvcc,
// against the installed torch's headers and libraries) and loaded with
// torch.ops.load_library.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <vector>

extern "C" {
int fma_f32_max_dims();
const char* fma_f32_error_string(int err);
int fma_f32(const float* a, float a_value, const float* b, const float* c,
            float* out, long long n, int ndim, const long long* size,
            const long long* sa, const long long* sb, const long long* sc,
            void* stream);
}

namespace {

void check_operand(const char* name, const at::Tensor& t,
                   const at::Device& device) {
  TORCH_CHECK(t.scalar_type() == at::kFloat && t.device() == device,
              "fma_f32: ", name, " must be float32 on ", device, ", got ",
              t.scalar_type(), " on ", t.device());
}

at::Tensor fma_f32_op(const c10::optional<at::Tensor>& a, double a_value,
                      const at::Tensor& b, const at::Tensor& c) {
  const at::Device device = b.device();
  TORCH_CHECK(device.is_cuda(), "fma_f32: needs CUDA tensors, got ", device);
  check_operand("b", b, device);
  check_operand("c", c, device);
  std::vector<int64_t> shape = at::infer_size(b.sizes(), c.sizes());
  if (a.has_value()) {
    check_operand("a", *a, device);
    shape = at::infer_size(shape, a->sizes());
  }
  const int ndim = static_cast<int>(shape.size());
  TORCH_CHECK(ndim <= fma_f32_max_dims(), "fma_f32: at most ",
              fma_f32_max_dims(), " dimensions, got ", ndim);
  const c10::cuda::CUDAGuard guard(device);
  at::Tensor out = at::empty(shape, b.options());
  const at::Tensor vb = b.expand(shape), vc = c.expand(shape);
  const at::Tensor va = a.has_value() ? a->expand(shape) : at::Tensor();
  std::vector<long long> size(shape.begin(), shape.end());
  std::vector<long long> sa(ndim, 0), sb(vb.strides().begin(),
                                         vb.strides().end()),
      sc(vc.strides().begin(), vc.strides().end());
  if (a.has_value()) sa.assign(va.strides().begin(), va.strides().end());
  const int err = fma_f32(
      a.has_value() ? va.data_ptr<float>() : nullptr,
      static_cast<float>(a_value), vb.data_ptr<float>(), vc.data_ptr<float>(),
      out.data_ptr<float>(), out.numel(), ndim, size.data(), sa.data(),
      sb.data(), sc.data(), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "fma_f32 launch failed: CUDA error ", err, " (",
              fma_f32_error_string(err), ")");
  return out;
}

}  // namespace

TORCH_LIBRARY(lidar_port, m) {
  m.def("fma_f32(Tensor? a, float a_value, Tensor b, Tensor c) -> Tensor");
}

TORCH_LIBRARY_IMPL(lidar_port, CUDA, m) {
  m.impl("fma_f32", &fma_f32_op);
}
