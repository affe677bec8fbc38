// The PyTorch operator of fma_f32 (csrc/fma_f32.cu):
//
//   lidar_port::fma_f32(Tensor? a, float a_value, Tensor b, Tensor c) -> Tensor
//
// out = fma(a, b, c) elementwise in float32, rounded once, for CUDA float32
// tensors whose shapes broadcast; with a = None, `a` is the scalar a_value.
// Registered for the CUDA dispatch key only, so one call from Python is one
// dispatcher call. The broadcast shape and each operand's strides over it
// (0 along a broadcast dimension) are worked out here from the operands'
// sizes and strides, in arrays on the stack: no view is made and nothing
// is allocated but the output. The kernel reads each operand through its
// strides, with no copies. Errors raise (TORCH_CHECK).
//
// Built with fma_f32.cu into one library by ops/fma_cuda.py::build (nvcc,
// against the installed torch's headers and libraries) and loaded with
// torch.ops.load_library.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

extern "C" {
int fma_f32_max_dims();
const char* fma_f32_error_string(int err);
int fma_f32(const float* a, float a_value, const float* b, const float* c,
            float* out, long long n, int ndim, const long long* size,
            const long long* sa, const long long* sb, const long long* sc,
            void* stream);
}

namespace {

constexpr int kMaxDims = 8;

void check_operand(const char* name, const at::Tensor& t,
                   const at::Device& device) {
  TORCH_CHECK(t.scalar_type() == at::kFloat && t.device() == device,
              "fma_f32: ", name, " must be float32 on ", device, ", got ",
              t.scalar_type(), " on ", t.device());
}

// Widens `shape` (ndim dimensions, right-aligned) by the operand's sizes.
void broadcast(const char* name, const at::Tensor& t, int ndim,
               int64_t* shape) {
  const at::IntArrayRef sizes = t.sizes();
  const int lead = ndim - static_cast<int>(sizes.size());
  for (int d = lead; d < ndim; ++d) {
    const int64_t s = sizes[d - lead];
    if (s == 1) continue;
    TORCH_CHECK(shape[d] == 1 || shape[d] == s, "fma_f32: ", name, " of ",
                "shape ", sizes, " does not broadcast to dimension ", d,
                " of size ", shape[d]);
    shape[d] = s;
  }
}

// The operand's strides over the broadcast shape: 0 where it broadcasts.
void strides_over(const at::Tensor& t, int ndim, long long* out) {
  const at::IntArrayRef sizes = t.sizes(), strides = t.strides();
  const int lead = ndim - static_cast<int>(sizes.size());
  for (int d = 0; d < ndim; ++d) {
    out[d] = d < lead || sizes[d - lead] == 1 ? 0 : strides[d - lead];
  }
}

at::Tensor fma_f32_op(const c10::optional<at::Tensor>& a, double a_value,
                      const at::Tensor& b, const at::Tensor& c) {
  const at::Device device = b.device();
  TORCH_CHECK(device.is_cuda(), "fma_f32: needs CUDA tensors, got ", device);
  check_operand("b", b, device);
  check_operand("c", c, device);
  const at::Tensor* ta = a.has_value() ? &*a : nullptr;
  if (ta != nullptr) check_operand("a", *ta, device);
  int64_t ndim = std::max(b.dim(), c.dim());
  if (ta != nullptr) ndim = std::max(ndim, ta->dim());
  TORCH_CHECK(ndim <= kMaxDims && kMaxDims == fma_f32_max_dims(),
              "fma_f32: at most ", kMaxDims, " dimensions, got ", ndim);
  const int nd = static_cast<int>(ndim);
  int64_t shape[kMaxDims];
  for (int d = 0; d < nd; ++d) shape[d] = 1;
  broadcast("b", b, nd, shape);
  broadcast("c", c, nd, shape);
  if (ta != nullptr) broadcast("a", *ta, nd, shape);
  long long size[kMaxDims], sa[kMaxDims], sb[kMaxDims], sc[kMaxDims];
  for (int d = 0; d < nd; ++d) size[d] = shape[d];
  strides_over(b, nd, sb);
  strides_over(c, nd, sc);
  if (ta != nullptr) strides_over(*ta, nd, sa);
  const c10::cuda::CUDAGuard guard(device);
  at::Tensor out = at::empty(at::IntArrayRef(shape, nd), b.options());
  const int err = fma_f32(
      ta != nullptr ? ta->data_ptr<float>() : nullptr,
      static_cast<float>(a_value), b.data_ptr<float>(), c.data_ptr<float>(),
      out.data_ptr<float>(), out.numel(), nd, size, sa, sb, sc,
      c10::cuda::getCurrentCUDAStream().stream());
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
