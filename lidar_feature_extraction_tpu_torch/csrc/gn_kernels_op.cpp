// The PyTorch operators of the fused float32 Gauss-Newton kernels:
//
//   lidar_port::robust_weights(Tensor errors, Tensor valid, int[] blocks,
//                              float huber_k, bool block_medians)
//       -> (Tensor n_valid, Tensor error, Tensor scale, Tensor weights,
//           Tensor block_meds)                          (csrc/robust_weights.cu)
//   lidar_port::gn_update(Tensor D, Tensor A, Tensor b, Tensor q, Tensor t,
//                         float tau) -> (Tensor q, Tensor t, Tensor H,
//                                        Tensor dq_norm, Tensor dt_norm)
//                                                       (csrc/gn_update.cu)
//
// robust_weights: the valid count, error total, MAD scale and Huber weights
// of float32 errors [N] (or a batch [B, N]) under bool flags of the same
// shape, in the reference's rounding, and with block_medians the median of
// each residual block (`blocks`: their lengths, summing to N; block_meds
// [..., blocks], else [..., 0]).
//
// gn_update: the float32 Gauss-Newton update of one problem (D, A [7, 7],
// b [7], q [4], t [3]) or a batch (a leading [B] on each), from the normal
// equations to the updated pose, in the reference's rounding; any strides
// (the kernel reads through them, so the normal_equations operator's views
// go in without copies).
//
// Both are registered for the CUDA dispatch key only, so one call from
// Python is one dispatcher call. Errors raise (TORCH_CHECK). Built with the
// two kernels' sources into one library by ops/gn_kernels_cuda.py::build
// and loaded with torch.ops.load_library.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <tuple>
#include <vector>

extern "C" {
int robust_weights_max_blocks();
const char* robust_weights_error_string(int err);
int robust_weights_f32(const float* errors, const unsigned char* valid,
                       int batch, int n, const long long* sizes, int n_blocks,
                       int with_medians, double huber_k, int* n_valid,
                       float* error, float* scale, float* weights,
                       float* block_meds, void* stream);
const char* gn_update_error_string(int err);
int gn_update_f32(const float* d, const float* a, const float* b,
                  const float* q, const float* t, const long long* sd,
                  const long long* sa, const long long* sb,
                  const long long* sq, const long long* st, int batch,
                  float tau, float* q_out, float* t_out, float* h_out,
                  float* dq_norm, float* dt_norm, void* stream);
}

namespace {

std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor, at::Tensor>
robust_weights_op(const at::Tensor& errors, const at::Tensor& valid,
                  at::IntArrayRef blocks, double huber_k,
                  bool block_medians) {
  const at::Device device = errors.device();
  TORCH_CHECK(device.is_cuda(), "robust_weights: needs CUDA tensors, got ",
              device);
  TORCH_CHECK(errors.scalar_type() == at::kFloat,
              "robust_weights: errors must be float32, got ",
              errors.scalar_type());
  TORCH_CHECK(valid.scalar_type() == at::kBool && valid.device() == device,
              "robust_weights: valid must be bool on ", device, ", got ",
              valid.scalar_type(), " on ", valid.device());
  TORCH_CHECK((errors.dim() == 1 || errors.dim() == 2) &&
                  valid.sizes() == errors.sizes(),
              "robust_weights: errors and valid must be one [N] or [B, N] "
              "shape, got ",
              errors.sizes(), " and ", valid.sizes());
  const bool batch = errors.dim() == 2;
  const at::Tensor e = (batch ? errors : errors.unsqueeze(0)).contiguous();
  const at::Tensor v = (batch ? valid : valid.unsqueeze(0)).contiguous();
  const int64_t bsz = e.size(0), n = e.size(1);
  TORCH_CHECK(n >= 1 && n < (1LL << 31) && bsz < (1LL << 31),
              "robust_weights: N = ", n, ", B = ", bsz, " out of range");
  const int64_t n_blocks = static_cast<int64_t>(blocks.size());
  int64_t total = 0;
  for (const int64_t s : blocks) {
    TORCH_CHECK(s >= 1, "robust_weights: a block of ", s, " errors");
    total += s;
  }
  TORCH_CHECK(!block_medians || (n_blocks >= 1 &&
                                 n_blocks <= robust_weights_max_blocks() &&
                                 total == n),
              "robust_weights: blocks ", blocks, " must be 1 to ",
              robust_weights_max_blocks(), " lengths summing to N = ", n);
  const c10::cuda::CUDAGuard guard(device);
  const auto opts = e.options();
  at::Tensor n_valid = at::empty({bsz}, opts.dtype(at::kInt));
  at::Tensor error = at::empty({bsz}, opts);
  at::Tensor scale = at::empty({bsz}, opts);
  at::Tensor weights = at::empty({bsz, n}, opts);
  at::Tensor meds = at::empty({bsz, block_medians ? n_blocks : 0}, opts);
  const std::vector<long long> sizes(blocks.begin(), blocks.end());
  const int err = robust_weights_f32(
      e.data_ptr<float>(),
      reinterpret_cast<const unsigned char*>(v.data_ptr<bool>()),
      static_cast<int>(bsz), static_cast<int>(n), sizes.data(),
      block_medians ? static_cast<int>(n_blocks) : 0, block_medians ? 1 : 0,
      huber_k, n_valid.data_ptr<int>(), error.data_ptr<float>(),
      scale.data_ptr<float>(), weights.data_ptr<float>(),
      meds.data_ptr<float>(), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "robust_weights launch failed: CUDA error ", err,
              " (", robust_weights_error_string(err), ")");
  if (!batch) {
    return {n_valid.squeeze(0), error.squeeze(0), scale.squeeze(0),
            weights.squeeze(0), meds.squeeze(0)};
  }
  return {n_valid, error, scale, weights, meds};
}

// [B, ...lane_shape] view of an operand, checked.
at::Tensor lanes(const char* name, const at::Tensor& x, bool batch,
                 at::IntArrayRef lane_shape, int64_t bsz,
                 const at::Device& device) {
  TORCH_CHECK(x.scalar_type() == at::kFloat && x.device() == device,
              "gn_update: ", name, " must be float32 on ", device, ", got ",
              x.scalar_type(), " on ", x.device());
  const at::Tensor v = batch ? x : x.unsqueeze(0);
  std::vector<int64_t> want{bsz};
  want.insert(want.end(), lane_shape.begin(), lane_shape.end());
  TORCH_CHECK(v.sizes() == at::IntArrayRef(want), "gn_update: ", name,
              " must be ", at::IntArrayRef(want).slice(batch ? 0 : 1),
              ", got ", x.sizes());
  return v;
}

std::tuple<at::Tensor, at::Tensor, at::Tensor, at::Tensor, at::Tensor>
gn_update_op(const at::Tensor& D, const at::Tensor& A, const at::Tensor& b,
             const at::Tensor& q, const at::Tensor& t, double tau) {
  const at::Device device = D.device();
  TORCH_CHECK(device.is_cuda(), "gn_update: needs CUDA tensors, got ",
              device);
  TORCH_CHECK(D.dim() == 2 || D.dim() == 3,
              "gn_update: D must be [7, 7] or [B, 7, 7], got ", D.sizes());
  const bool batch = D.dim() == 3;
  const int64_t bsz = batch ? D.size(0) : 1;
  TORCH_CHECK(bsz <= (1LL << 31) - 1, "gn_update: B = ", bsz);
  const at::Tensor d = lanes("D", D, batch, {7, 7}, bsz, device);
  const at::Tensor a = lanes("A", A, batch, {7, 7}, bsz, device);
  const at::Tensor bb = lanes("b", b, batch, {7}, bsz, device);
  const at::Tensor qq = lanes("q", q, batch, {4}, bsz, device);
  const at::Tensor tt = lanes("t", t, batch, {3}, bsz, device);
  const c10::cuda::CUDAGuard guard(device);
  const auto opts = d.options();
  at::Tensor q_out = at::empty({bsz, 4}, opts);
  at::Tensor t_out = at::empty({bsz, 3}, opts);
  at::Tensor h_out = at::empty({bsz, 6, 6}, opts);
  at::Tensor dq_norm = at::empty({bsz}, opts);
  at::Tensor dt_norm = at::empty({bsz}, opts);
  const long long sd[3] = {d.stride(0), d.stride(1), d.stride(2)};
  const long long sa[3] = {a.stride(0), a.stride(1), a.stride(2)};
  const long long sb[2] = {bb.stride(0), bb.stride(1)};
  const long long sq[2] = {qq.stride(0), qq.stride(1)};
  const long long st[2] = {tt.stride(0), tt.stride(1)};
  const int err = gn_update_f32(
      d.data_ptr<float>(), a.data_ptr<float>(), bb.data_ptr<float>(),
      qq.data_ptr<float>(), tt.data_ptr<float>(), sd, sa, sb, sq, st,
      static_cast<int>(bsz), static_cast<float>(tau), q_out.data_ptr<float>(),
      t_out.data_ptr<float>(), h_out.data_ptr<float>(),
      dq_norm.data_ptr<float>(), dt_norm.data_ptr<float>(),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "gn_update launch failed: CUDA error ", err, " (",
              gn_update_error_string(err), ")");
  if (!batch) {
    return {q_out.squeeze(0), t_out.squeeze(0), h_out.squeeze(0),
            dq_norm.squeeze(0), dt_norm.squeeze(0)};
  }
  return {q_out, t_out, h_out, dq_norm, dt_norm};
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(lidar_port, m) {
  m.def("robust_weights(Tensor errors, Tensor valid, int[] blocks, "
        "float huber_k, bool block_medians) -> "
        "(Tensor, Tensor, Tensor, Tensor, Tensor)");
  m.def("gn_update(Tensor D, Tensor A, Tensor b, Tensor q, Tensor t, "
        "float tau) -> (Tensor, Tensor, Tensor, Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(lidar_port, CUDA, m) {
  m.impl("robust_weights", &robust_weights_op);
  m.impl("gn_update", &gn_update_op);
}
