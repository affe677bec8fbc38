// The PyTorch operators of normal_equations (csrc/normal_equations.cu):
//
//   lidar_port::normal_equations(Tensor jv, Tensor jw, Tensor j, Tensor wr)
//       -> (Tensor D, Tensor A, Tensor b)
//
// D = jv^T j, A = jw^T j and b = j^T wr of float32 CUDA tensors jv, jw, j
// [M, 7] and wr [M] (or a batch: [B, M, 7] and [B, M]), in XLA:CPU's
// summation order; any strides (the kernel reads through them, no copies).
// Registered for the CUDA dispatch key only. Errors raise (TORCH_CHECK).
//
//   lidar_port::normal_equations_tree(int m) -> Tensor
//
// The kernel's tree of an M-row contraction as a CPU int64 tensor
// [chunks, 3] of (first row, end row, block), so that it can be held to
// core/_xla_dot.py::contraction_tree.
//
// Built with normal_equations.cu into one library by
// ops/normal_equations_cuda.py::build and loaded with
// torch.ops.load_library.

#include <ATen/ATen.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <tuple>

extern "C" {
const char* normal_equations_error_string(int err);
int normal_equations_chunks(int m, int* blocks);
void normal_equations_chunk(int m, int c, int* lo, int* hi, int* block);
int normal_equations_f32(const float* jv, const float* jw, const float* j,
                         const float* wr, const long long* sjv,
                         const long long* sjw, const long long* sj,
                         const long long* swr, int batch, int m, float* work,
                         unsigned* tickets, float* out, void* stream);
}

namespace {

constexpr int64_t kOut = 2 * 49 + 7;
constexpr int64_t kPerChunk = 98;
constexpr int64_t kLaneSums = 8 * 7 + 7;

// [B, M, k] view of a [M, k] or [B, M, k] operand (k = 7), or of wr.
at::Tensor batched(const char* name, const at::Tensor& t, bool batch,
                   const at::Device& device) {
  TORCH_CHECK(t.scalar_type() == at::kFloat && t.device() == device,
              "normal_equations: ", name, " must be float32 on ", device,
              ", got ", t.scalar_type(), " on ", t.device());
  return batch ? t : t.unsqueeze(0);
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> normal_equations_op(
    const at::Tensor& jv, const at::Tensor& jw, const at::Tensor& j,
    const at::Tensor& wr) {
  const at::Device device = j.device();
  TORCH_CHECK(device.is_cuda(), "normal_equations: needs CUDA tensors, got ",
              device);
  const bool batch = j.dim() == 3;
  TORCH_CHECK((j.dim() == 2 || batch) && j.size(-1) == 7,
              "normal_equations: j must be [M, 7] or [B, M, 7], got ",
              j.sizes());
  const at::Tensor v = batched("jv", jv, batch, device);
  const at::Tensor w = batched("jw", jw, batch, device);
  const at::Tensor jj = batched("j", j, batch, device);
  const at::Tensor r = batched("wr", wr, batch, device);
  TORCH_CHECK(v.sizes() == jj.sizes() && w.sizes() == jj.sizes(),
              "normal_equations: jv ", jv.sizes(), " and jw ", jw.sizes(),
              " must have j's shape ", j.sizes());
  TORCH_CHECK(r.dim() == 2 && r.size(0) == jj.size(0) &&
                  r.size(1) == jj.size(1),
              "normal_equations: wr ", wr.sizes(), " must be j's rows");
  const int64_t bsz = jj.size(0), m = jj.size(1);
  TORCH_CHECK(m >= 1 && m < (1LL << 30) && bsz <= 65535,
              "normal_equations: M = ", m, ", B = ", bsz, " out of range");
  const c10::cuda::CUDAGuard guard(device);
  int blocks = 0;
  const int chunks = normal_equations_chunks(static_cast<int>(m), &blocks);
  at::Tensor out = at::empty({bsz, kOut}, jj.options());
  at::Tensor work =
      at::empty({bsz, chunks * kPerChunk + kLaneSums}, jj.options());
  at::Tensor tickets = at::zeros({bsz}, jj.options().dtype(at::kInt));
  const long long sv[3] = {v.stride(0), v.stride(1), v.stride(2)};
  const long long sw[3] = {w.stride(0), w.stride(1), w.stride(2)};
  const long long sj[3] = {jj.stride(0), jj.stride(1), jj.stride(2)};
  const long long sr[2] = {r.stride(0), r.stride(1)};
  const int err = normal_equations_f32(
      v.data_ptr<float>(), w.data_ptr<float>(), jj.data_ptr<float>(),
      r.data_ptr<float>(), sv, sw, sj, sr, static_cast<int>(bsz),
      static_cast<int>(m), work.data_ptr<float>(),
      reinterpret_cast<unsigned*>(tickets.data_ptr<int>()),
      out.data_ptr<float>(), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "normal_equations launch failed: CUDA error ", err,
              " (", normal_equations_error_string(err), ")");
  at::Tensor d = out.narrow(1, 0, 49).view({bsz, 7, 7});
  at::Tensor a = out.narrow(1, 49, 49).view({bsz, 7, 7});
  at::Tensor b = out.narrow(1, 98, 7);
  if (!batch) {
    d = d.squeeze(0);
    a = a.squeeze(0);
    b = b.squeeze(0);
  }
  return {d, a, b};
}

at::Tensor normal_equations_tree(int64_t m) {
  TORCH_CHECK(m >= 1 && m < (1LL << 30), "normal_equations_tree: M = ", m);
  int blocks = 0;
  const int chunks = normal_equations_chunks(static_cast<int>(m), &blocks);
  at::Tensor tree = at::empty({chunks, 3}, at::kLong);
  auto acc = tree.accessor<int64_t, 2>();
  for (int c = 0; c < chunks; ++c) {
    int lo = 0, hi = 0, block = 0;
    normal_equations_chunk(static_cast<int>(m), c, &lo, &hi, &block);
    acc[c][0] = lo;
    acc[c][1] = hi;
    acc[c][2] = block;
  }
  return tree;
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(lidar_port, m) {
  m.def("normal_equations(Tensor jv, Tensor jw, Tensor j, Tensor wr) -> "
        "(Tensor, Tensor, Tensor)");
  m.def("normal_equations_tree(int m) -> Tensor", &normal_equations_tree);
}

TORCH_LIBRARY_IMPL(lidar_port, CUDA, m) {
  m.impl("normal_equations", &normal_equations_op);
}
