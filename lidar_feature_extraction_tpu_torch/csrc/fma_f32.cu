// fma_f32: out = fma(a, b, c) elementwise in float32, rounded once
// (__fmaf_rn), for CUDA tensors of one broadcast shape.
//
// The port computes the float32 expressions that XLA:CPU contracts into
// fused multiply-adds under jax.jit with this one operation
// (core/_xla_f32.py::fma; ROADMAP §C18-§C20). Its plain version,
// _xla_f32._fma_plain, emulates the same correctly rounded result in
// float64 with round-to-odd, about 21 elementwise launches; this kernel is
// one launch, with no copies: the operator (fma_f32_op.cpp) expands a, b
// and c to the output's shape as views, and the kernel reads each through
// its strides (a stride of 0 along a broadcast dimension). `a` may instead
// be a scalar argument.
//
// Bound: one read of each operand element the output touches and one
// write, so on an H100 (3.35 TB/s) 16 bytes per element when nothing is
// broadcast; the arithmetic is one FMA per element. The index
// arithmetic (a division per dimension) is the kernel's own cost.
//
// Built with fma_f32_op.cpp into one library by ops/fma_cuda.py::build
// (nvcc, sm_90a, --fmad=false) into build/kernels/ at first use, and
// called through the operator lidar_port::fma_f32.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDims = 8;

struct Layout {
  int ndim;
  long long size[kMaxDims];
  long long sa[kMaxDims], sb[kMaxDims], sc[kMaxDims];
};

__global__ void fma_f32_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               const float* __restrict__ c,
                               float* __restrict__ out, long long n,
                               Layout layout, float a_value) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    long long rem = i, oa = 0, ob = 0, oc = 0;
    for (int d = layout.ndim - 1; d >= 0; --d) {
      const long long idx = rem % layout.size[d];
      rem /= layout.size[d];
      oa += idx * layout.sa[d];
      ob += idx * layout.sb[d];
      oc += idx * layout.sc[d];
    }
    const float av = a != nullptr ? a[oa] : a_value;
    out[i] = __fmaf_rn(av, b[ob], c[oc]);
  }
}

}  // namespace

extern "C" {

int fma_f32_max_dims() { return kMaxDims; }

const char* fma_f32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out[i] = fma(a, b, c) over n elements of the output's shape `size`
// (ndim dimensions, row-major); a, b and c are read through their strides
// in elements (0 along a broadcast dimension). With a == nullptr, `a` is
// the scalar a_value. Returns a cudaError_t (0 on success).
int fma_f32(const float* a, float a_value, const float* b, const float* c,
            float* out, long long n, int ndim, const long long* size,
            const long long* sa, const long long* sb, const long long* sc,
            void* stream) {
  if (ndim < 0 || ndim > kMaxDims) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  Layout layout;
  layout.ndim = ndim;
  for (int d = 0; d < ndim; ++d) {
    layout.size[d] = size[d];
    layout.sa[d] = a != nullptr ? sa[d] : 0;
    layout.sb[d] = sb[d];
    layout.sc[d] = sc[d];
  }
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  fma_f32_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, b, c, out, n,
                                                        layout, a_value);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
