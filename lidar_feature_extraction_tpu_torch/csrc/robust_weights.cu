// robust_weights: what a float32 Gauss-Newton iteration computes from its
// errors before the update, for one problem or a batch in one launch, in
// the order and rounding of the JAX package's jitted step
// (lidar_feature_extraction_tpu/ops/gauss_newton.py gn_iteration and the
// while-loop body; lidar_feature_extraction_tpu/core/stats.py). Its plain
// version is core/stats.py::robust_weights_plain, which computes the same
// bits with the port's float32 forms (core/_xla_f32.py as xf,
// core/_xla_dot.py as xd):
//
// - n_valid, the count of valid errors;
// - the total of the valid errors as xd.reduce_sum reduces it: the row
//   padded with zeros to a multiple of 32 (half of the padding in front),
//   each window of 32 summed in order, repeated until at most 32 are left,
//   which are added in order to +0;
// - the MAD scale of masked_scale_bisect: 1.4826 times the _wide_median of
//   |e - _wide_median(e)|, each median 3 rounds of 256 thresholds
//   t_k = fma(w, k, lo) (w = (hi - lo) / 256), j = #{k : count(v <= t_k) <
//   (n + 1) / 2} (at most 255), lo, hi = fma(w, j, lo), fma(w, j + 1, lo),
//   then 0.5 (lo + hi), NaN when nothing is valid;
// - the Huber weights of the valid errors over scale + 1e-16
//   (huber_derivative): 1 below k^2, else k * xf.rsqrt(e), the x86
//   vrsqrtps estimate in closed form (float64 8192 / sqrt(mid) - 4096,
//   rounded half to even) and two fused Newton steps;
// - for the fused loop, the _wide_median of each residual block's errors.
// Every FMA is __fmaf_rn, every division IEEE (__fdiv_rn), float64 steps
// __d*_rn, and the file is built with --fmad=false, so nothing else is
// contracted.
//
// It ports no TPU kernel: the reference leaves this arithmetic to XLA. It
// replaces the ~360 launches per iteration of the chains above with one.
//
// The counts are exact integers whatever the order, so the medians need no
// fixed order; what must not change is which values count below each
// threshold. t_k does not decrease in k (w >= 0 and rounding is monotone),
// so a valid value counts below t_k exactly from the first k with
// v <= t_k on: a binary search over the fma-computed t_k themselves (never
// an arithmetic bucket index) puts it in that bucket of a histogram, whose
// running sum is count(v <= t_k), and __syncthreads_count over the 256
// buckets gives j.
//
// Bound: per lane N errors (4 bytes) and flags (1 byte) read and N weights
// written, 9 bytes per correspondence, ~0.03 us at N = 10,240 and 3.35
// TB/s; the medians are 12 barrier-separated rounds (2 medians, or 4 with
// two block medians, of 3 rounds each) over the lane's N values, so the
// kernel is bound by its launch and those rounds. One block of 1,024
// threads per lane and task: block 0 the count, total, scale and weights,
// block 1 + s the median of residual block s, side by side. A block copies
// its errors and flags into shared memory once where they fit (5 bytes
// each, up to ~45,000 correspondences), else reads them from global memory
// (L2) on every pass.
//
// Built with gn_update.cu and gn_kernels_op.cpp into one library by
// ops/gn_kernels_cuda.py::build (nvcc, sm_90a, --fmad=false) into
// build/kernels/ at first use, and called through the operator
// lidar_port::robust_weights.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kBranch = 256;
constexpr int kRounds = 3;
constexpr int kMaxBlocks = 16;
// Shared memory a block may ask for (H100: 227 KB), less this file's static
// shared memory.
constexpr int kMaxDynamicSmem = 227 * 1024 - 4096;
constexpr double kMadConsistency = 1.482602218505602;

struct Params {
  const float* errors;         // [B, N], contiguous
  const unsigned char* valid;  // [B, N], contiguous
  int n;
  int n_blocks;                // residual blocks; their medians if > 0
  int size[kMaxBlocks];
  int staged;                  // copy errors and flags to shared memory
  int tree_floats;             // the error total's levels in shared memory
  float huber_k;
  float huber_kk;              // float32(k * k)
  int* n_valid;                // [B]
  float* error;                // [B]
  float* scale;                // [B]
  float* weights;              // [B, N]
  float* block_meds;           // [B, n_blocks]
};

struct Shared {
  float t[kBranch];
  int hist[kBranch];
  int scan[kBranch / 32];
  int warp_count[32];
  float warp_lo[32], warp_hi[32];
};

// torch.amin / amax: a NaN wins.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// The block's total count and NaN-propagating min and max, in every thread.
__device__ void block_reduce(int& count, float& lo, float& hi, Shared& sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, o);
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh.warp_count[warp] = count;
    sh.warp_lo[warp] = lo;
    sh.warp_hi[warp] = hi;
  }
  __syncthreads();
  count = 0;
  lo = __int_as_float(0x7f800000);
  hi = __int_as_float(0xff800000);
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    count += sh.warp_count[w];
    lo = nan_min(lo, sh.warp_lo[w]);
    hi = nan_max(hi, sh.warp_hi[w]);
  }
  __syncthreads();
}

// stats._wide_median of e[0, n) under the flags m (with kAbsDev, of
// |e - center|), in every thread; `count` gets the valid count.
template <bool kAbsDev>
__device__ float wide_median(const float* e, const unsigned char* m, int n,
                             float center, Shared& sh, int& count) {
  const int tid = threadIdx.x;
  auto value = [&](int i) {
    const float v = e[i];
    return kAbsDev ? fabsf(__fsub_rn(v, center)) : v;
  };
  count = 0;
  float lo = __int_as_float(0x7f800000), hi = __int_as_float(0xff800000);
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = m[i] != 0;
    const float v = value(i);
    count += ok;
    lo = nan_min(lo, ok ? v : FLT_MAX);
    hi = nan_max(hi, ok ? v : -FLT_MAX);
  }
  block_reduce(count, lo, hi, sh);
  const int half = (count + 1) / 2;
  for (int r = 0; r < kRounds; ++r) {
    const float w = __fdiv_rn(__fsub_rn(hi, lo), static_cast<float>(kBranch));
    if (tid < kBranch) {
      sh.t[tid] = __fmaf_rn(w, static_cast<float>(tid + 1), lo);
      sh.hist[tid] = 0;
    }
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      if (!m[i]) continue;
      const float v = value(i);
      int a = 0, b = kBranch;  // the first k with v <= t_k, or kBranch
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (v <= sh.t[mid]) {
          b = mid;
        } else {
          a = mid + 1;
        }
      }
      if (a < kBranch) atomicAdd(&sh.hist[a], 1);
    }
    __syncthreads();
    int below = 0;  // count(v <= t_tid): the histogram's running sum
    if (tid < kBranch) {
      below = sh.hist[tid];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, below, o);
        if ((tid & 31) >= o) below += y;
      }
      if ((tid & 31) == 31) sh.scan[tid >> 5] = below;
    }
    __syncthreads();
    if (tid < kBranch) {
      for (int k = 0; k < (tid >> 5); ++k) below += sh.scan[k];
    }
    const int j = min(__syncthreads_count(tid < kBranch && below < half),
                      kBranch - 1);
    const float jf = static_cast<float>(j);
    const float next_lo = __fmaf_rn(w, jf, lo);
    hi = __fmaf_rn(w, __fadd_rn(jf, 1.0f), lo);
    lo = next_lo;
  }
  const float med = __fmul_rn(0.5f, __fadd_rn(lo, hi));
  return count > 0 ? med : __int_as_float(0x7fc00000);
}

// xd.reduce_sum of the valid errors (invalid ones are +0), in thread 0;
// `buf` holds the levels above the first.
__device__ float tree_sum(const float* e, const unsigned char* m, int n,
                          float* buf) {
  const float* src = nullptr;  // null: the masked errors themselves
  auto at = [&](int i) { return src ? src[i] : (m[i] ? e[i] : 0.0f); };
  int len = n;
  float* dst = buf;
  while (len > 32) {
    const int pad = (32 - len % 32) % 32, front = pad / 2;
    const int windows = (len + pad) / 32;
    for (int w = threadIdx.x; w < windows; w += kThreads) {
      float acc = 0.0f;
      for (int i = 0; i < 32; ++i) {
        const int p = 32 * w + i - front;
        const float x = (p >= 0 && p < len) ? at(p) : 0.0f;
        acc = i == 0 ? x : __fadd_rn(acc, x);
      }
      dst[w] = acc;
    }
    __syncthreads();
    src = dst;
    dst += windows;
    len = windows;
  }
  float acc = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < len; ++i) acc = __fadd_rn(acc, at(i));
  }
  return acc;
}

// xf.rsqrt of a positive float32: the vrsqrtps estimate, two Newton steps.
__device__ float rsqrt_xla(float v) {
  const int bits = __float_as_int(v);
  const int exponent = (bits >> 23) & 0xFF;
  const bool odd = (exponent & 1) == 1;
  const double frac = __ddiv_rn(
      __dadd_rn(static_cast<double>((bits >> 13) & 0x3FF), 0.5), 1024.0);
  const double mid = __dmul_rn(__dadd_rn(1.0, frac), odd ? 1.0 : 2.0);
  const int m12 = static_cast<int>(
      rint(__dsub_rn(__ddiv_rn(8192.0, __dsqrt_rn(mid)), 4096.0)));
  const int scale = 126 - (exponent - (odd ? 127 : 128)) / 2;
  float y = __uint_as_float((static_cast<unsigned>(scale) << 23) |
                            (static_cast<unsigned>(m12) << 11));
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    y = __fmaf_rn(__fmul_rn(y, -0.5f),
                  __fmaf_rn(__fmul_rn(v, y), y, -1.0f), y);
  }
  return y;
}

// stats.huber_derivative(e, k) in float32.
__device__ __forceinline__ float huber_weight(float e, float k, float kk) {
  const float safe = (e != e || e >= kk) ? e : kk;  // clamp_min(e, k * k)
  const float above = __fmul_rn(k, rsqrt_xla(safe));
  return e < kk ? 1.0f : above;
}

__global__ void __launch_bounds__(kThreads, 1)
    robust_weights_kernel(Params p) {
  extern __shared__ float4 dynamic_smem[];
  __shared__ Shared sh;
  const long long lane = blockIdx.x;
  const int task = blockIdx.y;  // 0: count, total, scale, weights
  float* tree = reinterpret_cast<float*>(dynamic_smem);

  int off = 0, n = p.n;
  if (task > 0) {
    for (int s = 0; s < task - 1; ++s) off += p.size[s];
    n = p.size[task - 1];
  }
  const float* e = p.errors + lane * p.n + off;
  const unsigned char* m = p.valid + lane * p.n + off;
  if (p.staged) {
    float* se = tree + p.tree_floats;
    unsigned char* sm = reinterpret_cast<unsigned char*>(se + n);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      se[i] = e[i];
      sm[i] = m[i];
    }
    __syncthreads();
    e = se;
    m = sm;
  }

  int count = 0;
  if (task > 0) {
    const float med = wide_median<false>(e, m, n, 0.0f, sh, count);
    if (threadIdx.x == 0) {
      p.block_meds[lane * p.n_blocks + task - 1] = med;
    }
    return;
  }
  const float error = tree_sum(e, m, n, tree);
  const float med = wide_median<false>(e, m, n, 0.0f, sh, count);
  const float mad = wide_median<true>(e, m, n, med, sh, count);
  const float scale = __fmul_rn(static_cast<float>(kMadConsistency), mad);
  if (threadIdx.x == 0) {
    p.n_valid[lane] = count;
    p.error[lane] = error;
    p.scale[lane] = scale;
  }
  const float denom = __fadd_rn(scale, 1e-16f);
  float* w = p.weights + lane * p.n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float x = m[i] ? e[i] : 0.0f;
    w[i] = huber_weight(__fdiv_rn(x, denom), p.huber_k, p.huber_kk);
  }
}

// The levels of reduce_sum's tree above the first, in floats.
int tree_floats(int n) {
  int total = 0;
  while (n > 32) {
    n = (n + 31) / 32;
    total += n;
  }
  return total;
}

}  // namespace

extern "C" {

int robust_weights_max_blocks() { return kMaxBlocks; }

const char* robust_weights_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// `batch` lanes of n >= 1 errors and flags (row-major [B, N]); `sizes` the
// n_blocks residual blocks' lengths (summing to n), whose medians are
// computed when with_medians is set. Outputs n_valid, error, scale [B],
// weights [B, N] and block_meds [B, n_blocks], contiguous. Returns a
// cudaError_t (0 on success).
int robust_weights_f32(const float* errors, const unsigned char* valid,
                       int batch, int n, const long long* sizes, int n_blocks,
                       int with_medians, double huber_k, int* n_valid,
                       float* error, float* scale, float* weights,
                       float* block_meds, void* stream) {
  if (n_blocks < 0 || n_blocks > kMaxBlocks || n < 1) {
    return cudaErrorInvalidValue;
  }
  if (batch <= 0) return cudaSuccess;
  Params p{};
  p.errors = errors;
  p.valid = valid;
  p.n = n;
  p.n_blocks = with_medians ? n_blocks : 0;
  for (int s = 0; s < n_blocks; ++s) p.size[s] = static_cast<int>(sizes[s]);
  p.tree_floats = tree_floats(n);
  const long long tree_bytes = 4LL * p.tree_floats;
  const long long staged_bytes = tree_bytes + 5LL * n + 16;
  p.staged = staged_bytes <= kMaxDynamicSmem;
  const long long smem = p.staged ? staged_bytes : tree_bytes;
  if (smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  p.huber_k = static_cast<float>(huber_k);
  p.huber_kk = static_cast<float>(huber_k * huber_k);
  p.n_valid = n_valid;
  p.error = error;
  p.scale = scale;
  p.weights = weights;
  p.block_meds = block_meds;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        robust_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(batch), 1 + p.n_blocks);
  robust_weights_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
