// fma_f32: out = fma(a, b, c) elementwise in float32, rounded once
// (__fmaf_rn), for CUDA tensors of one broadcast shape.
//
// The port computes the float32 expressions that XLA:CPU contracts into
// fused multiply-adds under jax.jit with this one operation
// (core/_xla_f32.py::fma; ROADMAP §C18-§C20). Its plain version,
// _xla_f32._fma_plain, emulates the same correctly rounded result in
// float64 with round-to-odd, about 21 elementwise launches; this kernel is
// one launch, with no copies: the operator (fma_f32_op.cpp) passes each
// operand's strides over the output's shape (0 along a broadcast
// dimension) and the kernel reads it through them. `a` may instead be a
// scalar argument.
//
// Bound: one read of each operand element the output touches and one
// write, so on an H100 (3.35 TB/s) 16 bytes per element when nothing is
// broadcast; the arithmetic is one FMA per element. It is a stream with no
// reuse, so the design is about the memory system and the index
// arithmetic:
//
// - the entry point first drops size-1 dimensions and merges neighbours
//   whose strides chain in all three operands (as TensorIterator
//   coalesces): three contiguous operands become one dimension, a
//   [8192, 3] against a [8192, 1] stays two;
// - one contiguous dimension (or `a` a scalar or one broadcast element)
//   takes the streaming kernel: 16-byte loads and stores (ld.global.v4),
//   one of each operand in flight per thread, a scalar head and tail
//   where the operands are not 16-byte aligned or n is not a multiple of
//   4, and scalar loads where the operands' alignments differ;
// - any other layout takes the strided kernel: each index is split over
//   the dimensions by a multiply-high and a shift per dimension
//   (precomputed magic numbers), in 32-bit arithmetic where every index
//   and offset fits, else 64-bit;
// - the grid follows n: a thread has its float4 of each operand (or its
//   element) in flight at once, blocks of 128 threads spread the launch
//   over as many SMs as n fills, and a tiny n is one block; there is no
//   cap and no grid-stride loop.
//
// Built with fma_f32_op.cpp into one library by ops/fma_cuda.py::build
// (nvcc, sm_90a, --fmad=false) into build/kernels/ at first use, and
// called through the operator lidar_port::fma_f32.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kMaxDims = 8;
// Threads a block, each with one float4 of each operand in flight
// (streaming kernel) or one element (strided kernel). Few per thread and
// many blocks: the main path's operands are small and sit in L2, where a
// launch over a few SMs waits on each SM's share of L2 bandwidth, and at
// 2^20 every block of 128 threads is resident at once (16 of them an SM).
constexpr int kThreads = 128;

// n / d by a multiply-high, an add and a shift, for d >= 1 and n < 2^31
// (uint32_t) or 2^63 (uint64_t): s = ceil(log2 d) and
// m = floor(2^W (2^s - d) / d) + 1 (W the width), as PyTorch's IntDivider.
template <typename U>
struct Divider {
  U d, m;
  int s;
};

template <typename U>
Divider<U> make_divider(U d) {
  Divider<U> v{d, 0, 0};
  while ((U{1} << v.s) < d) ++v.s;
  if constexpr (sizeof(U) == 4) {
    v.m = static_cast<U>(((uint64_t{1} << 32) * ((uint64_t{1} << v.s) - d))
                         / d + 1);
  } else {
    using u128 = unsigned __int128;
    v.m = static_cast<U>(((u128{1} << 64) * ((u128{1} << v.s) - d)) / d
                         + 1);
  }
  return v;
}

__device__ __forceinline__ uint32_t divide(uint32_t n,
                                           const Divider<uint32_t>& v) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

__device__ __forceinline__ uint64_t divide(uint64_t n,
                                           const Divider<uint64_t>& v) {
  return (__umul64hi(n, v.m) + n) >> v.s;
}

// A coalesced layout, innermost dimension first (div[k].d is its size).
template <typename U>
struct Strided {
  int ndim;
  Divider<U> div[kMaxDims];
  U sa[kMaxDims], sb[kMaxDims], sc[kMaxDims];
};

// How the streaming kernel reads `a`.
enum AMode { kAScalar, kABroadcast, kAContiguous };

// n elements of one contiguous dimension, the first `head` of them (and
// the `tail` after the vector body) one by one in block 0, the body
// [head, head + 4 nvec) as float4 when kVector (every operand at the same
// alignment, so that `head` aligns all of them), else element by element.
template <typename U, AMode kA, bool kVector>
__global__ void __launch_bounds__(kThreads)
    fma_f32_stream(const float* __restrict__ a, float a_value,
                   const float* __restrict__ b, const float* __restrict__ c,
                   float* __restrict__ out, U n, U head, U nvec) {
  const U tid = threadIdx.x;
  if constexpr (kA == kABroadcast) a_value = a[0];
  if constexpr (kVector) {
    const U body_end = head + 4 * nvec;
    if (blockIdx.x == 0 && tid < head + (n - body_end)) {
      const U i = tid < head ? tid : body_end + (tid - head);
      out[i] = __fmaf_rn(kA == kAContiguous ? a[i] : a_value, b[i], c[i]);
    }
    const float4* b4 = reinterpret_cast<const float4*>(b + head);
    const float4* c4 = reinterpret_cast<const float4*>(c + head);
    const float4* a4 = kA == kAContiguous
                           ? reinterpret_cast<const float4*>(a + head)
                           : nullptr;
    float4* o4 = reinterpret_cast<float4*>(out + head);
    const U g = static_cast<U>(blockIdx.x) * kThreads + tid;
    if (g < nvec) {
      const float4 vb = b4[g], vc = c4[g];
      const float4 x = kA == kAContiguous
                           ? a4[g]
                           : make_float4(a_value, a_value, a_value, a_value);
      o4[g] = make_float4(__fmaf_rn(x.x, vb.x, vc.x),
                          __fmaf_rn(x.y, vb.y, vc.y),
                          __fmaf_rn(x.z, vb.z, vc.z),
                          __fmaf_rn(x.w, vb.w, vc.w));
    }
  } else {
    // Four elements a thread, a block's 512 side by side.
    const U base = static_cast<U>(blockIdx.x) * (kThreads * 4) + tid;
    float vb[4], vc[4], va[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const U i = base + k * kThreads;
      if (i < n) {
        vb[k] = b[i];
        vc[k] = c[i];
        va[k] = kA == kAContiguous ? a[i] : a_value;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const U i = base + k * kThreads;
      if (i < n) out[i] = __fmaf_rn(va[k], vb[k], vc[k]);
    }
  }
}

// Any coalesced layout: one element a thread, its index split over the
// dimensions by the dividers (the outermost needs no division).
template <typename U>
__global__ void __launch_bounds__(kThreads)
    fma_f32_strided(const float* __restrict__ a, float a_value,
                    const float* __restrict__ b, const float* __restrict__ c,
                    float* __restrict__ out, U n, Strided<U> lay) {
  const U i = static_cast<U>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  U rem = i, oa = 0, ob = 0, oc = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d >= lay.ndim) break;
    U idx = rem;
    if (d + 1 < lay.ndim) {
      const U q = divide(rem, lay.div[d]);
      idx = rem - q * lay.div[d].d;
      rem = q;
    }
    oa += idx * lay.sa[d];
    ob += idx * lay.sb[d];
    oc += idx * lay.sc[d];
  }
  out[i] = __fmaf_rn(a != nullptr ? a[oa] : a_value, b[ob], c[oc]);
}

unsigned blocks_for(long long units, long long per_block) {
  const long long blocks = (units + per_block - 1) / per_block;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

template <typename U, AMode kA>
void launch_stream(const float* a, float a_value, const float* b,
                   const float* c, float* out, long long n,
                   cudaStream_t stream) {
  const auto misalign = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16;
  };
  const uintptr_t m = misalign(out);
  const bool vector = misalign(b) == m && misalign(c) == m &&
                      (kA != kAContiguous || misalign(a) == m) && m % 4 == 0;
  if (vector) {
    long long head = m ? (16 - static_cast<long long>(m)) / 4 : 0;
    if (head > n) head = n;
    const long long nvec = (n - head) / 4;
    fma_f32_stream<U, kA, true>
        <<<blocks_for(nvec, kThreads), kThreads, 0, stream>>>(
            a, a_value, b, c, out, static_cast<U>(n), static_cast<U>(head),
            static_cast<U>(nvec));
  } else {
    fma_f32_stream<U, kA, false>
        <<<blocks_for(n, kThreads * 4), kThreads, 0, stream>>>(
            a, a_value, b, c, out, static_cast<U>(n), 0, 0);
  }
}

template <typename U>
void launch_stream_any(const float* a, float a_value, const float* b,
                       const float* c, float* out, long long n, long long sa,
                       cudaStream_t stream) {
  if (a == nullptr) {
    launch_stream<U, kAScalar>(a, a_value, b, c, out, n, stream);
  } else if (sa == 0) {
    launch_stream<U, kABroadcast>(a, a_value, b, c, out, n, stream);
  } else {
    launch_stream<U, kAContiguous>(a, a_value, b, c, out, n, stream);
  }
}

template <typename U>
void launch_strided(const float* a, float a_value, const float* b,
                    const float* c, float* out, long long n, int ndim,
                    const long long* size, const long long* sa,
                    const long long* sb, const long long* sc,
                    cudaStream_t stream) {
  Strided<U> lay;
  lay.ndim = ndim;
  for (int k = 0; k < ndim; ++k) {  // innermost first
    const int d = ndim - 1 - k;
    lay.div[k] = make_divider(static_cast<U>(size[d]));
    lay.sa[k] = static_cast<U>(sa[d]);
    lay.sb[k] = static_cast<U>(sb[d]);
    lay.sc[k] = static_cast<U>(sc[d]);
  }
  fma_f32_strided<U><<<blocks_for(n, kThreads), kThreads, 0,
                       stream>>>(a, a_value, b, c, out, static_cast<U>(n),
                                 lay);
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
  // Coalesce: drop size-1 dimensions, then merge each dimension into the
  // one inside it where all three operands' strides chain.
  long long sz[kMaxDims], ta[kMaxDims], tb[kMaxDims], tc[kMaxDims];
  int nd = 0;
  for (int d = 0; d < ndim; ++d) {
    if (size[d] == 1) continue;
    const long long da = a != nullptr ? sa[d] : 0;
    if (nd > 0 && ta[nd - 1] == da * size[d] && tb[nd - 1] == sb[d] * size[d]
        && tc[nd - 1] == sc[d] * size[d]) {
      sz[nd - 1] *= size[d];
      ta[nd - 1] = da;
      tb[nd - 1] = sb[d];
      tc[nd - 1] = sc[d];
      continue;
    }
    sz[nd] = size[d];
    ta[nd] = da;
    tb[nd] = sb[d];
    tc[nd] = sc[d];
    ++nd;
  }
  if (nd == 0) {  // one element
    sz[0] = 1;
    ta[0] = tb[0] = tc[0] = 1;
    nd = 1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = n < (1LL << 31);
  if (nd == 1 && tb[0] == 1 && tc[0] == 1 && (ta[0] == 0 || ta[0] == 1)) {
    if (narrow) {
      launch_stream_any<uint32_t>(a, a_value, b, c, out, n, ta[0], s);
    } else {
      launch_stream_any<uint64_t>(a, a_value, b, c, out, n, ta[0], s);
    }
  } else {
    bool fits = narrow;
    for (const long long* st : {ta, tb, tc}) {
      long long last = 0;
      for (int d = 0; d < nd; ++d) last += (sz[d] - 1) * st[d];
      fits = fits && last < (1LL << 31);
    }
    if (fits) {
      launch_strided<uint32_t>(a, a_value, b, c, out, n, nd, sz, ta, tb, tc,
                               s);
    } else {
      launch_strided<uint64_t>(a, a_value, b, c, out, n, nd, sz, ta, tb, tc,
                               s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
