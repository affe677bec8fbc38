// gn_update: the float32 Gauss-Newton update after the normal equations, for
// one problem or a batch in one launch, in the order and rounding of the JAX
// package's jitted step (lidar_feature_extraction_tpu/ops/gauss_newton.py
// weighted_update and gn_iteration; ROADMAP §C21). Its plain version is
// core/_xla_dot.py::gn_update_plain, which computes the same bits with the
// port's float32 forms (core/_xla_f32.py as xf, core/_xla_dot.py as xd):
//
// - the lift M = make_m(q) (7 x 6: 0.5 L(q)[:, 1:] over the identity);
// - H = M^T A M and g = M^T b as xf.matmul computes them: each entry the
//   first product rounded, then one FMA per term in index order;
// - xd.cholesky_solve(H, g): every s - l*m fused as fma(-l, m, s) in index
//   order, the 1e-30 pivot guard, the last unknown divided once by l*l;
//   dx = -x;
// - smallalg.min_eigval_below(D, tau): an unrolled Cholesky of D - tau I
//   in plain arithmetic (one rounding per operation, no FMA);
// - a zero dx where that finds D degenerate or dx is not finite;
// - xd.pose_update: exp_so3 with xf.sincos (glibc's sinf / cosf: float64
//   reduction by multiples of pi/2, truncated to int, + 0x800000, >> 24,
//   float64 polynomials, each float64 step rounded once), the small-angle
//   branch, the fused quat_multiply and quat_normalize;
// - t + dt, and |dq.vec| and |dt| as xf.sqrt of the in-order sums of
//   squares.
// Every FMA is __fmaf_rn, every division and square root IEEE (__fdiv_rn,
// __fsqrt_rn; xf.sqrt rounds the float64 root, which is the correctly
// rounded one), float64 steps __d*_rn, and the file is built with
// --fmad=false, so nothing else is contracted.
//
// It ports no TPU kernel: the reference leaves this arithmetic to XLA. It
// replaces the ~570 launches per iteration of the chains above (each an
// elementwise launch of a few bytes per lane) with one.
//
// Bound: per lane 112 floats in (D, A, b, q, t) and 45 out (q, t, H and the
// two norms), 628 bytes, ~0.2 ns at 3.35 TB/s; a few hundred float
// operations. The work is a serial chain (the solve, the eigenvalue test,
// the pose update), so the kernel is bound by its launch and that chain.
// One block of 64 threads per lane: 42 threads run the entries of M^T A
// and M^T b, 36 those of H, then thread 0 runs the solve while thread 32
// (the second warp, so the two chains issue side by side) runs the
// eigenvalue test, and thread 0 the pose update.
//
// Built with robust_weights.cu and gn_kernels_op.cpp into one library by
// ops/gn_kernels_cuda.py::build (nvcc, sm_90a, --fmad=false) into
// build/kernels/ at first use, and called through the operator
// lidar_port::gn_update.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

// Operand strides in elements: [batch, row, column] for D and A, [batch,
// entry] for b, q and t.
struct Layout {
  long long d[3], a[3], b[2], q[2], t[2];
};

struct Out {
  float* q;        // [B, 4]
  float* t;        // [B, 3]
  float* h;        // [B, 6, 6]
  float* dq_norm;  // [B]
  float* dt_norm;  // [B]
};

// glibc's float sinf / cosf as xf._sincos emulates them (|v| < 120).
constexpr double kHpiInv = 0x1.45f306dc9c883p+23;
constexpr double kHpi = 0x1.921fb54442d18p+0;
constexpr double kC0 = 0x1p0, kC1 = -0x1.ffffffd0c621cp-2,
                 kC2 = 0x1.55553e1068f19p-5, kC3 = -0x1.6c087e89a359dp-10,
                 kC4 = 0x1.99343027bf8c3p-16;
constexpr double kS0 = -0x1.555545995a603p-3, kS1 = 0x1.1107605230bc4p-7,
                 kS2 = -0x1.994eb3774cf24p-13;

__device__ double cos_poly(double x2) {
  const double x4 = __dmul_rn(x2, x2);
  const double c1 = __dadd_rn(__dmul_rn(x2, kC1), kC0);
  const double c2 = __dadd_rn(__dmul_rn(x2, kC4), kC3);
  return __dadd_rn(__dmul_rn(c2, __dmul_rn(x2, x4)),
                   __dadd_rn(__dmul_rn(x4, kC2), c1));
}

__device__ double sin_poly(double x, double x2) {
  const double x3 = __dmul_rn(x2, x);
  return __dadd_rn(
      __dmul_rn(__dadd_rn(__dmul_rn(x2, kS2), kS1), __dmul_rn(x2, x3)),
      __dadd_rn(__dmul_rn(x3, kS0), x));
}

// odd 0: sinf(v); odd 1: cosf(v).
__device__ float sincos_glibc(float v, int odd) {
  const double x = static_cast<double>(v);
  const int top = (__float_as_int(v) >> 20) & 0x7ff;
  const int n = (__double2int_rz(__dmul_rn(x, kHpiInv)) + 0x800000) >> 24;
  const double xr = __dsub_rn(x, __dmul_rn(static_cast<double>(n), kHpi));
  const double x2 = __dmul_rn(xr, xr);
  const int m = n + odd;
  double red = (m & 1) == 0 ? sin_poly(xr, x2) : cos_poly(x2);
  if ((m & 2) != 0) red = -red;
  const double xx = __dmul_rn(x, x);
  const double near = odd ? cos_poly(xx) : sin_poly(x, xx);
  const float out = __double2float_rn(top <= 0x3f3 ? near : red);
  return top <= 0x397 ? (odd ? 1.0f : v) : out;
}

// torch.clamp_min: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v != v || v >= lo) ? v : lo;
}

// sqrt(fma(x[n-1], x[n-1], ... fma(x1, x1, x0 * x0))): xf.sqrt of
// xf.sum_squares.
template <int N>
__device__ __forceinline__ float norm(const float* x) {
  float s = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) s = __fmaf_rn(x[k], x[k], s);
  return __fsqrt_rn(s);
}

// xd.cholesky_solve(H, g) (H row-major 6 x 6 in shared memory): x.
__device__ void cholesky_solve(const float* H, const float* g, float* x) {
  constexpr float kEps = 1e-30f;
  float l[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = H[i * 6 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = __fmaf_rn(-l[i][k], l[j][k], s);
      if (i == j) {
        l[i][i] = __fsqrt_rn(s);
      } else {
        const float ljj = l[j][j];
        l[i][j] = __fdiv_rn(s, fabsf(ljj) < kEps ? kEps : ljj);
      }
    }
  }
  float y[6], last = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = __fmaf_rn(-l[i][k], y[k], s);
    last = s;
    y[i] = __fdiv_rn(s, l[i][i]);
  }
  x[5] = __fdiv_rn(last, __fmul_rn(l[5][5], l[5][5]));
#pragma unroll
  for (int i = 4; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = __fmaf_rn(-l[k][i], x[k], s);
    x[i] = __fdiv_rn(s, l[i][i]);
  }
}

// smallalg.min_eigval_below(D, tau): whether D - tau I fails an unrolled
// Cholesky (a pivot not positive); plain arithmetic.
__device__ bool min_eigval_below(const float* D, float tau) {
  float l[7][7];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = __fsub_rn(D[i * 7 + j], i == j ? tau : 0.0f);
#pragma unroll
      for (int k = 0; k < j; ++k)
        s = __fsub_rn(s, __fmul_rn(l[i][k], l[j][k]));
      if (i == j) {
        ok = ok && (s > 0.0f);
        l[i][i] = __fsqrt_rn(clamp_min(s, 1e-30f));
      } else {
        l[i][j] = __fdiv_rn(s, l[j][j]);
      }
    }
  }
  return !ok;
}

// The entries of 0.5 L(q)[:, 1:] (make_m's top-left 4 x 3): q's index and
// whether it is negated.
__constant__ int kLiftIndex[12] = {1, 2, 3, 0, 3, 2, 3, 0, 1, 2, 1, 0};
__constant__ int kLiftNegate[12] = {1, 1, 1, 0, 1, 0, 0, 0, 1, 1, 0, 0};

__global__ void __launch_bounds__(kThreads)
    gn_update_kernel(const float* __restrict__ d, const float* __restrict__ a,
                     const float* __restrict__ b, const float* __restrict__ q,
                     const float* __restrict__ t, Layout lay, float tau,
                     Out out) {
  __shared__ float sD[49], sA[49], sb[7], sq[4], st[3];
  __shared__ float sM[42], sMtA[42], sg[6], sH[36], sdx[6];
  __shared__ int s_degenerate;
  const int lane = blockIdx.x, tid = threadIdx.x;

  for (int i = tid; i < 49; i += kThreads) {
    const int r = i / 7, c = i % 7;
    sD[i] = d[lane * lay.d[0] + r * lay.d[1] + c * lay.d[2]];
    sA[i] = a[lane * lay.a[0] + r * lay.a[1] + c * lay.a[2]];
  }
  if (tid < 7) sb[tid] = b[lane * lay.b[0] + tid * lay.b[1]];
  if (tid >= 8 && tid < 12) sq[tid - 8] = q[lane * lay.q[0] +
                                            (tid - 8) * lay.q[1]];
  if (tid >= 12 && tid < 15) st[tid - 12] = t[lane * lay.t[0] +
                                             (tid - 12) * lay.t[1]];
  __syncthreads();

  // M [7, 6] row-major.
  if (tid < 42) {
    const int r = tid / 6, c = tid % 6;
    float m = 0.0f;
    if (r < 4 && c < 3) {
      const int e = r * 3 + c;
      const float v = sq[kLiftIndex[e]];
      m = __fmul_rn(0.5f, kLiftNegate[e] ? -v : v);
    } else if (r >= 4 && c == r - 1) {
      m = 1.0f;
    }
    sM[tid] = m;
  }
  __syncthreads();

  // (M^T A)[i, j] and g[i] = (M^T b)[i]: the k = 0 product, then FMAs.
  if (tid < 42) {
    const int i = tid / 7, j = tid % 7;
    float s = __fmul_rn(sM[i], sA[j]);
#pragma unroll
    for (int k = 1; k < 7; ++k) s = __fmaf_rn(sM[k * 6 + i], sA[k * 7 + j], s);
    sMtA[tid] = s;
  } else if (tid < 48) {
    const int i = tid - 42;
    float s = __fmul_rn(sM[i], sb[0]);
#pragma unroll
    for (int k = 1; k < 7; ++k) s = __fmaf_rn(sM[k * 6 + i], sb[k], s);
    sg[i] = s;
  }
  __syncthreads();

  // H[i, j] = (M^T A M)[i, j].
  if (tid < 36) {
    const int i = tid / 6, j = tid % 6;
    float s = __fmul_rn(sMtA[i * 7], sM[j]);
#pragma unroll
    for (int k = 1; k < 7; ++k) {
      s = __fmaf_rn(sMtA[i * 7 + k], sM[k * 6 + j], s);
    }
    sH[tid] = s;
    out.h[lane * 36 + tid] = s;
  }
  __syncthreads();

  if (tid == 0) {
    float x[6];
    cholesky_solve(sH, sg, x);
#pragma unroll
    for (int i = 0; i < 6; ++i) sdx[i] = -x[i];
  } else if (tid == 32) {
    s_degenerate = min_eigval_below(sD, tau);
  }
  __syncthreads();
  if (tid != 0) return;

  float dx[6];
  bool bad = s_degenerate != 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    dx[i] = sdx[i];
    bad = bad || !isfinite(dx[i]);
  }
  if (bad) {
#pragma unroll
    for (int i = 0; i < 6; ++i) dx[i] = 0.0f;
  }

  // exp_so3(dx[:3]) with the small-angle branch.
  const float k = norm<3>(dx);
  const bool small = k < 1e-8f;
  const float ksafe = small ? 1.0f : k;
  const float half = __fmul_rn(ksafe, 0.5f);
  const float sinc = small ? 0.5f : __fdiv_rn(sincos_glibc(half, 0), ksafe);
  float dq[4];
  dq[0] = small ? 1.0f : sincos_glibc(half, 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) dq[i + 1] = __fmul_rn(dx[i], sinc);

  // xd.quat_multiply(q, dq), then quat_normalize.
  const float aw = sq[0], ax = sq[1], ay = sq[2], az = sq[3];
  const float bw = dq[0], bx = dq[1], by = dq[2], bz = dq[3];
  float p[4];
  p[0] = __fmaf_rn(-az, bz, __fmaf_rn(-ay, by, __fmaf_rn(aw, bw,
                                                        -__fmul_rn(ax, bx))));
  p[1] = __fmaf_rn(-az, by, __fmaf_rn(ay, bz, __fmaf_rn(ax, bw,
                                                       __fmul_rn(aw, bx))));
  p[2] = __fmaf_rn(az, bx, __fmaf_rn(ay, bw, __fmaf_rn(aw, by,
                                                      -__fmul_rn(ax, bz))));
  p[3] = __fmaf_rn(az, bw, __fmaf_rn(-ay, bx, __fmaf_rn(aw, bz,
                                                       __fmul_rn(ax, by))));
  const float pn = clamp_min(norm<4>(p), 1e-12f);
#pragma unroll
  for (int i = 0; i < 4; ++i) out.q[lane * 4 + i] = __fdiv_rn(p[i], pn);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out.t[lane * 3 + i] = __fadd_rn(st[i], dx[3 + i]);
  }
  out.dq_norm[lane] = norm<3>(dq + 1);
  out.dt_norm[lane] = norm<3>(dx + 3);
}

}  // namespace

extern "C" {

const char* gn_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The update of `batch` lanes: D and A [B, 7, 7], b [B, 7], q [B, 4] and
// t [B, 3] read through their strides (sd, sa: 3 each; sb, sq, st: 2 each,
// in elements); outputs q [B, 4], t [B, 3], H [B, 6, 6], |dq.vec| and |dt|
// [B], contiguous. Returns a cudaError_t (0 on success).
int gn_update_f32(const float* d, const float* a, const float* b,
                  const float* q, const float* t, const long long* sd,
                  const long long* sa, const long long* sb,
                  const long long* sq, const long long* st, int batch,
                  float tau, float* q_out, float* t_out, float* h_out,
                  float* dq_norm, float* dt_norm, void* stream) {
  if (batch <= 0) return cudaSuccess;
  Layout lay;
  for (int i = 0; i < 3; ++i) {
    lay.d[i] = sd[i];
    lay.a[i] = sa[i];
  }
  for (int i = 0; i < 2; ++i) {
    lay.b[i] = sb[i];
    lay.q[i] = sq[i];
    lay.t[i] = st[i];
  }
  const Out out{q_out, t_out, h_out, dq_norm, dt_norm};
  gn_update_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      d, a, b, q, t, lay, tau, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
