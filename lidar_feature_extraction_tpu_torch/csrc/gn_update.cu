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
// operations. The work is a chain of dependent steps (the solve, the
// eigenvalue test, the pose update), so the kernel is bound by its launch
// and that chain, in which each IEEE division and square root is a
// sequence of dependent instructions with a branch to a slow path, not
// one step. Run on one thread each, the factor and both substitutions
// are 33 divisions and roots in one chain (the 7 x 7 test 28 more, the
// pose update 8), each sequence with its branch to a slow path. Here one
// block of two warps per lane, joined by one barrier:
//
// - warp 0 loads A, b, q and t once (two floats a lane, both loads in
//   flight together) into shared memory, runs the 48 entries of
//   (M^T A | M^T b), then H's 21 lower entries (which the factor reads)
//   and 11 of its upper ones, exchanging through
//   shared memory under __syncwarp; the lift's entries are read from q by
//   shifts of packed constants, not from tables, and every select is
//   written so that the warp does not branch;
// - the factor runs column by column across lanes: lane i holds row i's
//   entries, every lane the diagonal's chains, so that column k's root is
//   taken on every lane at once, lanes i > k divide by the pivot, and the
//   column is broadcast by shuffles; each entry still runs k in ascending
//   order, so the bits are the serial factor's. The forward substitution
//   rides in the factor's divisions: in column k, lane k divides g's
//   chain s[k] by the pivot while the lanes below divide their entries (the
//   unused y[5] is not divided). Every lane then holds L and y and runs
//   the back substitution;
// - warp 1 loads D once and runs the eigenvalue test the same way, column
//   by column (plain arithmetic), beside warp 0; after the barrier it
//   computes H's last 4 upper entries;
// - the pose update is spread over warp 0's lanes: sin and cos of the half
//   angle on lanes 0 and 1, the four normalising divisions on lanes 0-3,
//   t + dt on lanes 4-6 and the two norms on lanes 7 and 8.
//
// Built with robust_weights.cu and gn_kernels_op.cpp into one library by
// ops/gn_kernels_cuda.py::build (nvcc, sm_90a, --fmad=false) into
// build/kernels/ at first use, and called through the operator
// lidar_port::gn_update; also with -DGU_PHASE_TIMING (a build the port
// never uses), by profile_fma_gn_update.py.

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

// sqrt(fma(x2, x2, fma(x1, x1, x0 * x0))): xf.sqrt of xf.sum_squares.
__device__ __forceinline__ float norm3(float x0, float x1, float x2) {
  return __fsqrt_rn(__fmaf_rn(x2, x2, __fmaf_rn(x1, x1, __fmul_rn(x0, x0))));
}

// make_m(q)'s entry M[k][i] (7 x 6: 0.5 L(q)[:, 1:] over the identity), k
// known at compile time, q in shared memory: for k < 4 and i < 3, q's
// index is nibble i of `index` and whether it is negated bit i of
// `negate`. One load at a computed address and selects: a chain of
// ternaries over q in registers compiled to divergent branches.
__device__ __forceinline__ float lift(const float* q, int k, int i) {
  if (k >= 4) return i == k - 1 ? 1.0f : 0.0f;
  const unsigned index = k == 0 ? 0x321u : k == 1 ? 0x230u
                         : k == 2 ? 0x103u : 0x012u;
  const unsigned negate = k == 0 ? 7u : k == 1 ? 2u : k == 2 ? 4u : 1u;
  const float v = q[(index >> (4 * i)) & 0xfu];
  const float m = __fmul_rn(0.5f, (negate >> i) & 1u ? -v : v);
  return i < 3 ? m : 0.0f;
}

// H's entry e of 36: e < 21 the lower triangle in row order, then the
// upper one, (c, r) for the e - 21st (r, c) of the strict lower triangle.
__device__ __forceinline__ void h_entry(int e, int* i, int* j) {
  if (e < 21) {
    const int r = (e >= 1) + (e >= 3) + (e >= 6) + (e >= 10) + (e >= 15);
    *i = r;
    *j = e - r * (r + 1) / 2;
  } else {
    const int u = e - 21;
    const int r = 1 + (u >= 1) + (u >= 3) + (u >= 6) + (u >= 10);
    *i = u - r * (r - 1) / 2;
    *j = r;
  }
}

// H[i][j] = (M^T A M)[i][j] from (M^T A | M^T b) [6, 8] in shared memory:
// the k = 0 product, then FMAs in index order.
__device__ __forceinline__ float h_value(const float* mta, const float* q,
                                         int i, int j) {
  float s = __fmul_rn(mta[i * 8], lift(q, 0, j));
#pragma unroll
  for (int k = 1; k < 7; ++k) s = __fmaf_rn(mta[i * 8 + k], lift(q, k, j), s);
  return s;
}

constexpr unsigned kFull = 0xffffffffu;

#ifdef GU_PHASE_TIMING
// Thread 0 of lane 0's block stamps %globaltimer and clock64() at each
// phase boundary of warp 0; warp 1's first thread stamps the end of the
// eigenvalue test in the last slot. A name with "+" is measured from the
// start.
constexpr int kStamps = 16;
__device__ unsigned long long gu_stamp_ns[kStamps];
__device__ long long gu_stamp_clk[kStamps];
constexpr const char* kPhaseNames =
    "load,products,h,factor,solve,join,pose,+eigen";

__device__ __forceinline__ void stamp_at(int k) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  gu_stamp_ns[k] = ns;
  gu_stamp_clk[k] = clock64();
}
#define GU_STAMP(k) \
  if (blockIdx.x == 0 && threadIdx.x == 0) stamp_at(k)
#define GU_STAMP_EIGEN() \
  if (blockIdx.x == 0 && threadIdx.x == 32) stamp_at(kStamps - 1)
#else
#define GU_STAMP(k)
#define GU_STAMP_EIGEN()
#endif

__global__ void __launch_bounds__(kThreads)
    gn_update_kernel(const float* __restrict__ d, const float* __restrict__ a,
                     const float* __restrict__ b,
                     const float* __restrict__ q_in,
                     const float* __restrict__ t, Layout lay, float tau,
                     Out out) {
  // A [7, 7] row-major, b [7], q [4], t [3]; (M^T A | M^T b) [6, 8]; H's
  // lower triangle [6, 6]; D [7, 7].
  __shared__ float s_in[63], s_mta[48], s_h[36], s_d[49];
  __shared__ int s_degenerate;
  const float* sq = s_in + 56;
  const long long p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  float dx[6], q[4];
  GU_STAMP(0);

  if (threadIdx.x < 32) {
    // Two floats a lane, A's 49 then b, q and t, both loads in flight
    // before either store.
    float v[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int slot = lane + 32 * r;
      const float* src;
      long long off;
      if (slot < 49) {
        src = a + p * lay.a[0];
        off = (slot / 7) * lay.a[1] + (slot % 7) * lay.a[2];
      } else if (slot < 56) {
        src = b + p * lay.b[0];
        off = (slot - 49) * lay.b[1];
      } else if (slot < 60) {
        src = q_in + p * lay.q[0];
        off = (slot - 56) * lay.q[1];
      } else {
        src = t + p * lay.t[0];
        off = (slot < 63 ? slot - 60 : 0) * lay.t[1];
      }
      v[r] = src[off];
    }
    s_in[lane] = v[0];
    if (lane < 31) s_in[lane + 32] = v[1];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = sq[i];
    GU_STAMP(1);

    // (M^T A)[i, j] and g[i] = (M^T b)[i] (column j = 7): the k = 0
    // product, then FMAs in index order.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int e = lane + 32 * r;
      if (e < 48) {
        const int i = e >> 3, j = e & 7;
        const float* col = j < 7 ? s_in + j : s_in + 49;
        const int step = j < 7 ? 7 : 1;
        float s = __fmul_rn(lift(sq, 0, i), col[0]);
#pragma unroll
        for (int k = 1; k < 7; ++k) {
          s = __fmaf_rn(lift(sq, k, i), col[k * step], s);
        }
        s_mta[e] = s;
      }
    }
    __syncwarp();
    GU_STAMP(2);

    {
      int i, j;
      h_entry(lane, &i, &j);
      const float h = h_value(s_mta, sq, i, j);
      s_h[i * 6 + j] = h;
      out.h[p * 36 + i * 6 + j] = h;
    }
    __syncwarp();
    GU_STAMP(3);

    // xd.cholesky_solve(H, g): the fused factor column by column, with the
    // forward substitution in its divisions. L[r][c] (c <= r) ends up on
    // every lane; diag[j] is H[j][j]'s chain on every lane, row[j] this
    // lane's H[lane][j] (j < lane < 6), s[i] g[i]'s chain on every lane.
    // In column k, lanes i > k divide row[k] by the guarded pivot, and
    // lane k divides s[k] by the pivot itself: y[k], at no extra step.
    constexpr float kEps = 1e-30f;
    float L[6][6], diag[6], row[6], s[6], y[5], x[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      diag[j] = s_h[j * 7];
      const float h = s_h[min(lane, 5) * 6 + j];  // a load on every lane
      row[j] = j < lane && lane < 6 ? h : 0.0f;
      s[j] = s_mta[j * 8 + 7];
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      L[k][k] = __fsqrt_rn(diag[k]);
      const float pivot = fabsf(L[k][k]) < kEps ? kEps : L[k][k];
      // Every lane divides, so the warp does not diverge around the
      // division; a lane with no entry below the diagonal divides 1, since
      // a zero numerator takes the division's slow path.
      const bool forward = lane == k, below = lane > k && lane < 6;
      const float mine = __fdiv_rn(forward ? s[k] : below ? row[k] : 1.0f,
                                   forward ? L[k][k] : pivot);
      y[k] = __shfl_sync(kFull, mine, k);
#pragma unroll
      for (int j = k + 1; j < 6; ++j) {
        L[j][k] = __shfl_sync(kFull, mine, j);
      }
#pragma unroll
      for (int j = k + 1; j < 6; ++j) {
        diag[j] = __fmaf_rn(-L[j][k], L[j][k], diag[j]);
        if (j < lane && below) row[j] = __fmaf_rn(-mine, L[j][k], row[j]);
        s[j] = __fmaf_rn(-L[j][k], y[k], s[j]);
      }
    }
    L[5][5] = __fsqrt_rn(diag[5]);
    GU_STAMP(4);

    // The last unknown divided once by l*l; the back substitution (each
    // entry's FMAs in ascending k); dx = -x.
    x[5] = __fdiv_rn(s[5], __fmul_rn(L[5][5], L[5][5]));
#pragma unroll
    for (int i = 4; i >= 0; --i) {
      float v = y[i];
#pragma unroll
      for (int k = i + 1; k < 6; ++k) v = __fmaf_rn(-L[k][i], x[k], v);
      x[i] = __fdiv_rn(v, L[i][i]);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) dx[i] = -x[i];
    GU_STAMP(5);
  } else {
    // smallalg.min_eigval_below(D, tau): whether D - tau I fails an
    // unrolled Cholesky (a pivot not positive), in plain arithmetic,
    // column by column as above.
    const float* dp = d + p * lay.d[0];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int slot = lane + 32 * r;
      if (slot < 49) {
        s_d[slot] = dp[(slot / 7) * lay.d[1] + (slot % 7) * lay.d[2]];
      }
    }
    __syncwarp();
    float diag[7], row[7];
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      diag[j] = __fsub_rn(s_d[j * 8], tau);
      const float dj = s_d[min(lane, 6) * 7 + j];
      row[j] = j < lane && lane < 7 ? __fsub_rn(dj, 0.0f) : 0.0f;
    }
    bool ok = true;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      ok = ok && (diag[k] > 0.0f);
      if (k == 6) break;
      const float lkk = __fsqrt_rn(clamp_min(diag[k], 1e-30f));
      const bool below = lane > k && lane < 7;
      const float mine = __fdiv_rn(below ? row[k] : 1.0f, lkk);
#pragma unroll
      for (int j = k + 1; j < 7; ++j) {
        const float ljk = __shfl_sync(kFull, mine, j);
        diag[j] = __fsub_rn(diag[j], __fmul_rn(ljk, ljk));
        if (j < lane && below) {
          row[j] = __fsub_rn(row[j], __fmul_rn(mine, ljk));
        }
      }
    }
    if (lane == 0) s_degenerate = !ok;
    GU_STAMP_EIGEN();
  }
  __syncthreads();

  if (threadIdx.x >= 32) {
    // H's last 4 upper entries.
    if (lane < 4) {
      int i, j;
      h_entry(32 + lane, &i, &j);
      out.h[p * 36 + i * 6 + j] = h_value(s_mta, sq, i, j);
    }
    return;
  }
  GU_STAMP(6);

  bool bad = s_degenerate != 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) bad = bad || !isfinite(dx[i]);
  if (bad) {
#pragma unroll
    for (int i = 0; i < 6; ++i) dx[i] = 0.0f;
  }

  // exp_so3(dx[:3]) with the small-angle branch: sinf on lane 0, cosf on
  // lane 1.
  const float k = norm3(dx[0], dx[1], dx[2]);
  const bool small = k < 1e-8f;
  const float ksafe = small ? 1.0f : k;
  const float half = __fmul_rn(ksafe, 0.5f);
  const float sc = sincos_glibc(half, lane & 1);
  const float sin_half = __shfl_sync(kFull, sc, 0);
  const float cos_half = __shfl_sync(kFull, sc, 1);
  const float sinc = small ? 0.5f : __fdiv_rn(sin_half, ksafe);
  float dq[4];
  dq[0] = small ? 1.0f : cos_half;
#pragma unroll
  for (int i = 0; i < 3; ++i) dq[i + 1] = __fmul_rn(dx[i], sinc);

  // xd.quat_multiply(q, dq), then quat_normalize: p on every lane, each
  // lane 0-3 one division.
  const float aw = q[0], ax = q[1], ay = q[2], az = q[3];
  const float bw = dq[0], bx = dq[1], by = dq[2], bz = dq[3];
  float pq[4];
  pq[0] = __fmaf_rn(-az, bz, __fmaf_rn(-ay, by, __fmaf_rn(aw, bw,
                                                         -__fmul_rn(ax, bx))));
  pq[1] = __fmaf_rn(-az, by, __fmaf_rn(ay, bz, __fmaf_rn(ax, bw,
                                                        __fmul_rn(aw, bx))));
  pq[2] = __fmaf_rn(az, bx, __fmaf_rn(ay, bw, __fmaf_rn(aw, by,
                                                       -__fmul_rn(ax, bz))));
  pq[3] = __fmaf_rn(az, bw, __fmaf_rn(-ay, bx, __fmaf_rn(aw, bz,
                                                        __fmul_rn(ax, by))));
  float n4 = __fmul_rn(pq[0], pq[0]);
#pragma unroll
  for (int i = 1; i < 4; ++i) n4 = __fmaf_rn(pq[i], pq[i], n4);
  const float pn = clamp_min(__fsqrt_rn(n4), 1e-12f);
  // Selects one after another (a chain of ternaries became branches).
  float num = pq[0];
  num = lane == 1 ? pq[1] : num;
  num = lane == 2 ? pq[2] : num;
  num = lane == 3 ? pq[3] : num;
  const float qv = __fdiv_rn(num, pn);
  // |dq.vec| on lane 7, |dt| on the others.
  const bool dq_lane = lane == 7;
  const float nv = norm3(dq_lane ? dq[1] : dx[3], dq_lane ? dq[2] : dx[4],
                         dq_lane ? dq[3] : dx[5]);
  if (lane < 4) {
    out.q[p * 4 + lane] = qv;
  } else if (lane < 7) {
    const int i = lane - 4;
    float step = dx[3];
    step = i == 1 ? dx[4] : step;
    step = i == 2 ? dx[5] : step;
    out.t[p * 3 + i] = __fadd_rn(s_in[60 + i], step);
  } else if (lane == 7) {
    out.dq_norm[p] = nv;
  } else if (lane == 8) {
    out.dt_norm[p] = nv;
  }
  GU_STAMP(7);
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

#ifdef GU_PHASE_TIMING
const char* gu_phase_names() { return kPhaseNames; }

// The last launch's stamps: ns and clk of kStamps entries each.
int gu_phase_read(unsigned long long* ns, long long* clk) {
  cudaError_t err = cudaMemcpyFromSymbol(ns, gu_stamp_ns, sizeof(gu_stamp_ns));
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(clk, gu_stamp_clk, sizeof(gu_stamp_clk));
  }
  return static_cast<int>(err);
}

int gu_stamps() { return kStamps; }
#endif

}  // extern "C"
