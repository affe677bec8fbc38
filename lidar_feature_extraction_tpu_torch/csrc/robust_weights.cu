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
//   t_k = fma(w, k + 1, lo) (w = (hi - lo) / 256), j = #{k : count(v <=
//   t_k) < (n + 1) / 2} (at most 255), lo, hi = fma(w, j, lo),
//   fma(w, j + 1, lo), then 0.5 (lo + hi), NaN when nothing is valid;
// - the Huber weights of the valid errors over scale + 1e-16
//   (huber_derivative): 1 below k^2, else k * xf.rsqrt(e), the x86
//   vrsqrtps estimate (a 12-bit mantissa that depends on the exponent's
//   parity and the top ten mantissa bits alone, read from a 2,048-entry
//   table built on the host in float64, ops/gn_kernels_cuda.py::
//   rsqrt_table) and two fused Newton steps;
// - for the fused loop, the _wide_median of each residual block's errors.
// Every FMA is __fmaf_rn, every division IEEE (__fdiv_rn), and the file is
// built with --fmad=false, so nothing else is contracted.
//
// It ports no TPU kernel: the reference leaves this arithmetic to XLA. It
// replaces the ~360 launches per iteration of the chains above with one.
//
// Bound: per lane N errors (4 bytes) and flags (1 byte) read and N weights
// written, 9 bytes per correspondence, ~0.03 us at N = 10,240 and 3.35
// TB/s. What bounds it is the two medians' chain of dependent steps, each
// a pass over the lane's values and a barrier across the CTAs that hold
// them. The first design (one block of 1,024 threads, values in shared
// memory) took 64 us, of which (its -DRW_PHASE_TIMING split) 37 us were
// the six histogram passes' 8-step binary searches through dependent
// shared loads, 8 us the error total's bank-conflicted first level, 7 us
// the float64 rsqrt estimates and 6 us two serial 32-step block
// reductions. So here:
//
// - A lane's values (its residual block's, for a block median) are spread
//   over a cluster of C CTAs (2 to 8, from B x tasks against the card's
//   132 SMs; -DRW_CLUSTER fixes it), each of kMedThreads threads holding
//   up to kVals of them, loaded once, coalesced, in a column of shared
//   memory each (no bank conflicts; values past C x kMedThreads x kVals
//   are read from memory on each pass). The passes are compact loops: the
//   same design unrolled over values in registers grew to ~6,600
//   instructions and every phase, even a pass over three values a thread,
//   took microseconds (PERF.md).
// - A value's bucket, the first k with v <= t_k, comes from an exact
//   guess-and-correct search: below t_0 or above t_255 (or NaN) at once;
//   else the guess ceil((v - lo) / w) - 1 walked against the fma-computed
//   thresholds themselves (down while v <= t_{g-1}, up while !(v <= t_g)),
//   usually two fmas. t_k does not decrease in k (w >= 0 and rounding is
//   monotone) or is NaN for every k, so this is the binary search's bucket.
//   Bucket 0 is counted in registers and added once per warp; the others
//   with shared atomics into the CTA's histogram.
// - An exchange: each CTA's counts (or count, min and max per warp) go to
//   its own shared memory; a cluster barrier; then warp 0 of each CTA
//   reads all C CTAs' (distributed shared memory), scans the 256 counts in
//   registers and shuffles (8 a lane), and passes j on through a block
//   barrier. Histograms rotate over three buffers, each cleared by the
//   pass after its readers' barrier.
// - Each median's count and range and its round 1 take an exchange each;
//   rounds 2 and 3 usually take one between them: the values that can
//   still fall between round 2's or 3's thresholds are those in round 1's
//   bucket j and the next, a few per cent of the lane, and every CTA
//   counts both rounds alone from the cluster's list of them (see
//   wide_median). Many values tied near the median fall back to an
//   exchange a round.
// - The error total runs beside the medians on eight warps of its own: it
//   stages 256 windows at a time into shared memory at a stride of 33
//   floats (no bank conflicts), sums each window in order on one thread,
//   and the upper levels likewise. Those warps join no block barrier of the
//   medians; they arrive at the first cluster barrier before they start
//   and keep every later one.
// - The rsqrt estimate is a table read from shared memory (4 KB, copied at
//   the start), not a float64 division and square root per weight.
// Every lane is computed as it would be alone: counts are exact integers
// whatever their order and whichever CTA holds a value, and the total
// keeps reduce_sum's order.
//
// Built with gn_update.cu and gn_kernels_op.cpp into one library by
// ops/gn_kernels_cuda.py::build (nvcc, sm_90a, --fmad=false) into
// build/kernels/ at first use, and called through the operator
// lidar_port::robust_weights. profile_robust_weights.py builds it alone,
// also with -DRW_PHASE_TIMING.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMedThreads = 512;   // the medians' and weights' threads
constexpr int kMedWarps = kMedThreads / 32;
constexpr int kTotalThreads = 256;  // the error total's
constexpr int kThreads = kMedThreads + kTotalThreads;
constexpr int kVals = 32;           // values a thread holds in shared memory
constexpr int kBranch = 256;
constexpr int kRounds = 3;
constexpr int kMaxBlocks = 16;
constexpr int kMaxCluster = 8;
constexpr int kSms = 132;
constexpr int kRsqrtEntries = 2048;
constexpr int kCandidates = 4;      // a thread's candidates, at most
constexpr int kChunkWindows = kTotalThreads;  // level-0 windows per chunk
constexpr int kChunkFloats = 33 * kChunkWindows;
// Shared memory a block may ask for (H100: 227 KB), less this file's static
// shared memory.
constexpr int kMaxDynamicSmem = 227 * 1024 - 16 * 1024;
constexpr double kMadConsistency = 1.482602218505602;
constexpr int kMaxDevices = 64;

// xf.rsqrt's 12-bit estimate by (exponent parity << 10 | top ten mantissa
// bits), set once per device by robust_weights_set_table.
__device__ __align__(16) uint16_t rsqrt_m12[kRsqrtEntries];
bool table_set[kMaxDevices];

struct Params {
  const float* errors;         // [B, N], contiguous
  const unsigned char* valid;  // [B, N], contiguous
  int n;
  int n_blocks;                // residual blocks; their medians if > 0
  int size[kMaxBlocks];
  int cluster;                 // CTAs per lane and task
  int held;                    // values a thread holds in shared memory
  int local;                   // every value held: rounds 2 and 3 local
  float huber_k;
  float huber_kk;              // float32(k * k)
  int* n_valid;                // [B]
  float* error;                // [B]
  float* scale;                // [B]
  float* weights;              // [B, N]
  float* block_meds;           // [B, n_blocks]
};

struct Shared {
  int hist[3][kBranch];
  int local_hist[2][kBranch];        // the rounds a CTA counts alone
  int ncand;                         // this CTA's candidates
  int from_candidates;               // rounds 2 and 3 from the candidates
  int last;                          // the last cluster barrier's index
  int cand_start[kMaxCluster + 1];   // the cluster's, by rank
  float h;                           // the candidates' upper end
  int part_count[2][kMedWarps];
  float part_lo[2][kMedWarps], part_hi[2][kMedWarps];
  uint16_t m12[kRsqrtEntries];
  int j;
  int count;
  float lo, hi;
};

__shared__ __align__(16) Shared sh;

#ifdef RW_PHASE_TIMING
// A build the port never uses (profile_robust_weights.py): thread 0 of
// lane 0's task-0 CTA of rank 0 stamps %globaltimer and clock64() after a
// barrier of the medians' threads at each phase boundary; the error
// total's thread 0 stamps its end in the last slot. A name with "+" is
// measured from the start.
constexpr int kStamps = 32;
__device__ unsigned long long rw_stamp_ns[kStamps];
__device__ long long rw_stamp_clk[kStamps];
constexpr const char* kPhaseNames =
    "load,"
    "med.minmax,med.minmax.exchange,med.r0.pass,med.r0.exchange,"
    "med.cand.pass,med.cand.exchange,med.r1.local,med.r2.local,"
    "mad.minmax,mad.minmax.exchange,mad.r0.pass,mad.r0.exchange,"
    "mad.cand.pass,mad.cand.exchange,mad.r1.local,mad.r2.local,weights,"
    "+total";

__device__ __forceinline__ void stamp_at(int k) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  rw_stamp_ns[k] = ns;
  rw_stamp_clk[k] = clock64();
}
#endif

__device__ __forceinline__ void med_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kMedThreads) : "memory");
}

__device__ __forceinline__ void total_barrier() {
  asm volatile("bar.sync 2, %0;" ::"n"(kTotalThreads) : "memory");
}

// A cluster barrier's arrival. The CTAs hand each other only what they
// wrote to their own shared memory, which the others read after the
// barrier's wait; a fence at CTA scope has those writes performed in that
// memory first. (A release at cluster scope, the barrier's default, fences
// the whole GPU's memory and took ~5 us more per launch.)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile(
      "fence.acq_rel.cta;\n\t"
      "barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

struct Stamper {
  bool on;
  int k;
  // After a barrier of the medians' threads (the build without stamps
  // adds none).
  __device__ void operator()() {
#ifdef RW_PHASE_TIMING
    med_barrier();
    if (on && threadIdx.x == 0 && k < kStamps - 1) stamp_at(k);
    ++k;
#endif
  }
};

// torch.amin / amax: a NaN wins.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

// A CTA's share of one lane's (or residual block's) values: value k of
// thread t of rank r is element t + r * kMedThreads + k * C * kMedThreads,
// held for k < cnt (at most kVals) in shared memory at sv[k * kMedThreads
// + t] (a column per thread: no bank conflicts), its flag in bit k of
// `ok`; elements from `over` on are read from memory on each pass.
struct Values {
  float* sv;
  uint32_t ok;
  int cnt;
  const float* e;
  const unsigned char* m;
  int n, first, stride, over;

  __device__ void load(const float* e_, const unsigned char* m_, int n_,
                       int rank, int cluster, int held, float* sv_) {
    e = e_;
    m = m_;
    n = n_;
    sv = sv_ + threadIdx.x;
    first = threadIdx.x + rank * kMedThreads;
    stride = cluster * kMedThreads;
    over = held * stride;
    cnt = first < n ? min(held, (n - first + stride - 1) / stride) : 0;
    ok = 0;
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      const int i = first + k * stride;
      sv[k * kMedThreads] = e[i];
      ok |= static_cast<uint32_t>(m[i] != 0) << k;
    }
  }

  // f(value) for every valid value.
  template <typename F>
  __device__ __forceinline__ void each_valid(F f) const {
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      if ((ok >> k) & 1u) f(sv[k * kMedThreads]);
    }
    for (int i = over + first; i < n; i += stride) {
      if (m[i]) f(e[i]);
    }
  }

  // f(index, value or 0 where not valid) for every element.
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
#pragma unroll 4
    for (int k = 0; k < cnt; ++k) {
      f(first + k * stride, (ok >> k) & 1u ? sv[k * kMedThreads] : 0.0f);
    }
    for (int i = over + first; i < n; i += stride) {
      f(i, m[i] ? e[i] : 0.0f);
    }
  }
};

// An exchange of one lane's cluster: every CTA's part (its warps' count,
// min and max, or its histogram) is in its own shared memory; after a
// cluster barrier warp 0 of each CTA reads every CTA's (distributed shared
// memory), combines them and hands the result on through a block barrier.
struct Exchange {
  int cluster;
  int q;  // exchanges passed

  __device__ __forceinline__ const Shared* rank(int r) const {
    return cg::this_cluster().map_shared_rank(&sh, r);
  }
};

// Exchange q's pass clears buffer (q + 1) % 3 of the histograms, whose last
// readers (exchange q - 2's) passed exchange q - 1's barrier: each warp its
// 16 buckets.
__device__ __forceinline__ void clear_next_histogram(const Exchange& ex) {
  const int lane = threadIdx.x & 31;
  if (lane < kBranch / kMedWarps) {
    sh.hist[(ex.q + 1) % 3][(threadIdx.x >> 5) * (kBranch / kMedWarps) +
                            lane] = 0;
  }
}

// The median's value of a stored one: itself, or |x - center| for the
// MAD.
struct Value {
  bool absdev;
  float center;
  __device__ __forceinline__ float operator()(float x) const {
    return absdev ? fabsf(__fsub_rn(x, center)) : x;
  }
};

// The count, min and max over the cluster's valid values, in every
// thread of the medians.
__device__ __forceinline__ void count_and_range(const Values& vals, Value f,
                                                Exchange& ex, int& count,
                                                float& lo, float& hi,
                                                Stamper& stamp) {
  const int buf = ex.q & 1, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  clear_next_histogram(ex);
  int c = 0;
  float a = __int_as_float(0x7f800000), b = __int_as_float(0xff800000);
  vals.each_valid([&](float x) {
    const float y = f(x);
    ++c;
    a = nan_min(a, y);
    b = nan_max(b, y);
  });
  c = __reduce_add_sync(0xffffffffu, c);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = nan_min(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = nan_max(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (lane == 0) {
    sh.part_count[buf][warp] = c;
    sh.part_lo[buf][warp] = a;
    sh.part_hi[buf][warp] = b;
  }
  stamp();
  cluster_arrive();
  cluster_wait();
  if (warp == 0) {
    c = 0;
    a = __int_as_float(0x7f800000);
    b = __int_as_float(0xff800000);
    if (lane < kMedWarps) {
      for (int r = 0; r < ex.cluster; ++r) {
        const Shared* s = ex.rank(r);
        c += s->part_count[buf][lane];
        a = nan_min(a, s->part_lo[buf][lane]);
        b = nan_max(b, s->part_hi[buf][lane]);
      }
    }
    c = __reduce_add_sync(0xffffffffu, c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a = nan_min(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = nan_max(b, __shfl_xor_sync(0xffffffffu, b, o));
    }
    // An element that is not valid counts as FLT_MAX in the min and as
    // -FLT_MAX in the max (torch.where(mask, v, +-big)).
    if (c < vals.n) {
      a = nan_min(a, FLT_MAX);
      b = nan_max(b, -FLT_MAX);
    }
    if (lane == 0) {
      sh.count = c;
      sh.lo = a;
      sh.hi = b;
    }
  }
  med_barrier();
  ++ex.q;
  count = sh.count;
  lo = sh.lo;
  hi = sh.hi;
  stamp();
}

// The first k in [0, 256) with v <= t_k = fma(w, k + 1, lo), or 256: at
// once below t_0 and above t_255 (a NaN value or NaN thresholds included:
// every comparison false); else from the guess ceil((v - lo) / w) - 1
// (v - lo times the rounded 1 / w, or divided for a subnormal w), walked
// against the thresholds.
__device__ __forceinline__ int bucket(float v, float w, float lo, float inv,
                                      bool divide, float t0, float t255) {
  if (v <= t0) return 0;
  if (!(v <= t255)) return kBranch;
  const float x = __fsub_rn(v, lo);
  const float q = __fsub_rn(ceilf(divide ? __fdiv_rn(x, w) : __fmul_rn(x, inv)),
                            1.0f);
  int g = q >= 255.0f ? 255 : (q >= 1.0f ? static_cast<int>(q) : 1);
  // t_0 < v <= t_255, so the bucket is in [1, 255].
  while (g > 1 && v <= __fmaf_rn(w, static_cast<float>(g), lo)) --g;
  while (g < 255 && !(v <= __fmaf_rn(w, static_cast<float>(g + 1), lo))) {
    ++g;
  }
  return g;
}

// j = #{k : count(v <= t_k) < half} (at most 255) from a lane's counts of
// buckets 8 lane .. 8 lane + 7, in every lane of the calling warp: their
// running sum, then the warp's (left in c).
__device__ __forceinline__ int scan_bucket(int (&c)[8], int half) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k < 8; ++k) c[k] += c[k - 1];
  int before = c[7];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, before, o);
    if (lane >= o) before += y;
  }
  before -= c[7];
  int under = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c[k] += before;  // count(v <= t_k)
    under += c[k] < half;
  }
  return min(__reduce_add_sync(0xffffffffu, under), kBranch - 1);
}

// count(v <= t_k) (0 for k < 0) from scan_bucket's running sums, in every
// lane of the calling warp.
__device__ __forceinline__ int running_sum(const int (&c)[8], int k) {
  int v = 0;
#pragma unroll
  for (int x = 0; x < 8; ++x) v = x == (k & 7) ? c[x] : v;
  v = __shfl_sync(0xffffffffu, v, (k >> 3) & 31);
  return k < 0 ? 0 : v;
}

// scan_bucket over the histograms hist[buf] of the cluster's CTAs.
__device__ __forceinline__ int median_bucket(const Exchange& ex, int buf,
                                             int half, int (&c)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = 0;
  for (int rk = 0; rk < ex.cluster; ++rk) {
    const int4* h = reinterpret_cast<const int4*>(ex.rank(rk)->hist[buf]);
    const int4 a = h[lane * 2], b = h[lane * 2 + 1];
    c[0] += a.x; c[1] += a.y; c[2] += a.z; c[3] += a.w;
    c[4] += b.x; c[5] += b.y; c[6] += b.z; c[7] += b.w;
  }
  return scan_bucket(c, half);
}

// The thresholds of one round over [lo, hi] and a value's bucket.
struct Round {
  float lo, w, t0, t255, inv;
  bool divide;

  __device__ __forceinline__ explicit Round(float lo_, float hi) : lo(lo_) {
    w = __fdiv_rn(__fsub_rn(hi, lo), static_cast<float>(kBranch));
    t0 = __fmaf_rn(w, 1.0f, lo);
    t255 = __fmaf_rn(w, static_cast<float>(kBranch), lo);
    divide = w < FLT_MIN;
    inv = __frcp_rn(w);
  }
  __device__ __forceinline__ int of(float v) const {
    return bucket(v, w, lo, inv, divide, t0, t255);
  }
  // The next round's range from this round's j.
  __device__ __forceinline__ void next(int j, float& lo_out,
                                       float& hi_out) const {
    const float jf = static_cast<float>(j);
    lo_out = __fmaf_rn(w, jf, lo);
    hi_out = __fmaf_rn(w, __fadd_rn(jf, 1.0f), lo);
  }
};

// Round r of a median by an exchange of histograms: each CTA counts its
// values into hist[q % 3], and after the cluster barrier warp 0 sums the
// cluster's and finds j; with `upper` it also decides whether rounds 2 and
// 3 may count candidates alone (sh.from_candidates, their upper end H in
// sh.h).
__device__ __forceinline__ void exchange_round(const Values& vals, Value f,
                                               Exchange& ex, int half,
                                               bool upper, float& lo,
                                               float& hi, Stamper& stamp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int buf = ex.q % 3;
  clear_next_histogram(ex);
  // The candidates' count, whose last remote readers passed the barrier
  // before this pass.
  if (upper && threadIdx.x == 0) sh.ncand = 0;
  const Round rd(lo, hi);
  int below0 = 0;  // bucket 0, counted in registers
  vals.each_valid([&](float x) {
    const int g = rd.of(f(x));
    if (g == 0) {
      ++below0;
    } else if (g < kBranch) {
      atomicAdd(&sh.hist[buf][g], 1);
    }
  });
  below0 = __reduce_add_sync(0xffffffffu, below0);
  if (lane == 0 && below0) atomicAdd(&sh.hist[buf][0], below0);
  stamp();
  cluster_arrive();
  cluster_wait();
  if (warp == 0) {
    int c[8];
    const int j = median_bucket(ex, buf, half, c);
    if (upper) {
      // H is round 2's t_255. The candidates lie in buckets j and j + 1
      // when H is at most t_(j+1); take them if those hold at most
      // kCandidates a thread.
      float lo2, hi2;
      rd.next(j, lo2, hi2);
      const float h = Round(lo2, hi2).t255;
      const int bound = running_sum(c, j + 1) - running_sum(c, j - 1);
      const bool fits =
          j < kBranch - 1 &&
          h <= __fmaf_rn(rd.w, static_cast<float>(j + 2), rd.lo) &&
          bound <= kCandidates * kMedThreads;
      if (lane == 0) {
        sh.h = h;
        sh.from_candidates = fits;
      }
    }
    if (lane == 0) sh.j = j;
  }
  med_barrier();
  ++ex.q;
  rd.next(sh.j, lo, hi);
  stamp();
}

// stats._wide_median of the cluster's valid values (f gives each value from
// the stored one), in every thread of the medians; `count` gets the valid
// count. Its count and range and round 1 go through exchanges. Then, when
// every value is held (`local`): with round 1's j known, a value at or
// below round 2's lo (L) counts below every threshold of rounds 2 and 3
// that is not NaN (those are at least L), and a value above H, round 2's
// t_255, below none of round 2's (nor of round 3's, when its t_255 is at
// most H, as it is unless rounding lifts it). So, if buckets j and j + 1
// hold at most kCandidates values a thread, one pass lists the values in
// (L, H], the candidates, in each CTA's `clist` and counts those at or
// below L, and after one exchange every CTA counts rounds 2 and 3 alone
// from the cluster's candidates (distributed shared memory), a round with
// NaN thresholds counting nothing. Otherwise (many values near the median,
// or round 3's t_255 above H) the rounds left go through exchanges.
__device__ __forceinline__ float wide_median(const Values& vals, Value f,
                                             Exchange& ex, int& count,
                                             Stamper& stamp, bool local,
                                             float* clist) {
  float lo, hi;
  count_and_range(vals, f, ex, count, lo, hi, stamp);
  const int half = (count + 1) / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  exchange_round(vals, f, ex, half, local, lo, hi, stamp);
  int rounds_left = kRounds - 1;
  if (local && sh.from_candidates) {
    const float low = lo, high = sh.h;
    clear_next_histogram(ex);
    sh.local_hist[threadIdx.x / kBranch][threadIdx.x % kBranch] = 0;
    int at_or_below = 0;
    for (int k = 0; k < vals.cnt; ++k) {
      if ((vals.ok >> k) & 1u) {
        const float y = f(vals.sv[k * kMedThreads]);
        at_or_below += y <= low;
        if (low < y && y <= high) clist[atomicAdd(&sh.ncand, 1)] = y;
      }
    }
    at_or_below = __reduce_add_sync(0xffffffffu, at_or_below);
    const int buf = ex.q & 1;
    if (lane == 0) sh.part_count[buf][warp] = at_or_below;
    stamp();
    cluster_arrive();
    cluster_wait();
    int below_low = 0;  // warp 0's: the cluster's values at or below L
    if (warp == 0) {
      // Each rank's candidates start at the running sum of their counts.
      const int n_r = lane < ex.cluster ? ex.rank(lane)->ncand : 0;
      int end = n_r;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, end, o);
        if (lane >= o) end += y;
      }
      const int total = __shfl_sync(0xffffffffu, end, ex.cluster - 1);
      if (lane <= ex.cluster) {
        sh.cand_start[lane] = lane < ex.cluster ? end - n_r : total;
      }
#pragma unroll
      for (int x = lane; x < kMaxCluster * kMedWarps; x += 32) {
        if (x < ex.cluster * kMedWarps) {
          below_low += ex.rank(x / kMedWarps)->part_count[buf][x % kMedWarps];
        }
      }
      below_low = __reduce_add_sync(0xffffffffu, below_low);
    }
    med_barrier();
    ++ex.q;
    const int total = sh.cand_start[ex.cluster];
    stamp();
    {
      // Candidates threadIdx.x + k kMedThreads, read once for both rounds.
      float mine[kCandidates];
#pragma unroll
      for (int k = 0; k < kCandidates; ++k) {
        const int c = threadIdx.x + k * kMedThreads;
        if (c < total) {
          int r = 0;
          while (c >= sh.cand_start[r + 1]) ++r;
          mine[k] = cg::this_cluster().map_shared_rank(clist, r)[
              c - sh.cand_start[r]];
        }
      }
      rounds_left = 0;
#pragma unroll 1
      for (int i = 0; i < kRounds - 1; ++i) {
        const Round rd(lo, hi);
        if (rd.t255 > high) {  // round 3's end above H: by an exchange
          rounds_left = 1;
          break;
        }
        if (rd.t0 == rd.t0) {  // NaN thresholds count nothing
#pragma unroll
          for (int k = 0; k < kCandidates; ++k) {
            if (threadIdx.x + k * kMedThreads < total) {
              const int g = rd.of(mine[k]);
              if (g < kBranch) atomicAdd(&sh.local_hist[i][g], 1);
            }
          }
          if (warp == 0 && lane == 0) {
            atomicAdd(&sh.local_hist[i][0], below_low);
          }
        }
        med_barrier();
        if (warp == 0) {
          const int4* h = reinterpret_cast<const int4*>(sh.local_hist[i]);
          const int4 a = h[lane * 2], b = h[lane * 2 + 1];
          int counts[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
          const int j = scan_bucket(counts, half);
          if (lane == 0) sh.j = j;
        }
        med_barrier();
        rd.next(sh.j, lo, hi);
        stamp();
      }
    }
  }
#pragma unroll 1
  for (; rounds_left > 0; --rounds_left) {
    exchange_round(vals, f, ex, half, false, lo, hi, stamp);
  }
  const float med = __fmul_rn(0.5f, __fadd_rn(lo, hi));
  return count > 0 ? med : __int_as_float(0x7fc00000);
}

// xd.reduce_sum of the valid errors of e[0, n) (invalid ones are +0) on
// the kTotalThreads threads t: the padded row's windows, 256 at a time,
// staged into `stage` at a stride of 33 floats and summed in order, their
// sums into `levels` (each level's element i at i + i / 32); then the upper
// levels likewise; the last at most 32 in order onto +0 by thread 0.
__device__ float tree_sum(const float* e, const unsigned char* m, int n,
                          float* stage, float* levels, int t) {
  auto at = [](int i) { return i + (i >> 5); };
  float acc = 0.0f;
  if (n <= 32) {
    if (t == 0) {
      for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, m[i] ? e[i] : 0.0f);
    }
    return acc;
  }
  int len = n;
  int pad = (32 - len % 32) % 32, front = pad / 2;
  int windows = (len + pad) / 32;
  for (int w0 = 0; w0 < windows; w0 += kChunkWindows) {
    const int first = 32 * w0 - front;
    const int staged = 32 * min(kChunkWindows, windows - w0);
#pragma unroll 8
    for (int s = t; s < staged; s += kTotalThreads) {
      const int i = first + s;
      const bool in = i >= 0 && i < len;
      const float v = in ? e[i] : 0.0f;  // not waiting for the flag
      stage[at(s)] = (in && m[i]) ? v : 0.0f;
    }
    total_barrier();
    if (w0 + t < windows) {
      const float* x = stage + 33 * t;
      float sum = x[0];
#pragma unroll
      for (int i = 1; i < 32; ++i) sum = __fadd_rn(sum, x[i]);
      levels[at(w0 + t)] = sum;
    }
    total_barrier();
  }
  float* src = levels;
  len = windows;
  while (len > 32) {
    float* dst = src + at(len) + 1;
    pad = (32 - len % 32) % 32;
    front = pad / 2;
    windows = (len + pad) / 32;
    for (int w = t; w < windows; w += kTotalThreads) {
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int p = 32 * w + i - front;
        const float x = (p >= 0 && p < len) ? src[at(p)] : 0.0f;
        sum = i == 0 ? x : __fadd_rn(sum, x);
      }
      dst[at(w)] = sum;
    }
    total_barrier();
    src = dst;
    len = windows;
  }
  if (t == 0) {
    for (int i = 0; i < len; ++i) acc = __fadd_rn(acc, src[at(i)]);
  }
  return acc;
}

// xf.rsqrt of a positive float32: the vrsqrtps estimate from the table,
// two Newton steps.
__device__ __forceinline__ float rsqrt_xla(float v, const uint16_t* m12) {
  const int bits = __float_as_int(v);
  const int exponent = (bits >> 23) & 0xFF;
  const int odd = exponent & 1;
  const int scale = 126 - (exponent - (odd ? 127 : 128)) / 2;
  float y = __uint_as_float(
      (static_cast<unsigned>(scale) << 23) |
      (static_cast<unsigned>(m12[(odd << 10) | ((bits >> 13) & 0x3FF)])
       << 11));
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    y = __fmaf_rn(__fmul_rn(y, -0.5f),
                  __fmaf_rn(__fmul_rn(v, y), y, -1.0f), y);
  }
  return y;
}

// stats.huber_derivative(e, k) in float32.
__device__ __forceinline__ float huber_weight(float e, float k, float kk,
                                              const uint16_t* m12) {
  const float safe = (e != e || e >= kk) ? e : kk;  // clamp_min(e, k * k)
  const float above = __fmul_rn(k, rsqrt_xla(safe, m12));
  return e < kk ? 1.0f : above;
}

__global__ void __launch_bounds__(kThreads, 1)
    robust_weights_kernel(Params p) {
  extern __shared__ float4 dynamic_smem[];
  const int cluster = p.cluster;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const long long lane = blockIdx.x / cluster;
  const int task = blockIdx.y;  // 0: count, total, scale, weights

  int off = 0, n = p.n;
  if (task > 0) {
    for (int s = 0; s < task - 1; ++s) off += p.size[s];
    n = p.size[task - 1];
  }
  const float* e = p.errors + lane * p.n + off;
  const unsigned char* m = p.valid + lane * p.n + off;

  if (threadIdx.x == 0) sh.last = -1;  // seen after the first barrier
  if (threadIdx.x >= kMedThreads) {
    // The error total, beside the medians, on its own warps, which keep
    // the cluster's barriers (arriving at the first before they start)
    // until the medians' threads mark the last.
    cluster_arrive();
    if (task == 0 && rank == 0) {
      float* stage = reinterpret_cast<float*>(dynamic_smem) +
                     (p.local ? 2 : 1) * p.held * kMedThreads;
      const int t = threadIdx.x - kMedThreads;
      const float error = tree_sum(e, m, n, stage, stage + kChunkFloats, t);
      if (t == 0) {
        p.error[lane] = error;
#ifdef RW_PHASE_TIMING
        if (lane == 0) stamp_at(kStamps - 1);
#endif
      }
    }
    cluster_wait();
    // Barrier b is the last when the medians' thread 0 has set `last` to b
    // before arriving there (it may set it while this warp is between
    // barrier b - 1 and b, so a barrier's own index is compared).
    for (int b = 0; sh.last != b; ++b) {
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  Stamper stamp{lane == 0 && task == 0 && rank == 0, 0};
#ifdef RW_PHASE_TIMING
  if (stamp.on && threadIdx.x == 0) stamp_at(0);
  stamp.k = 1;
#endif
  if (task == 0) {
    for (int i = threadIdx.x; i < kRsqrtEntries / 2; i += kMedThreads) {
      reinterpret_cast<uint32_t*>(sh.m12)[i] =
          reinterpret_cast<const uint32_t*>(rsqrt_m12)[i];
    }
  }
  Values vals;
  float* sv = reinterpret_cast<float*>(dynamic_smem);
  vals.load(e, m, n, rank, cluster, p.held, sv);
  float* clist = sv + p.held * kMedThreads;  // the candidates (local)
  stamp();
  Exchange ex{cluster, 0};

  // The median, then (task 0) the MAD, through one copy of the code.
  int count = 0;
  float med = 0.0f, mad = 0.0f;
#pragma unroll 1
  for (int k = 0; k < (task == 0 ? 2 : 1); ++k) {
    const float x = wide_median(vals, Value{k == 1, med}, ex, count, stamp,
                                p.local != 0, clist);
    (k == 0 ? med : mad) = x;
  }
  if (task > 0) {
    if (threadIdx.x == 0) sh.last = ex.q;
    cluster_arrive();  // done reading the others' shared memory
    if (rank == 0 && threadIdx.x == 0) {
      p.block_meds[lane * p.n_blocks + task - 1] = med;
    }
    cluster_wait();  // theirs is done reading this CTA's
    return;
  }
  if (threadIdx.x == 0) sh.last = ex.q;
  cluster_arrive();  // the last barrier
  const float scale = __fmul_rn(static_cast<float>(kMadConsistency), mad);
  if (rank == 0 && threadIdx.x == 0) {
    p.n_valid[lane] = count;
    p.scale[lane] = scale;
  }
  const float denom = __fadd_rn(scale, 1e-16f);
  float* w = p.weights + lane * p.n;
  vals.each([&](int i, float x) {
    w[i] = huber_weight(__fdiv_rn(x, denom), p.huber_k, p.huber_kk, sh.m12);
  });
  stamp();
  cluster_wait();
}

// Floats of the error total's dynamic shared memory: the stage and every
// level above the row, each at i + i / 32 with a float between levels.
long long total_floats(int n) {
  long long total = kChunkFloats;
  long long len = n;
  while (len > 32) {
    len = (len + 31) / 32;
    total += len + len / 32 + 1;
  }
  return total;
}

// CTAs per lane and task: the largest power of two up to 8 with which the
// launch's CTAs fit on the card's SMs at one each, and at least 2 (at
// 10,240 x 32 with the block medians two waves of 2 beat one of 1 by a
// third: a lone CTA holds 20 values a thread).
int cluster_size(int batch, int tasks) {
#ifdef RW_CLUSTER
  (void)batch;
  (void)tasks;
  return RW_CLUSTER;
#else
  int c = kMaxCluster;
  while (c > 2 && static_cast<long long>(batch) * tasks * c > kSms) c /= 2;
  return c;
#endif
}

}  // namespace

extern "C" {

int robust_weights_max_blocks() { return kMaxBlocks; }

// CTAs per lane of a launch of `batch` lanes and `tasks` tasks each.
int robust_weights_cluster_size(int batch, int tasks) {
  return cluster_size(batch, tasks);
}

const char* robust_weights_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Copies xf.rsqrt's estimates (`entries` = 2,048 uint16 in host memory,
// ops/gn_kernels_cuda.py::rsqrt_table) to the current device; the kernel
// refuses to launch on a device without them. Returns a cudaError_t.
int robust_weights_set_table(const uint16_t* table, int entries) {
  if (entries != kRsqrtEntries) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  err = cudaMemcpyToSymbol(rsqrt_m12, table, sizeof(rsqrt_m12));
  if (err == cudaSuccess) table_set[device] = true;
  return static_cast<int>(err);
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
  int device = 0;
  const cudaError_t dev_err = cudaGetDevice(&device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  if (device < 0 || device >= kMaxDevices || !table_set[device]) {
    return cudaErrorNotReady;
  }
  Params p{};
  p.errors = errors;
  p.valid = valid;
  p.n = n;
  p.n_blocks = with_medians ? n_blocks : 0;
  for (int s = 0; s < n_blocks; ++s) p.size[s] = static_cast<int>(sizes[s]);
  const int tasks = 1 + p.n_blocks;
  p.cluster = cluster_size(batch, tasks);
  // Dynamic shared memory: a thread's values (up to kVals of its lane's; a
  // block's are fewer) and, when they are all held, as much room for the
  // candidates; then the error total's stage and levels.
  const long long stride = 1LL * p.cluster * kMedThreads;
  const long long column = 4LL * kMedThreads;  // one float a thread
  const long long total_bytes = 4LL * total_floats(n);
  long long held = std::min<long long>(kVals, (n + stride - 1) / stride);
  p.local = held * stride >= n &&
            total_bytes + 2 * held * column <= kMaxDynamicSmem;
  if (!p.local) {
    held = std::min(held, (kMaxDynamicSmem - total_bytes) / column);
  }
  if (held < 0 || static_cast<long long>(batch) * p.cluster > 0x7fffffffLL) {
    return cudaErrorInvalidValue;  // the error total's levels do not fit
  }
  p.held = static_cast<int>(held);
  const long long smem = total_bytes + (p.local ? 2 : 1) * held * column;
  p.huber_k = static_cast<float>(huber_k);
  p.huber_kk = static_cast<float>(huber_k * huber_k);
  p.n_valid = n_valid;
  p.error = error;
  p.scale = scale;
  p.weights = weights;
  p.block_meds = block_meds;
  if (smem + static_cast<long long>(sizeof(Shared)) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        robust_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config{};
  config.gridDim = dim3(static_cast<unsigned>(batch * p.cluster), tasks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(p.cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&config, robust_weights_kernel, p));
}

#ifdef RW_PHASE_TIMING
const char* rw_phase_names() { return kPhaseNames; }

// The last launch's stamps: ns and clk of kStamps entries each.
int rw_phase_read(unsigned long long* ns, long long* clk) {
  cudaError_t err = cudaMemcpyFromSymbol(ns, rw_stamp_ns, sizeof(rw_stamp_ns));
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(clk, rw_stamp_clk, sizeof(rw_stamp_clk));
  }
  return static_cast<int>(err);
}

int rw_stamps() { return kStamps; }
#endif

}  // extern "C"
