// K1: fused LOAM labeling + compaction columns, one 2-CTA cluster per ring.
//
// Replaces the Pallas kernel lidar_feature_extraction_tpu/ops/
// extraction_pallas.py::label_and_columns_pallas (its body _kernel runs
// label_planes + _voxel_run_key_planes + compact_columns of
// ops/extraction.py). The plain PyTorch version of the same function is
// lidar_feature_extraction_tpu_torch/ops/extraction.py::
// label_and_columns_plain; labels, curvature and col are bit-equal to it.
//
// Per ring: XY range -> curvature convolution -> cosine neighbour flags ->
// block ids from count -> edge NMS, then surface NMS (multi-select
// rounds, early exit, capped at nms_rounds) -> occlusion / out-of-range /
// parallel-beam overwrites -> voxel-run key -> compaction columns (edge
// rank capped at ce, stratified surface run ends, dump column ce+cs). The
// point mask is lane < count.
//
// What bounds it on the H100: bytes. It reads x, y, z and writes labels,
// curvature and col, 24 B per lane: 3.5 MB at 64 x 2304, 1.06 us at
// 3.35 TB/s; its ~45 float operations per lane take a tenth of that. It
// runs far from that bound because a ring is a chain of dependent steps
// (NMS rounds, scans) with little work in each, so the design cuts the
// latency of each step:
//
// - Two CTAs per ring (a thread block cluster, __cluster_dims__(2,1,1)):
//   128 CTAs on 132 SMs at 64 rings. CTA `rank` owns lanes
//   [rank * H, min(P, (rank + 1) * H)), H = P/2 rounded up to 32. Each
//   thread owns up to kSlots lanes, lane = lo + k * blockDim.x + tid, so
//   a warp's lanes in one slot are 32 consecutive lanes: one ballot word.
// - Halos by recomputation. A CTA stages x, y, z of its lanes plus kHalo
//   lanes on each side (3p <= 48 for p <= 16) in shared memory and
//   computes range, neighbour flags, block ids, curvature and window
//   masks there itself. Only what changes during the kernel crosses the
//   split, and only as stores into the partner's shared memory (no
//   remote loads): one alive word per NMS round, the round's "anything
//   selected" flag, one surface word and the two scan totals. Each
//   hand-over is one thread's stores and an mbarrier arrival on the
//   partner (pair_sync), not a cluster barrier (~630 ns each here).
// - Gap segments without a scan: lanes i < j share a segment (the
//   reference's equal gap prefix) iff every neighbour flag in [i, j) is
//   set, a test on the flag bits of the window.
// - Block boundaries (B + 1 values) computed once per ring in shared
//   memory; each lane finds its block by binary search.
// - NMS on ballot masks. Once per ring each lane builds 2p-bit masks over
//   its window (offsets -p..-1, +1..+p; so p <= 16): `win` (neighbour in
//   the ring, same segment, same block) and, per pass, `beats` (that
//   neighbour, while alive, blocks this lane: it scores higher, or equal
//   with the tie rule, and above -inf). Alive bits live in ballot words,
//   two parities. A round is: gather the window's alive bits from two
//   adjacent words, sel = alive & !(beats & alive_win), ballot; each warp
//   also evaluates sel for the p lanes on either side of its word (their
//   beats masks are in shared memory), so it can remove from the alive
//   set every lane with a selection in its window without waiting for
//   other warps: one pair barrier per round, after which the flag word
//   says whether to stop. The round cap is the reference's
//   nms_rounds.
// - Labels are written once per pass: point_code where a lane was ever
//   selected, else neighbor_code where it lay in the window of any
//   selection, else kept. This equals the reference's per-round writes.
//   Windows are symmetric, so a lane in the window of a selection at round
//   t is no longer alive after t and is never selected later: a
//   point_code is never overwritten by a later neighbor_code of the same
//   pass. Two lanes selected in one round inside each other's windows are
//   both -inf scores, and the reference too writes point_code over
//   neighbor_code there. A neighbor_code is the same whichever round
//   writes it.
// - Scans (edge rank, run id) as ballots + popc per word, one warp scan
//   over the CTA's word counts, and the partner's total as the carry.
//
// The design was measured against one CTA per ring (the whole ring in
// one CTA of up to 1024 threads, block barriers only), which was 4%
// slower at 64 x 2304, and with 1 and 3 lanes per thread, both slower;
// PERF.md has the numbers.
//
// Exactness: the float expressions that decide labels use explicit
// round-to-nearest intrinsics in the reference's order of operations,
// built with --fmad=false so that the compiler contracts nothing. Three
// expressions are fused on purpose with __fmaf_rn, because the
// reference's jitted float32 code (XLA:CPU) contracts them: the range
// sqrt(fma(x, x, y*y)), the neighbour cosine's dot fma(x, xn, y*yn), and
// the curvature's first step fma(-2p, r[i], r[i-1]); the plain version
// (ops/extraction.py) computes the same correctly rounded FMAs.
// Thresholds arrive as float, rounded the way JAX rounds a Python float
// against a float32 array; the voxel hash multiplies in uint32
// (wrap-around, as the reference's int32); integer divisions that can see
// a negative operand floor like JAX's //. Staged lanes outside [0, P)
// hold the values of the lane P away, so the reference's wrapping rolls
// need no special case.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSlots = 3;           // most own lanes per thread
constexpr int kLanesPerThread = 2;  // 1 and 3 measured slower
constexpr int kMaxThreads = 1024;   // so H <= 3072
constexpr int kHalo = 64;           // staged lanes on each side
constexpr int kMaxPadding = 16;     // 2p window bits in 32 bits
constexpr int kMaxBlocks = 127;
constexpr int kMaxWords = kSlots * kMaxThreads / 32;

enum : int {
  kDefault = 0,
  kEdge = 1,
  kEdgeNeighbor = 2,
  kSurface = 3,
  kSurfaceNeighbor = 4,
  kOutOfRange = 5,
  kOccluded = 6,
  kParallelBeam = 7,
};

// Mirrored by ops/extraction_cuda.py::_Params.
struct Params {
  int padding, n_blocks, nms_rounds, ce, cs;
  float cos_thr, edge_thr, surf_thr, dist_thr, min_range, max_range,
      par_thr, leaf;
};

// Phase timing, compiled only with -DK1_PHASE_TIMING (never in the
// production build): thread 0 of each CTA stamps %globaltimer and
// clock64() at each phase boundary, right after a barrier.
#ifdef K1_PHASE_TIMING
constexpr int kStampBlocks = 256;
constexpr int kStamps = 16;
__device__ unsigned long long k1_stamp_ns[kStampBlocks][kStamps];
__device__ long long k1_stamp_clk[kStampBlocks][kStamps];
__device__ int k1_stamp_rounds[kStampBlocks][2];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    k1_stamp_ns[blockIdx.x][k] = t;
    k1_stamp_clk[blockIdx.x][k] = clock64();
  }
}
__device__ __forceinline__ void stamp_rounds(int pass, int rounds) {
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks) {
    k1_stamp_rounds[blockIdx.x][pass] = rounds;
  }
}
// Per NMS round g < kStampRounds: clock64() and %globaltimer once the
// CTA's round work is done (after an extra block barrier) and once past
// the round's barrier.
constexpr int kStampRounds = 32;
__device__ long long k1_round_clk[kStampBlocks][kStampRounds][2];
__device__ unsigned long long k1_round_ns[kStampBlocks][kStampRounds][2];
__device__ __forceinline__ void stamp_round(int g, int which) {
  if (which == 0) __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x < kStampBlocks && g < kStampRounds) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    k1_round_clk[blockIdx.x][g][which] = clock64();
    k1_round_ns[blockIdx.x][g][which] = t;
  }
}
#define K1_STAMP(k) stamp(k)
#define K1_STAMP_ROUNDS(pass, r) stamp_rounds(pass, r)
#define K1_STAMP_ROUND(g, which) stamp_round(g, which)
#define K1_SYNC_FOR_STAMP() __syncthreads()
#else
#define K1_STAMP(k) ((void)0)
#define K1_STAMP_ROUNDS(pass, r) ((void)0)
#define K1_STAMP_ROUND(g, which) ((void)0)
#define K1_SYNC_FOR_STAMP() ((void)0)
#endif

__host__ __device__ inline size_t pad16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Shared-memory layout of one CTA holding H lanes: E = H + 2 * kHalo
// staged lanes, NW = E / 32 words per bit plane. Staged lane e is ring
// lane lo - kHalo + e; the CTA's own lanes are e in [kHalo, kHalo + H),
// bit-plane words [2, 2 + H / 32).
struct Layout {
  int E, NW;
  size_t x, y, z, rng, curv, beats_e, beats_s, blk, nb, tl, tr, alive,
      surf, bounds, cnt, misc, mbar, bytes;
  __host__ __device__ explicit Layout(int H) {
    E = H + 2 * kHalo;
    NW = E / 32;
    size_t o = 0;
    x = o;  // later the staged labels
    o += pad16(4 * E);
    y = o;  // later the staged columns
    o += pad16(4 * E);
    z = o;  // later the voxel keys
    o += pad16(4 * E);
    rng = o;
    o += pad16(4 * E);
    curv = o;
    o += pad16(4 * E);
    beats_e = o;
    o += pad16(4 * E);
    beats_s = o;
    o += pad16(4 * E);
    blk = o;
    o += pad16(E);
    nb = o;
    o += pad16(4 * NW);
    tl = o;
    o += pad16(4 * NW);
    tr = o;
    o += pad16(4 * NW);
    alive = o;  // two parities
    o += pad16(8 * NW);
    surf = o;
    o += pad16(4 * NW);
    bounds = o;
    o += pad16(4 * (kMaxBlocks + 1));
    cnt = o;  // edge and run-end counts per word
    o += pad16(4 * 2 * kMaxWords);
    misc = o;  // round flags[3], totals[2], partner totals[2]
    o += pad16(4 * 8);
    mbar = o;  // two mbarriers for the partner's arrivals
    o += pad16(16);
    bytes = o;
  }
};

// Lanes per CTA (half the ring, rounded up to 32) for a ring of P
// points, and threads per CTA.
__host__ __device__ inline int lanes_per_cta(int P) {
  return ((P + 1) / 2 + 31) / 32 * 32;
}
__host__ __device__ inline int threads_per_cta(int H) {
  const int want = (H + kLanesPerThread - 1) / kLanesPerThread;
  const int t = (want + 31) / 32 * 32;
  return t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t;
}

// Floor division (JAX's //) for a possibly negative numerator; b > 0.
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

__device__ __forceinline__ int wrap(int lane, int P) {
  if (lane >= 0 && lane < P) return lane;
  const int r = lane % P;
  return r < 0 ? r + P : r;
}

__device__ __forceinline__ int voxel_key(float x, float y, float z,
                                         float leaf) {
  const uint32_t cx = static_cast<uint32_t>(
      static_cast<int>(floorf(__fdiv_rn(x, leaf))));
  const uint32_t cy = static_cast<uint32_t>(
      static_cast<int>(floorf(__fdiv_rn(y, leaf))));
  const uint32_t cz = static_cast<uint32_t>(
      static_cast<int>(floorf(__fdiv_rn(z, leaf))));
  return static_cast<int>((cx * 73856093u) ^ (cy * 19349663u) ^
                          (cz * 83492791u));
}

__device__ __forceinline__ bool bit(const uint32_t* words, int e) {
  return (words[e >> 5] >> (e & 31)) & 1u;
}

// Bits of lanes e - p .. e - p + 32 (bit j is lane e - p + j) from the
// two words that hold them.
__device__ __forceinline__ uint64_t span(const uint32_t* words, int e,
                                         int p) {
  const int w = (e - p) >> 5;
  return ((static_cast<uint64_t>(words[w + 1]) << 32) | words[w]) >>
         ((e - p) & 31);
}

// The 2p window bits of lane e out of its span v: bit k is lane
// e - p + k for k < p and lane e - p + k + 1 above (the centre left out).
__device__ __forceinline__ uint32_t window(uint64_t v, int p) {
  const uint32_t low = (1u << p) - 1u;
  return (static_cast<uint32_t>(v) & low) |
         ((static_cast<uint32_t>(v >> (p + 1)) & low) << p);
}

// Inclusive scan over the warp.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The same address in the partner CTA's shared memory.
template <typename T>
__device__ __forceinline__ T* partner_of(T* p) {
  return cg::this_cluster().map_shared_rank(
      p, static_cast<int>(cg::this_cluster().block_rank()) ^ 1);
}

// The ring's pair barrier. Sync point n uses mbarrier n & 1 and waits
// for its phase of parity (n >> 1) & 1: alternating two mbarriers keeps
// each at most one phase ahead of its waiter, which a parity wait needs.
struct Pair {
  uint32_t bar;         // own mbarrier 0 (shared::cta address); 1 is +8
  uint32_t remote_bar;  // the partner's mbarrier 0 (shared::cluster)
  uint32_t n;           // sync points passed
};

// Barrier between the ring's CTAs that also hands over what one CTA's
// threads read of the other's work: after a block barrier, thread 0
// makes the stores `push` into the partner's shared memory, arrives on
// the partner's mbarrier (release, cluster scope) and waits for the
// partner's arrival on its own (acquire); a second block barrier passes
// that on to every thread. barrier.cluster took ~630 ns here (PERF.md).
template <typename Push>
__device__ __forceinline__ void pair_sync(Pair& pr, Push push) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t off = 8u * (pr.n & 1u);
    const uint32_t parity = (pr.n >> 1) & 1u;
    push();
    asm volatile(
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
        ::"r"(pr.remote_bar + off)
        : "memory");
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
          "p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}\n"
          : "=r"(done)
          : "r"(pr.bar + off), "r"(parity)
          : "memory");
    }
  }
  ++pr.n;
  __syncthreads();
}

// A CTA's place in its ring, as the NMS rounds need it.
struct Ring {
  int H, p, T, NW;
  int edge_word;      // own word that the partner needs
  int push_word;      // where it goes in the partner's planes
  uint32_t* p_alive;  // the partner's alive words
  int* p_flags;       // the partner's round flags
  Pair pair;
};

// True for a warp whose slot-k lanes lie in the CTA's H lanes (uniform
// over the warp).
__device__ __forceinline__ bool slot_in(const Ring& rg, int k) {
  return k * rg.T + static_cast<int>(threadIdx.x & ~31u) < rg.H;
}

// Hands the partner the edge word of alive parity q at the next barrier.
__device__ __forceinline__ void push_alive(const Ring& rg,
                                           const uint32_t* alive_w, int q) {
  rg.p_alive[q * rg.NW + rg.push_word] = alive_w[q * rg.NW + rg.edge_word];
}

// One NMS pass (reference _nms_pass) over the CTA's own lanes; see the
// header. Rounds are numbered on from `g` across passes (alive parity
// g & 1, flag slot g % 3). On entry `alive` holds each own lane's alive
// bit, alive words [g & 1] hold the same on both CTAs (visible after a
// pair_sync), and flags[g % 3] is 0. `ever_sel` / `ever_win` collect
// whether a lane was selected or had a selection in its window. Returns
// the round number after the pass, the closing empty round counted.
__device__ int nms_pass(Ring& rg, uint32_t* alive_w, int* flags,
                        const uint32_t* beats_sm,
                        const uint32_t (&beats)[kSlots],
                        const uint32_t (&win)[kSlots], bool (&alive)[kSlots],
                        bool (&ever_sel)[kSlots], bool (&ever_win)[kSlots],
                        int g, int rounds) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = rg.p;
  const uint32_t low = (1u << p) - 1u;
  // The beats of this thread's lane among the 2p next to its warp's word:
  // lane t < p takes lane t of the p before the word, lane p + t lane t
  // of the p after it.
  uint32_t xbeats[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int e = kHalo + k * rg.T + tid;
    xbeats[k] = slot_in(rg, k) && lane < 2 * p
                    ? beats_sm[lane < p ? e - p : e + 32 - p]
                    : 0u;
  }
  for (int r = 0; r < rounds; ++r, ++g) {
    const uint32_t* aw = alive_w + (g & 1) * rg.NW;
    uint32_t* an = alive_w + ((g & 1) ^ 1) * rg.NW;
    const int f = g % 3;
    if (tid == 0) flags[(g + 1) % 3] = 0;  // its readers are done
    bool any = false;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if (!slot_in(rg, k)) continue;
      const int e = kHalo + k * rg.T + tid;
      const int w = e >> 5;
      const bool s = alive[k] && (beats[k] & window(span(aw, e, p), p)) == 0u;
      const uint32_t mid = __ballot_sync(0xffffffffu, s);
      // sel of the 2p lanes next to this warp's word (see xbeats).
      const int ex = lane < p ? e - p : e + 32 - p;
      bool sx = false;
      if (lane < 2 * p && bit(aw, ex)) {
        sx = (xbeats[k] & window(span(aw, ex, p), p)) == 0u;
      }
      const uint32_t xb = __ballot_sync(0xffffffffu, sx);
      const uint32_t left = p > 0 ? (xb & low) << (32 - p) : 0u;
      const uint32_t right = (xb >> p) & low;
      const bool in_left = ((e - p) >> 5) < w;
      const uint64_t sel_span =
          ((in_left ? (static_cast<uint64_t>(mid) << 32) | left
                    : (static_cast<uint64_t>(right) << 32) | mid)) >>
          ((e - p) & 31);
      const bool hit = (win[k] & window(sel_span, p)) != 0u;
      ever_sel[k] |= s;
      ever_win[k] |= hit;
      alive[k] = alive[k] && !s && !hit;
      const uint32_t b = __ballot_sync(0xffffffffu, alive[k]);
      if (lane == 0) an[w] = b;
      any |= s;
    }
    if (__any_sync(0xffffffffu, any) && lane == 0) flags[f] = 1;
    K1_STAMP_ROUND(g, 0);
    pair_sync(rg.pair, [&] {
      push_alive(rg, alive_w, (g & 1) ^ 1);
      if (flags[f]) rg.p_flags[f] = 1;
    });
    K1_STAMP_ROUND(g, 1);
    if (!flags[f]) return g + 1;
  }
  return g;
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kMaxThreads)
k1_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
          const float* __restrict__ zs, const int* __restrict__ count,
          int* __restrict__ labels_out, float* __restrict__ curv_out,
          int* __restrict__ col_out, int P, int H, int vec, Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(H);
  float* sx = reinterpret_cast<float*>(smem + L.x);
  float* sy = reinterpret_cast<float*>(smem + L.y);
  float* sz = reinterpret_cast<float*>(smem + L.z);
  float* rng = reinterpret_cast<float*>(smem + L.rng);
  float* curv = reinterpret_cast<float*>(smem + L.curv);
  uint32_t* beats_e_sm = reinterpret_cast<uint32_t*>(smem + L.beats_e);
  uint32_t* beats_s_sm = reinterpret_cast<uint32_t*>(smem + L.beats_s);
  int8_t* blk = reinterpret_cast<int8_t*>(smem + L.blk);
  uint32_t* nb_w = reinterpret_cast<uint32_t*>(smem + L.nb);
  uint32_t* tl_w = reinterpret_cast<uint32_t*>(smem + L.tl);
  uint32_t* tr_w = reinterpret_cast<uint32_t*>(smem + L.tr);
  uint32_t* alive_w = reinterpret_cast<uint32_t*>(smem + L.alive);
  uint32_t* surf_w = reinterpret_cast<uint32_t*>(smem + L.surf);
  int* bounds = reinterpret_cast<int*>(smem + L.bounds);
  int* cnt_e = reinterpret_cast<int*>(smem + L.cnt);
  int* cnt_r = cnt_e + kMaxWords;
  int* flags = reinterpret_cast<int*>(smem + L.misc);
  int* totals = flags + 3;   // this CTA's edge and run-end counts
  int* ptotals = flags + 5;  // the partner's, pushed by the partner
  int* key = reinterpret_cast<int*>(sz);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int T = blockDim.x;
  const int ring = blockIdx.x >> 1;
  const int rank = blockIdx.x & 1;
  const int p = prm.padding;
  const int B = prm.n_blocks;
  const int lo = rank * H;
  const int hi = min(P, lo + H);
  const int base = lo - kHalo;  // ring lane of staged lane 0
  const int E = L.E;
  const int NW = L.NW;
  const size_t row = static_cast<size_t>(ring) * P;
  const int n = count[ring];
  const bool ring_active = n - 2 * p >= B;
  K1_STAMP(0);

  // 1. Stage x, y, z (16 B per thread where the row is aligned), the block
  // boundaries, zeroed words.
  if (vec) {
    for (int c = tid; c < E / 4; c += T) {
      const int l0 = base + 4 * c;
      if (l0 >= 0 && l0 + 4 <= P) {
        *reinterpret_cast<float4*>(sx + 4 * c) =
            *reinterpret_cast<const float4*>(xs + row + l0);
        *reinterpret_cast<float4*>(sy + 4 * c) =
            *reinterpret_cast<const float4*>(ys + row + l0);
        *reinterpret_cast<float4*>(sz + 4 * c) =
            *reinterpret_cast<const float4*>(zs + row + l0);
      } else {
        for (int j = 0; j < 4; ++j) {
          const size_t g = row + wrap(l0 + j, P);
          sx[4 * c + j] = xs[g];
          sy[4 * c + j] = ys[g];
          sz[4 * c + j] = zs[g];
        }
      }
    }
  } else {
    for (int e = tid; e < E; e += T) {
      const size_t g = row + wrap(base + e, P);
      sx[e] = xs[g];
      sy[e] = ys[g];
      sz[e] = zs[g];
    }
  }
  // Boundary j of the blocks: floor((p*(B-j) + (n-p)*j) / B).
  for (int j = tid; j <= B; j += T) {
    bounds[j] = floordiv(p * (B - j) + (n - p) * j, B);
  }
  for (int w = tid; w < 2 * NW; w += T) alive_w[w] = 0u;
  for (int w = tid; w < NW; w += T) surf_w[w] = 0u;
  if (tid < 8) flags[tid] = 0;
  Ring rgn;
  rgn.H = H;
  rgn.p = p;
  rgn.T = T;
  rgn.NW = NW;
  rgn.edge_word = rank == 0 ? 1 + H / 32 : 2;
  rgn.push_word = rank == 0 ? 1 : 2 + H / 32;
  rgn.p_alive = partner_of(alive_w);
  rgn.p_flags = partner_of(flags);
  rgn.pair = Pair{0u, 0u, 0u};
  rgn.pair.bar =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + L.mbar));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rgn.pair.remote_bar)
               : "r"(rgn.pair.bar), "r"(rank ^ 1));
  if (tid == 0) {
    asm volatile(
        "mbarrier.init.shared::cta.b64 [%0], %2;\n"
        "mbarrier.init.shared::cta.b64 [%1], %2;\n"
        "fence.mbarrier_init.release.cluster;\n" ::"r"(rgn.pair.bar),
        "r"(rgn.pair.bar + 8u), "r"(1)
        : "memory");
  }
  __syncthreads();
  // Both CTAs have started, zeroed their words and set up their mbarrier
  // before either stores into the other's shared memory (from step 4 on):
  // the one barrier.cluster of the kernel, its wait half before step 4.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  K1_STAMP(1);

  // 2. Range, neighbour flag, block id of every staged lane; voxel keys
  // of the own lanes and the one after.
  for (int e = tid; e < E; e += T) {
    const int l = base + e;
    const int lw = wrap(l, P);
    const float xi = sx[e];
    const float yi = sy[e];
    const float r2 = __fsqrt_rn(__fmaf_rn(xi, xi, __fmul_rn(yi, yi)));
    rng[e] = lw < n ? r2 : 0.f;
    bool nbi = false;
    if (e + 1 < E) {
      const float xn = sx[e + 1];
      const float yn = sy[e + 1];
      const float dot = __fmaf_rn(xi, xn, __fmul_rn(yi, yn));
      const float norm =
          __fmul_rn(r2, __fsqrt_rn(__fmaf_rn(xn, xn, __fmul_rn(yn, yn))));
      float cosang = __fdiv_rn(dot, fmaxf(norm, 1e-30f));
      cosang = cosang < -1.f ? -1.f : (cosang > 1.f ? 1.f : cosang);
      nbi = lw < n - 1 && cosang > prm.cos_thr;
    }
    const uint32_t b = __ballot_sync(0xffffffffu, nbi);
    if (lane == 0) nb_w[e >> 5] = b;
    if (e >= kHalo && e <= kHalo + H) {
      key[e] = voxel_key(xi, yi, sz[e], prm.leaf);
    }
    int bk = -2;  // outside the ring: never in a window
    if (l >= 0 && l < P) {
      bk = -1;
      if (ring_active && l < n - p) {
        int a = 0, c = B + 1;  // a = #{j : bounds[j] <= l}
        while (a < c) {
          const int m = (a + c) >> 1;
          if (bounds[m] <= l) {
            a = m + 1;
          } else {
            c = m;
          }
        }
        bk = a - 1 < B ? a - 1 : -1;
      }
    }
    blk[e] = static_cast<int8_t>(bk);
  }
  __syncthreads();

  // 3. Curvature: acc = fma(-2p, r[i], r[i-1]) + r[i+1], then
  // + r[i-k] + r[i+k] for k = 2..p.
  // Occlusion triggers, 0 outside the ring. Left: pair (i-1, i) jumps up;
  // right: pair (i, i+1) jumps down.
  for (int e = tid; e < E; e += T) {
    const int l = base + e;
    const int lw = wrap(l, P);
    float c = 0.f;
    if (e >= p && e + p < E && lw >= p && lw < n - p) {
      const float w = static_cast<float>(-2 * p);
      float acc = p >= 1 ? __fadd_rn(__fmaf_rn(w, rng[e], rng[e - 1]),
                                     rng[e + 1])
                         : __fmul_rn(w, rng[e]);
      for (int k = 2; k <= p; ++k) {
        acc = __fadd_rn(acc, rng[e - k]);
        acc = __fadd_rn(acc, rng[e + k]);
      }
      c = __fmul_rn(acc, acc);
    }
    curv[e] = c;
    const bool inside = l >= 0 && l < P && e >= 1 && e + 1 < E;
    const bool tl = inside && l >= 1 && bit(nb_w, e - 1) &&
                    l - 1 < n - p - 1 &&
                    rng[e] > __fadd_rn(rng[e - 1], prm.dist_thr);
    const bool tr = inside && bit(nb_w, e) && l >= p && l <= n - 2 &&
                    rng[e] > __fadd_rn(rng[e + 1], prm.dist_thr);
    const uint32_t bl = __ballot_sync(0xffffffffu, tl);
    const uint32_t br = __ballot_sync(0xffffffffu, tr);
    if (lane == 0) {
      tl_w[e >> 5] = bl;
      tr_w[e >> 5] = br;
    }
  }
  __syncthreads();
  K1_STAMP(2);

  // 4. Window masks, candidates and occlusion of the own lanes; beats of
  // the p lanes past the split (the halo), which the edge warp's rounds
  // evaluate.

  // Masks of staged lane e over its window: `be` / `bs` are the beats of
  // the edge (max, ties to the right) and surface (min, ties to the left)
  // passes. Returns whether the lane is occluded.
  auto masks = [&](int e, uint32_t& win, uint32_t& be, uint32_t& bs) {
    const float c = curv[e];
    const int b = blk[e];
    const uint64_t nbv = span(nb_w, e, p);  // bit j: pair (e-p+j, +1)
    const uint64_t tlv = span(tl_w, e, p);
    const uint64_t trv = span(tr_w, e, p);
    win = be = bs = 0u;
    bool occl = ((tlv | trv) >> p) & 1u;
    bool cl = true, cr = true;
    for (int d = 1; d <= p; ++d) {
      cl = cl && ((nbv >> (p - d)) & 1u);
      cr = cr && ((nbv >> (p + d - 1)) & 1u);
      occl = occl || (cl && ((tlv >> (p - d)) & 1u)) ||
             (cr && ((trv >> (p + d)) & 1u));
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int dd = s == 0 ? -d : d;
        const int j = e + dd;
        if (!(s == 0 ? cl : cr) || blk[j] != b) continue;
        const uint32_t m = 1u << (s == 0 ? p - d : p + d - 1);
        win |= m;
        const float cj = curv[j];
        if ((cj > c || (cj == c && dd > 0)) && cj > -INFINITY) be |= m;
        const float nj = -cj;
        const float ni = -c;
        if ((nj > ni || (nj == ni && dd < 0)) && nj > -INFINITY) bs |= m;
      }
    }
    return occl;
  };

  uint32_t win[kSlots], beats_e[kSlots], beats_s[kSlots];
  bool own[kSlots], occl[kSlots], cand_s[kSlots];
  bool alive[kSlots], sel_e[kSlots], win_e[kSlots], sel_s[kSlots],
      win_s[kSlots];
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int e = kHalo + k * T + tid;
    own[k] = k * T + tid < H && lo + k * T + tid < hi;
    win[k] = beats_e[k] = beats_s[k] = 0u;
    occl[k] = cand_s[k] = alive[k] = false;
    sel_e[k] = win_e[k] = sel_s[k] = win_s[k] = false;
    if (own[k]) {
      occl[k] = masks(e, win[k], beats_e[k], beats_s[k]);
      beats_e_sm[e] = beats_e[k];
      beats_s_sm[e] = beats_s[k];
      const bool in_blk = blk[e] >= 0;
      alive[k] = in_blk && curv[e] >= prm.edge_thr;
      cand_s[k] = in_blk && curv[e] <= prm.surf_thr;
    }
    if (slot_in(rgn, k)) {
      const uint32_t b = __ballot_sync(0xffffffffu, alive[k]);
      if (lane == 0) alive_w[e >> 5] = b;
    }
  }
  if (tid >= T - 32 && lane < p) {
    const int e = rank == 0 ? kHalo + H + lane : kHalo - p + lane;
    if (rank == 1 || H + lane < P) {
      uint32_t w;
      masks(e, w, beats_e_sm[e], beats_s_sm[e]);
    }
  }
  // Alive words and halo beats visible to both CTAs.
  pair_sync(rgn.pair, [&] { push_alive(rgn, alive_w, 0); });
  K1_STAMP(3);

  // 5. Edge NMS, then surface NMS over the lanes the edge pass left.
  const int g_edge =
      nms_pass(rgn, alive_w, flags, beats_e_sm, beats_e, win, alive, sel_e,
               win_e, 0, prm.nms_rounds);
  K1_STAMP(4);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    alive[k] = cand_s[k] && !sel_e[k] && !win_e[k];
    if (slot_in(rgn, k)) {
      const uint32_t b = __ballot_sync(0xffffffffu, alive[k]);
      if (lane == 0) {
        alive_w[(g_edge & 1) * NW + ((kHalo + k * T + tid) >> 5)] = b;
      }
    }
  }
  pair_sync(rgn.pair, [&] { push_alive(rgn, alive_w, g_edge & 1); });
  const int g_end =
      nms_pass(rgn, alive_w, flags, beats_s_sm, beats_s, win, alive, sel_s,
               win_s, g_edge, prm.nms_rounds);
  K1_STAMP(5);
  K1_STAMP_ROUNDS(0, g_edge);
  K1_STAMP_ROUNDS(1, g_end - g_edge);
  (void)g_end;

  // 6. Masking passes, in the reference's order of overwrites; edge and
  // surface flags of the own lanes.
  int lab[kSlots];
  bool is_edge[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int e = kHalo + k * T + tid;
    const int l = lo + k * T + tid;
    int v = sel_s[k]   ? kSurface
            : win_s[k] ? kSurfaceNeighbor
            : sel_e[k] ? kEdge
            : win_e[k] ? kEdgeNeighbor
                       : kDefault;
    const bool in_ring = l < n;
    if (occl[k] && in_ring && ring_active) v = kOccluded;
    const float r0 = own[k] ? rng[e] : 0.f;
    const bool oor =
        !(r0 >= prm.min_range && r0 <= prm.max_range) && in_ring;
    if (oor && ring_active) v = kOutOfRange;
    if (own[k] && l >= 1 && l < n - 1) {
      const float safe = fmaxf(r0, 1e-30f);
      const float r_prev =
          __fdiv_rn(fabsf(__fsub_rn(rng[e - 1], r0)), safe);
      const float r_next =
          __fdiv_rn(fabsf(__fsub_rn(rng[e + 1], r0)), safe);
      if (r_prev > prm.par_thr && r_next > prm.par_thr && ring_active) {
        v = kParallelBeam;
      }
    }
    if (!(in_ring && ring_active)) v = kDefault;
    lab[k] = v;
    is_edge[k] = own[k] && in_ring && v == kEdge;
    const bool is_surf = own[k] && in_ring && v == kSurface;
    if (slot_in(rgn, k)) {
      const uint32_t bs = __ballot_sync(0xffffffffu, is_surf);
      const uint32_t be = __ballot_sync(0xffffffffu, is_edge[k]);
      if (lane == 0) {
        surf_w[e >> 5] = bs;
        cnt_e[k * (T / 32) + (tid >> 5)] = __popc(be);
      }
    }
  }
  // A: surface words complete; rank 0's last lane needs rank 1's first.
  pair_sync(rgn.pair, [&] {
    if (rank == 1) *partner_of(surf_w + 2 + H / 32) = surf_w[2];
  });

  // Run ends: a surface lane whose next lane is not surface or lies in
  // another voxel.
  bool run_end[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int e = kHalo + k * T + tid;
    const int l = lo + k * T + tid;
    run_end[k] = false;
    if (own[k] && bit(surf_w, e)) {
      const bool next_surf = l + 1 < P && bit(surf_w, e + 1);
      run_end[k] = !next_surf || key[e + 1] != key[e];
    }
    if (slot_in(rgn, k)) {
      const uint32_t b = __ballot_sync(0xffffffffu, run_end[k]);
      if (lane == 0) cnt_r[k * (T / 32) + (tid >> 5)] = __popc(b);
    }
  }
  __syncthreads();
  // Exclusive scans of the per-word counts (H / 32 <= 96 words, three per
  // thread of warp 0), in place; CTA totals to `totals` and the partner.
  if (tid < 32) {
    const int nw = H / 32;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      int* cnt = a == 0 ? cnt_e : cnt_r;
      int v[3];
      int s = 0;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int w = 3 * lane + j;
        v[j] = w < nw ? cnt[w] : 0;
        s += v[j];
      }
      const int incl = warp_scan(s);
      int run = incl - s;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int w = 3 * lane + j;
        if (w < nw) cnt[w] = run;
        run += v[j];
      }
      if (lane == 31) totals[a] = incl;
    }
  }
  // B: counts scanned, totals exchanged. No remote access follows, so
  // either CTA may exit after this.
  pair_sync(rgn.pair, [&] {
    int* pt = partner_of(ptotals);
    pt[0] = totals[0];
    pt[1] = totals[1];
  });
  const int edge_carry = rank == 1 ? ptotals[0] : 0;
  const int run_carry = rank == 1 ? ptotals[1] : 0;
  const int total_runs = totals[1] + ptotals[1];
  K1_STAMP(6);

  // 7. Columns, staged with the labels for the stores.
  int* lab_st = reinterpret_cast<int*>(sx);
  int* col_st = reinterpret_cast<int*>(sy);
  const int denom = max(max(total_runs, 1), prm.cs);
  const uint32_t lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (!slot_in(rgn, k)) continue;
    const int e = kHalo + k * T + tid;
    const int wi = k * (T / 32) + (tid >> 5);
    const uint32_t be = __ballot_sync(0xffffffffu, is_edge[k]);
    const uint32_t br = __ballot_sync(0xffffffffu, run_end[k]);
    const int epos = edge_carry + cnt_e[wi] + __popc(be & lt);
    int c = prm.ce + prm.cs;
    if (is_edge[k] && epos < prm.ce) {
      c = epos;
    } else if (run_end[k]) {
      const int rid = run_carry + cnt_r[wi] + __popc(br & lt);
      const int scol_all = floordiv(rid * prm.cs, denom);
      const int scol_prev = floordiv((rid - 1) * prm.cs, denom);
      if (rid == 0 || scol_all > scol_prev) c = prm.ce + scol_all;
    }
    lab_st[e] = lab[k];
    col_st[e] = c;
  }
  __syncthreads();
  const int own_n = hi - lo;
  if (vec) {
    for (int c = tid; c < own_n / 4; c += T) {
      const size_t g = row + lo + 4 * c;
      const int e = kHalo + 4 * c;
      *reinterpret_cast<int4*>(labels_out + g) =
          *reinterpret_cast<const int4*>(lab_st + e);
      *reinterpret_cast<float4*>(curv_out + g) =
          *reinterpret_cast<const float4*>(curv + e);
      *reinterpret_cast<int4*>(col_out + g) =
          *reinterpret_cast<const int4*>(col_st + e);
    }
  } else {
    for (int i = tid; i < own_n; i += T) {
      const size_t g = row + lo + i;
      labels_out[g] = lab_st[kHalo + i];
      curv_out[g] = curv[kHalo + i];
      col_out[g] = col_st[kHalo + i];
    }
  }
  K1_SYNC_FOR_STAMP();
  K1_STAMP(7);
}

}  // namespace

extern "C" {

int k1_max_padding() { return kMaxPadding; }
int k1_max_points() { return 2 * kSlots * kMaxThreads; }
int k1_max_blocks() { return kMaxBlocks; }
size_t k1_params_bytes() { return sizeof(Params); }
size_t k1_smem_bytes(int P) { return Layout(lanes_per_cta(P)).bytes; }

// Once per device (the current one): lets the kernel use the device's
// opt-in shared memory, and writes that limit to *max_smem. Returns a
// CUDA error code.
int k1_init(int* max_smem) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(k1_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *max_smem);
  }
  return static_cast<int>(err);
}

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches K1 over R rings on `stream`, a cluster of two CTAs per ring.
// labels, curv and col are the three [R, P] planes of `out` (int32,
// float32, int32); `params` points to a Params on the host. Returns
// cudaGetLastError() after the launch (0 on success). Does not
// synchronise.
int k1_label_and_columns(const float* x, const float* y, const float* z,
                         const int* count, void* out, int R, int P,
                         const void* params, void* stream) {
  const int H = lanes_per_cta(P);
  const size_t plane = static_cast<size_t>(R) * P;
  int* labels = static_cast<int*>(out);
  float* curv = reinterpret_cast<float*>(labels + plane);
  int* col = labels + 2 * plane;
  const bool aligned =
      P % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(out)) &
       15u) == 0;
  k1_kernel<<<2 * R, threads_per_cta(H), Layout(H).bytes,
              static_cast<cudaStream_t>(stream)>>>(
      x, y, z, count, labels, curv, col, P, H, aligned ? 1 : 0,
      *static_cast<const Params*>(params));
  return static_cast<int>(cudaGetLastError());
}

#ifdef K1_PHASE_TIMING
const char* k1_phase_names() {
  return "load,range+curvature,masks,edge_nms,surface_nms,labels+scans,"
         "columns+store";
}

// Copies the stamps of the last launch: ns and clk [256][16], rounds
// [256][2]. Returns a CUDA error code.
int k1_phase_read(unsigned long long* ns, long long* clk, int* rounds) {
  cudaError_t err = cudaMemcpyFromSymbol(ns, k1_stamp_ns, sizeof(k1_stamp_ns));
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(clk, k1_stamp_clk, sizeof(k1_stamp_clk));
  }
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(rounds, k1_stamp_rounds,
                               sizeof(k1_stamp_rounds));
  }
  return static_cast<int>(err);
}

// Copies the per-round stamps of the last launch, clk and ns
// [256][32][2].
int k1_round_read(long long* clk, unsigned long long* ns) {
  cudaError_t err =
      cudaMemcpyFromSymbol(clk, k1_round_clk, sizeof(k1_round_clk));
  if (err == cudaSuccess) {
    err = cudaMemcpyFromSymbol(ns, k1_round_ns, sizeof(k1_round_ns));
  }
  return static_cast<int>(err);
}
#endif

}  // extern "C"
