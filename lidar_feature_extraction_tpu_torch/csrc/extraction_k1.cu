// K1: fused LOAM labeling + compaction columns, one thread block per ring.
//
// Replaces the Pallas kernel lidar_feature_extraction_tpu/ops/
// extraction_pallas.py::label_and_columns_pallas (its body _kernel runs
// label_planes + _voxel_run_key_planes + compact_columns of
// ops/extraction.py). The plain PyTorch version of the same function is
// lidar_feature_extraction_tpu_torch/ops/extraction.py::
// label_and_columns_plain; labels and col must be bit-equal to it.
//
// Per ring: XY range -> curvature convolution -> cosine neighbour flags ->
// gap prefix (block scan) -> block ids from count -> edge NMS, then surface
// NMS (multi-select rounds, early exit, capped at nms_rounds) ->
// occlusion / out-of-range / parallel-beam overwrites -> voxel-run key ->
// compaction columns (edge rank capped at ce, stratified surface run ends,
// dump column ce+cs). The point mask is lane < count.
//
// What bounds it on the H100: not bytes (it reads 3 and writes 3 [R, P]
// planes, about 3.5 MB at 64x2304), but shared memory per ring and the
// serial NMS rounds, each a pair of block-wide passes separated by
// barriers. The design keeps every plane of one ring in shared memory
// (5 word planes + 7 byte planes, about 61 KB at P = 2304, as dynamic
// shared memory), so a round touches no device memory, and ends a pass
// as soon as one round selects nothing (__syncthreads_or). Rings are
// independent blocks: a ring stops at its own fixpoint, which gives the
// reference's labels because a round that selects nothing is a fixpoint
// and the round cap is the same for every ring.
//
// Exactness: the float expressions that decide labels use explicit
// round-to-nearest intrinsics (no FMA contraction) in the reference's
// order of operations; thresholds arrive as float, rounded the way JAX
// rounds a Python float against a float32 array; the voxel hash
// multiplies in uint32 (wrap-around, as the reference's int32); integer
// divisions that can see a negative operand floor like JAX's //.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum : uint8_t {
  kDefault = 0,
  kEdge = 1,
  kEdgeNeighbor = 2,
  kSurface = 3,
  kSurfaceNeighbor = 4,
  kOutOfRange = 5,
  kOccluded = 6,
  kParallelBeam = 7,
};

constexpr uint8_t kCandEdge = 1;
constexpr uint8_t kCandSurface = 2;

struct Params {
  int P, padding, n_blocks, nms_rounds, ce, cs;
  float cos_thr, edge_thr, surf_thr, dist_thr, min_range, max_range,
      par_thr, leaf;
};

// The ring's planes in dynamic shared memory.
struct Planes {
  int* warp_tot;    // [kWarps] block-scan scratch
  float* rng;       // XY range, 0 outside the ring
  float* curv;      // curvature
  int* g;           // gap prefix; reused for the edge columns
  int* key;         // voxel-run key
  int* scan;        // block-scan output
  uint8_t* labels;
  int8_t* blk;      // block id or -1
  uint8_t* cand;    // kCandEdge | kCandSurface threshold candidates
  uint8_t* sel;     // NMS selections of the current round
  uint8_t* nb;      // neighbour flag of the pair (i, i+1)
  uint8_t* tl_src;  // left occlusion trigger, before its shift by one
  uint8_t* trig_r;  // right occlusion trigger
};

__host__ __device__ size_t smem_bytes(int P) {
  return sizeof(int) * kWarps + 5 * sizeof(int) * (size_t)P + 7 * (size_t)P;
}

__device__ Planes carve(unsigned char* base, int P) {
  Planes s;
  s.warp_tot = reinterpret_cast<int*>(base);
  float* w = reinterpret_cast<float*>(base + sizeof(int) * kWarps);
  s.rng = w;
  s.curv = w + P;
  s.g = reinterpret_cast<int*>(w + 2 * P);
  s.key = reinterpret_cast<int*>(w + 3 * P);
  s.scan = reinterpret_cast<int*>(w + 4 * P);
  uint8_t* b = reinterpret_cast<uint8_t*>(w + 5 * P);
  s.labels = b;
  s.blk = reinterpret_cast<int8_t*>(b + P);
  s.cand = b + 2 * P;
  s.sel = b + 3 * P;
  s.nb = b + 4 * P;
  s.tl_src = b + 5 * P;
  s.trig_r = b + 6 * P;
  return s;
}

// Floor division (JAX's //) for a possibly negative numerator; b > 0.
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && (a < 0) != (b < 0)) ? q - 1 : q;
}

// Block index of lane i (reference block_ids): boundary j is
// floor((p*(B-j) + (n-p)*j) / B), and rings with n - 2p < B have none.
__device__ int block_id(int i, int n, int p, int B) {
  int blk = -1;
  for (int j = 0; j <= B; ++j) {
    blk += i >= floordiv(p * (B - j) + (n - p) * j, B);
  }
  const bool active = n - 2 * p >= B;
  const bool in_blocks = blk >= 0 && blk < B && i < n - p;
  return active && in_blocks ? blk : -1;
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

// Block-wide scan of flag(i) over lanes [0, P) into out. Each thread
// scans a contiguous chunk; the chunk totals are scanned across warps.
// Returns the total. Ends with a barrier, so out is complete and
// warp_tot is free for the next scan.
template <bool kExclusive, typename Flag>
__device__ int block_scan(Flag flag, int* out, int P, int* warp_tot) {
  const int chunk = (P + kThreads - 1) / kThreads;
  const int beg = min(static_cast<int>(threadIdx.x) * chunk, P);
  const int end = min(beg + chunk, P);
  int local = 0;
  for (int i = beg; i < end; ++i) local += flag(i);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  int run = incl - local + (warp > 0 ? warp_tot[warp - 1] : 0);
  const int total = warp_tot[kWarps - 1];
  for (int i = beg; i < end; ++i) {
    const int f = flag(i);
    if (kExclusive) {
      out[i] = run;
      run += f;
    } else {
      run += f;
      out[i] = run;
    }
  }
  __syncthreads();
  return total;
}

// One NMS pass (reference _nms_pass). Phase 1 of a round reads the
// neighbours' labels and writes sel; phase 2 writes the labels of the
// selections and their windows. A lane j is in the window of lane i when
// |j - i| <= p, j lies in the ring's lanes, and both share gap segment
// and block.
__device__ void nms_pass(const Planes& s, int P, int p, int rounds,
                         bool pick_max, uint8_t cand_bit, uint8_t point_code,
                         uint8_t neighbor_code) {
  for (int it = 0; it < rounds; ++it) {
    int any = 0;
    for (int i = threadIdx.x; i < P; i += kThreads) {
      bool selected = false;
      if ((s.cand[i] & cand_bit) && s.labels[i] == kDefault) {
        const float si = pick_max ? s.curv[i] : -s.curv[i];
        const int gi = s.g[i];
        const int bi = s.blk[i];
        bool blocked = false;
        for (int d = 1; d <= p && !blocked; ++d) {
          for (int sgn = -1; sgn <= 1; sgn += 2) {
            const int dd = sgn * d;
            const int j = i + dd;
            if (j < 0 || j >= P || s.g[j] != gi || s.blk[j] != bi) continue;
            if (!((s.cand[j] & cand_bit) && s.labels[j] == kDefault)) continue;
            const float sj = pick_max ? s.curv[j] : -s.curv[j];
            const bool tie_win = pick_max ? dd > 0 : dd < 0;
            if ((sj > si || (sj == si && tie_win)) && sj > -INFINITY) {
              blocked = true;
            }
          }
        }
        selected = !blocked;
      }
      s.sel[i] = selected;
      any |= selected;
    }
    if (!__syncthreads_or(any)) break;

    for (int i = threadIdx.x; i < P; i += kThreads) {
      if (s.sel[i]) {
        s.labels[i] = point_code;
        continue;
      }
      const int gi = s.g[i];
      const int bi = s.blk[i];
      bool win = false;
      for (int dd = -p; dd <= p && !win; ++dd) {
        const int j = i + dd;
        win = dd != 0 && j >= 0 && j < P && s.sel[j] && s.g[j] == gi &&
              s.blk[j] == bi;
      }
      if (win) s.labels[i] = neighbor_code;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
k1_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
          const float* __restrict__ zs, const int* __restrict__ count,
          int* __restrict__ labels_out, float* __restrict__ curv_out,
          int* __restrict__ col_out, Params prm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = prm.P;
  const int p = prm.padding;
  const int B = prm.n_blocks;
  const Planes s = carve(smem_raw, P);
  const size_t row = static_cast<size_t>(blockIdx.x) * P;
  const float* x = xs + row;
  const float* y = ys + row;
  const float* z = zs + row;
  const int n = count[blockIdx.x];
  const bool ring_active = n - 2 * p >= B;

  // Range, neighbour flags, voxel keys, block ids.
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const float xi = x[i];
    const float yi = y[i];
    s.rng[i] = i < n ? __fsqrt_rn(__fadd_rn(__fmul_rn(xi, xi),
                                            __fmul_rn(yi, yi)))
                     : 0.f;
    const int j = i + 1 < P ? i + 1 : 0;  // the reference's roll wraps
    const float xn = x[j];
    const float yn = y[j];
    const float dot = __fadd_rn(__fmul_rn(xi, xn), __fmul_rn(yi, yn));
    const float norm = __fmul_rn(
        __fsqrt_rn(__fadd_rn(__fmul_rn(xi, xi), __fmul_rn(yi, yi))),
        __fsqrt_rn(__fadd_rn(__fmul_rn(xn, xn), __fmul_rn(yn, yn))));
    float cosang = __fdiv_rn(dot, fmaxf(norm, 1e-30f));
    cosang = cosang < -1.f ? -1.f : (cosang > 1.f ? 1.f : cosang);
    s.nb[i] = i < n - 1 && cosang > prm.cos_thr;
    s.key[i] = voxel_key(xi, yi, z[i], prm.leaf);
    s.blk[i] = static_cast<int8_t>(block_id(i, n, p, B));
    s.labels[i] = kDefault;
  }
  __syncthreads();

  // Curvature: acc = -2p r[i], then + r[i-k] + r[i+k] for k = 1..p.
  for (int i = threadIdx.x; i < P; i += kThreads) {
    float c = 0.f;
    if (i >= p && i < n - p) {
      float acc = __fmul_rn(static_cast<float>(-2 * p), s.rng[i]);
      for (int k = 1; k <= p; ++k) {
        acc = __fadd_rn(acc, s.rng[i - k]);
        acc = __fadd_rn(acc, s.rng[i + k]);
      }
      c = __fmul_rn(acc, acc);
    }
    s.curv[i] = c;
    curv_out[row + i] = c;
    const bool in_blk = s.blk[i] >= 0;
    s.cand[i] = (in_blk && c >= prm.edge_thr ? kCandEdge : 0) |
                (in_blk && c <= prm.surf_thr ? kCandSurface : 0);
  }
  // Gap prefix: number of non-neighbour pairs strictly before lane i.
  block_scan<true>([&](int i) { return s.nb[i] ? 0 : 1; }, s.g, P,
                   s.warp_tot);

  nms_pass(s, P, p, prm.nms_rounds, true, kCandEdge, kEdge, kEdgeNeighbor);
  nms_pass(s, P, p, prm.nms_rounds, false, kCandSurface, kSurface,
           kSurfaceNeighbor);

  // Occlusion triggers. Left: pair (i, i+1) jumps up, marks from i+1 on.
  // Right: pair (i, i+1) jumps down, marks from i back.
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const bool nbi = s.nb[i];  // implies i + 1 < n <= P
    s.tl_src[i] = nbi && i < n - p - 1 &&
                  s.rng[i + 1] > __fadd_rn(s.rng[i], prm.dist_thr);
    s.trig_r[i] = nbi && i >= p && i <= n - 2 &&
                  s.rng[i] > __fadd_rn(s.rng[i + 1], prm.dist_thr);
  }
  __syncthreads();

  // Masking passes, in the reference's order of overwrites.
  auto trig_l = [&](int j) { return j >= 1 && s.tl_src[j - 1]; };
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int gi = s.g[i];
    bool occl = trig_l(i) || s.trig_r[i];
    for (int ds = 1; ds <= p; ++ds) {
      occl = occl || (i >= ds && trig_l(i - ds) && s.g[i - ds] == gi);
      occl = occl || (i + ds < P && s.trig_r[i + ds] && s.g[i + ds] == gi);
    }
    const bool in_ring = i < n;
    uint8_t lab = s.labels[i];
    if (occl && in_ring && ring_active) lab = kOccluded;

    const float rg = s.rng[i];
    const bool oor = !(rg >= prm.min_range && rg <= prm.max_range) && in_ring;
    if (oor && ring_active) lab = kOutOfRange;

    if (i >= 1 && i < n - 1) {
      const float safe = fmaxf(rg, 1e-30f);
      const float r_prev = __fdiv_rn(fabsf(__fsub_rn(s.rng[i - 1], rg)), safe);
      const float r_next = __fdiv_rn(fabsf(__fsub_rn(s.rng[i + 1], rg)), safe);
      if (r_prev > prm.par_thr && r_next > prm.par_thr && ring_active) {
        lab = kParallelBeam;
      }
    }
    if (!(in_ring && ring_active)) lab = kDefault;
    labels_out[row + i] = lab;
    // Written after every read of labels in this pass: lane i reads only
    // its own label here.
    s.labels[i] = lab;
  }
  __syncthreads();

  // Compaction columns. Edge rank first; its column goes to the g plane,
  // which nothing reads any more.
  auto is_edge = [&](int i) { return i < n && s.labels[i] == kEdge; };
  auto is_surf = [&](int i) { return i < n && s.labels[i] == kSurface; };
  auto run_end = [&](int i) {
    if (!is_surf(i)) return false;
    if (i + 1 >= P || !is_surf(i + 1)) return true;
    return s.key[i + 1] != s.key[i];
  };
  block_scan<false>([&](int i) { return is_edge(i) ? 1 : 0; }, s.scan, P,
                    s.warp_tot);
  for (int i = threadIdx.x; i < P; i += kThreads) {
    const int epos = s.scan[i] - 1;
    s.g[i] = is_edge(i) && epos < prm.ce ? epos : -1;
  }
  // The run-id scan's first barrier orders these writes before the reads
  // below; its own writes go to the scan plane after that barrier.
  const int total_runs = block_scan<false>(
      [&](int i) { return run_end(i) ? 1 : 0; }, s.scan, P, s.warp_tot);
  const int denom = max(max(total_runs, 1), prm.cs);
  for (int i = threadIdx.x; i < P; i += kThreads) {
    int c = s.g[i];
    if (c < 0) {
      const int rid = s.scan[i] - 1;
      const int scol_all = floordiv(rid * prm.cs, denom);
      const int scol_prev = floordiv((rid - 1) * prm.cs, denom);
      const bool first_on_col = rid == 0 || scol_all > scol_prev;
      c = run_end(i) && first_on_col ? prm.ce + scol_all : prm.ce + prm.cs;
    }
    col_out[row + i] = c;
  }
}

}  // namespace

extern "C" {

size_t k1_smem_bytes(int P) { return smem_bytes(P); }

int k1_max_smem_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches K1 over R rings on `stream`; returns cudaGetLastError() after
// the launch (0 on success). Does not synchronise.
int k1_label_and_columns(const float* x, const float* y, const float* z,
                         const int* count, int* labels, float* curv,
                         int* col, int R, int P, int padding, int n_blocks,
                         int nms_rounds, float cos_thr, float edge_thr,
                         float surf_thr, float dist_thr, float min_range,
                         float max_range, float par_thr, float leaf, int ce,
                         int cs, void* stream) {
  Params prm;
  prm.P = P;
  prm.padding = padding;
  prm.n_blocks = n_blocks;
  prm.nms_rounds = nms_rounds;
  prm.ce = ce;
  prm.cs = cs;
  prm.cos_thr = cos_thr;
  prm.edge_thr = edge_thr;
  prm.surf_thr = surf_thr;
  prm.dist_thr = dist_thr;
  prm.min_range = min_range;
  prm.max_range = max_range;
  prm.par_thr = par_thr;
  prm.leaf = leaf;
  const size_t smem = smem_bytes(P);
  cudaError_t err = cudaFuncSetAttribute(
      k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_kernel<<<R, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, z, count, labels, curv, col, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
