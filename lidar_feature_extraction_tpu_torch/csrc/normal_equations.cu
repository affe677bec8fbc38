// normal_equations: the Gauss-Newton normal equations of float32 problems,
//   D = jv^T j,  A = jw^T j  (7 x 7 each)  and  b = j^T wr  (7),
// summed in exactly the order XLA:CPU sums them in the JAX package's jitted
// weighted_update (lidar_feature_extraction_tpu/ops/gauss_newton.py:142-172;
// ROADMAP §C21), for one problem [M, 7] or a batch [B, M, 7].
//
// It ports no TPU kernel: the reference leaves these products to XLA. A
// library product (torch.matmul, cuBLAS) fixes no summation order, and one
// ulp here moves the next scan's prior, so the port sums in the reference's
// tree, which core/_xla_dot.py describes (its plain version,
// normal_equations_plain, computes the same bits on any device):
//
// - D and A: the rows fall in chunks; a chunk's sum is a fused multiply-add
//   chain from +0 in row order. Unsharded (M <= kShardAbove) the chunk sums
//   are added in order. Sharded, each block's chunks are added in order, and
//   the blocks in groups of four: (b0 + b1) + (b2 + b3) for entries 0..47 of
//   each row-major 7 x 7 output and b0 + ((b1 + b2) + b3) for entry 48, a
//   short group in order, then the groups in order. tree_chunk() gives the
//   chunks, the same rule as _xla_dot.contraction_tree;
// - b: eight lane chains over rows l, l + 8, ..., added (l, l + 4), then
//   (l, l + 2), then (0, 1), plus an FMA chain over the last M mod 8 rows.
//
// One launch: grid (chunks + 1, B). Block c < chunks computes the 98 chains
// of chunk c (one thread per entry of D and A), the last block the 56 lane
// chains and 7 tail chains of b. Each block writes its partial sums to the
// workspace; the block that finishes last for a lane (a ticket from
// atomicAdd on the lane's counter) adds them in the tree's order and writes
// D, A and b. Nothing else is rounded: built with --fmad=false, every add
// __fadd_rn and every chain step __fmaf_rn.
//
// Bound: one read of jv, jw and j ([M, 7] float32 each) and of wr, one
// write of the 105 outputs: on an H100 (3.35 TB/s) about 0.1 us per 10,240
// rows; the work is 105 FMA per row (15 MFLOP/s-scale at these sizes). The
// chains are serial by design (their order is the point), so the kernel is
// latency-bound: the longest chain is a b lane of M / 8 steps.
//
// Built with normal_equations_op.cpp into one library by
// ops/normal_equations_cuda.py::build (nvcc, sm_90a, --fmad=false) into
// build/kernels/ at first use, and called through the operator
// lidar_port::normal_equations.

#include <cuda_runtime.h>

namespace {

constexpr int kSingleKc = 608;
constexpr int kThreadedKc = 320;
constexpr int kDnnlKBlock = 384;
constexpr int kShardAbove = 7990;
constexpr int kEightAbove = 8197;
constexpr int kThreads = 8;      // XLA_CPU_THREADS
constexpr int kGroup = 4;
constexpr int kPacketEntries = 48;
constexpr int kEntries = 98;     // D and A, 49 each
constexpr int kLanes = 8;
constexpr int kOut = 2 * 49 + 7;

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int single_kc(int k) {
  if (k <= kSingleKc) return k;
  if (k % kSingleKc == 0) return kSingleKc;
  return kSingleKc - 8 * ((kSingleKc - 1 - k % kSingleKc) /
                          (8 * (k / kSingleKc + 1)));
}

// TensorFlow's contraction kernel: k rows in slices of bk (a multiple of 8).
__host__ __device__ inline int slice_rows(int k, int kc) {
  int n = ceil_div(k, kc);
  if (n < 1) n = 1;
  int bk = ceil_div(k / n, 8) * 8;
  return bk < k ? bk : k;
}

// Walks the chunks of an M-row contraction in order. For chunk `want`
// (or, with want < 0, none) sets lo, hi and the block; returns the number
// of chunks and sets *blocks.
__host__ __device__ inline int tree_chunk(int m, int want, int* lo, int* hi,
                                          int* block, int* blocks) {
  int c = 0;
  if (m <= kShardAbove) {
    *blocks = 1;
    const int bk = slice_rows(m, single_kc(m));
    for (int s0 = 0; s0 < m; s0 += bk) {
      const int s1 = s0 + bk < m ? s0 + bk : m;
      const int parts = s1 - s0 > kDnnlKBlock ? 2 : 1;
      const int mid = s0 + ceil_div(s1 - s0, 2);
      for (int p = 0; p < parts; ++p, ++c) {
        if (c == want) {
          *lo = parts == 1 ? s0 : (p == 0 ? s0 : mid);
          *hi = parts == 1 ? s1 : (p == 0 ? mid : s1);
          *block = 0;
        }
      }
    }
    return c;
  }
  const int threads = m <= kEightAbove ? 6 : kThreads;
  int bs = ceil_div(ceil_div(m, threads), 8) * 8;
  if (bs < 96) bs = 96;
  int blk = 0;
  for (int b0 = 0; b0 < m; b0 += bs, ++blk) {
    const int size = m - b0 < bs ? m - b0 : bs;
    const int bk = slice_rows(size, size > kThreadedKc ? kThreadedKc : size);
    for (int s0 = 0; s0 < size; s0 += bk, ++c) {
      if (c == want) {
        *lo = b0 + s0;
        *hi = b0 + (s0 + bk < size ? s0 + bk : size);
        *block = blk;
      }
    }
  }
  *blocks = blk;
  return c;
}

struct Operands {
  const float* jv;
  const float* jw;
  const float* j;
  const float* wr;
  // strides in elements: [batch, row, column] (wr: [batch, row])
  long long sjv[3], sjw[3], sj[3], swr[2];
};

__device__ inline float lhs(const Operands& op, int b, int k, int i) {
  return i < 7 ? op.jv[b * op.sjv[0] + k * op.sjv[1] + i * op.sjv[2]]
               : op.jw[b * op.sjw[0] + k * op.sjw[1] + (i - 7) * op.sjw[2]];
}

__device__ inline float jac(const Operands& op, int b, int k, int c) {
  return op.j[b * op.sj[0] + k * op.sj[1] + c * op.sj[2]];
}

// a + b + c + ... of the block's chunk partials, in order.
__device__ inline float block_sum(const float* part, int first, int count) {
  float r = __ldcg(part + first * kEntries);
  for (int c = 1; c < count; ++c)
    r = __fadd_rn(r, __ldcg(part + (first + c) * kEntries));
  return r;
}

// Entry t's total from its chunk partials part[c * kEntries] (c in tree
// order): each block's chunks in order, then the blocks in groups of four
// (`packet`: (b0 + b1) + (b2 + b3), else b0 + ((b1 + b2) + b3)), a short
// group in order, then the groups in order. The walk is tree_chunk's.
__device__ inline float fold_entry(const float* part, int m, bool packet) {
  if (m <= kShardAbove) {
    int lo, hi, block, blocks;
    return block_sum(part, 0, tree_chunk(m, -1, &lo, &hi, &block, &blocks));
  }
  const int threads = m <= kEightAbove ? 6 : kThreads;
  int bs = ceil_div(ceil_div(m, threads), 8) * 8;
  if (bs < 96) bs = 96;
  float sums[kThreads];
  int blocks = 0, c = 0;
  for (int b0 = 0; b0 < m; b0 += bs) {
    const int size = m - b0 < bs ? m - b0 : bs;
    const int count = ceil_div(
        size, slice_rows(size, size > kThreadedKc ? kThreadedKc : size));
    sums[blocks++] = block_sum(part, c, count);
    c += count;
  }
  float total = 0.0f;
  for (int g = 0; g < blocks; g += kGroup) {
    const float* s = sums + g;
    float group;
    if (blocks - g < kGroup) {
      group = s[0];
      for (int k = 1; k < blocks - g; ++k) group = __fadd_rn(group, s[k]);
    } else if (packet) {
      group = __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
    } else {
      group = __fadd_rn(s[0], __fadd_rn(__fadd_rn(s[1], s[2]), s[3]));
    }
    total = g == 0 ? group : __fadd_rn(total, group);
  }
  return total;
}

__global__ void normal_equations_kernel(Operands op, int m, int chunks,
                                        float* __restrict__ work,
                                        unsigned* __restrict__ tickets,
                                        float* __restrict__ out) {
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  float* lane_work = work + static_cast<long long>(b) *
                                (chunks * kEntries + kLanes * 7 + 7);
  if (c < chunks) {
    if (t < kEntries) {
      int lo, hi, block, blocks;
      tree_chunk(m, c, &lo, &hi, &block, &blocks);
      const int i = t / 7, col = t % 7;
      float acc = 0.0f;
      for (int k = lo; k < hi; ++k)
        acc = __fmaf_rn(lhs(op, b, k, i), jac(op, b, k, col), acc);
      lane_work[c * kEntries + t] = acc;
    }
  } else if (t < kLanes * 7 + 7) {
    // b's chains: lane l of row r over rows l, l + 8, ...; then the tail.
    const int k8 = (m / 8) * 8;
    const int r = t % 7;
    const bool tail = t >= kLanes * 7;
    const int k0 = tail ? k8 : t / 7, step = tail ? 1 : kLanes;
    const int k1 = tail ? m : k8;
    float acc = 0.0f;
    for (int k = k0; k < k1; k += step)
      acc = __fmaf_rn(jac(op, b, k, r),
                      op.wr[b * op.swr[0] + k * op.swr[1]], acc);
    lane_work[chunks * kEntries + t] = acc;
  }
  // Every thread's partial sums visible device-wide before the ticket.
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (t == 0) last = atomicAdd(tickets + b, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* o = out + static_cast<long long>(b) * kOut;
  if (t < kEntries) {
    o[t] = fold_entry(lane_work + t, m, t % 49 < kPacketEntries);
  } else if (t < kEntries + 7) {
    const int r = t - kEntries;
    const float* lanes = lane_work + chunks * kEntries;
    float s4[4];
    for (int l = 0; l < 4; ++l)
      s4[l] = __fadd_rn(__ldcg(lanes + l * 7 + r),
                        __ldcg(lanes + (l + 4) * 7 + r));
    const float s1 =
        __fadd_rn(__fadd_rn(s4[0], s4[2]), __fadd_rn(s4[1], s4[3]));
    o[kEntries + r] = __fadd_rn(s1, __ldcg(lanes + kLanes * 7 + r));
  }
}

}  // namespace

extern "C" {

const char* normal_equations_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The number of chunks of an M-row contraction, and its blocks.
int normal_equations_chunks(int m, int* blocks) {
  int lo, hi, block;
  return tree_chunk(m, -1, &lo, &hi, &block, blocks);
}

// Chunk c's rows [lo, hi) and its block.
void normal_equations_chunk(int m, int c, int* lo, int* hi, int* block) {
  int blocks;
  tree_chunk(m, c, lo, hi, block, &blocks);
}

// D, A (row-major 7 x 7) and b of B problems into out [B, 105]; work holds
// B * (chunks * 98 + 63) floats, tickets B zeros. Strides in elements.
// Returns a cudaError_t (0 on success).
int normal_equations_f32(const float* jv, const float* jw, const float* j,
                         const float* wr, const long long* sjv,
                         const long long* sjw, const long long* sj,
                         const long long* swr, int batch, int m, float* work,
                         unsigned* tickets, float* out, void* stream) {
  if (batch == 0) return cudaSuccess;
  if (m < 1 || batch < 0 || batch > 65535) return cudaErrorInvalidValue;
  int blocks;
  const int chunks = normal_equations_chunks(m, &blocks);
  if (blocks > kThreads) return cudaErrorInvalidValue;
  Operands op{jv, jw, j, wr, {}, {}, {}, {}};
  for (int d = 0; d < 3; ++d) {
    op.sjv[d] = sjv[d];
    op.sjw[d] = sjw[d];
    op.sj[d] = sj[d];
  }
  op.swr[0] = swr[0];
  op.swr[1] = swr[1];
  const dim3 grid(chunks + 1, batch);
  normal_equations_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      op, m, chunks, work, tickets, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
