// normal_equations: the Gauss-Newton normal equations of float32 problems,
//   D = jv^T j,  A = jw^T j  (7 x 7 each)  and  b = j^T wr  (7),
// summed in exactly the order XLA:CPU sums them in the JAX package's jitted
// weighted_update (lidar_feature_extraction_tpu/ops/gauss_newton.py:142-172;
// ROADMAP §C21, §C22), for one problem [M, 7] or a batch [B, M, 7].
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
// - b from kTiledFrom rows (XLA's tiled matrix-vector loop): eight lane
//   chains over rows l, l + 8, ..., added (l, l + 4), then (l, l + 2), then
//   (0, 1), plus an FMA chain from +0 over the last M mod 8 rows;
// - b below kTiledFrom rows (the loop fusion LLVM vectorizes, _xla_dot.
//   gemv_loop): one row is one rounded product; up to kSerialMax rows one
//   FMA chain from +0; above, a vector loop of `width` rows a trip (16 up to
//   kInterleave2Max rows, else 32) over (M - 1) / width trips, lane q an FMA
//   chain over rows q, q + width, ... (lane 0 from +0, the others from -0),
//   the registers of 8 lanes added in order and the 8 lanes as a tree; up to
//   kFullUnroll trips one 8-lane chain instead, over register 0's trips,
//   then each other register's with its first two trips swapped; then an
//   epilogue of 2, 4 or 8 lanes from that sum (in lane 0, -0 in the others),
//   reduced the same way, and one FMA chain from it over the rows left.
//
// One launch of (chunks + 1) x B blocks of 384 threads: every lane's
// chunks, then one block per lane for b.
//
// - A chunk block copies its rows of jv, jw and j (at most kChunkRows, 32
//   KB) into shared memory column by column with 4-byte cp.async (any
//   strides), waits once, and 98 threads run the entries' chains from
//   there, four steps' operands in one 16-byte load.
// - The b block streams j's rows and wr through a ring of kStages stages of
//   kStageRows rows, row-major as in global memory. For row-major operands
//   on 16-byte boundaries (the main path) one thread fills a stage with a
//   cp.async.bulk per operand (the copy engine; the trap: a 2D tensor map
//   cannot describe [M, 7] rows 28 bytes apart, and a bulk copy needs
//   16-byte multiples, so the last floats of a range it copies itself);
//   other layouts are copied float by float through the strides by the
//   block's loader warps. Each stage has a `full` mbarrier (the loaders'
//   arrivals and the bulk bytes) and an `empty` one (the chain threads'
//   arrivals), so no block-wide barrier stops the chains. A chain thread
//   waits on `full`, runs its lane's steps of the stage from shared memory
//   (unrolled: every load is issued ahead of its FMA), arrives on `empty`,
//   and goes on; the next fill of that slot waits on `empty`.
// - The chunk block that finishes last for a lane (a ticket from atomicAdd
//   on the lane's counter) adds the chunks in the tree's order and writes
//   D and A, while the b block still runs; the b block writes b. Nothing
//   else is rounded: built with --fmad=false, every add __fadd_rn and
//   every chain step __fmaf_rn.
//
// Bound: one read of jv, jw and j ([M, 7] float32 each) and of wr, one
// write of the 105 outputs: on an H100 (3.35 TB/s) about 0.27 us at 10,240
// rows. The chains are serial by design (their order is the point), so the
// kernel is latency-bound: from kTiledFrom rows the longest chain is a b
// lane of M / 8 dependent FMAs (about 3.6 us at 14,336 rows and 1.98 GHz
// at 4 cycles a step); each step of it also waits on two shared-memory
// loads, whose issue sets the pace (about 9 cycles a step).
//
// Built with normal_equations_op.cpp into one library by
// ops/normal_equations_cuda.py::build (nvcc, sm_90a, --fmad=false) into
// build/kernels/ at first use, and called through the operator
// lidar_port::normal_equations.

#include <cuda_runtime.h>

#include <cstdint>

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
constexpr int kOut = 2 * 49 + 7;

// b's loops (_xla_dot.GEMV_*).
constexpr int kTiledFrom = 4096;
constexpr int kSerialMax = 49;
constexpr int kInterleave2Max = 64;
constexpr int kFullUnroll = 10;

constexpr int kBlock = 384;      // threads
constexpr int kChunkRows = 384;  // the largest chunk of the tree
constexpr int kStageRows = 1024;  // a multiple of every lane count of b
constexpr int kStages = 3;
// A chunk staged column by column (jv's 7, jw's 7 and j's 7 columns),
// each column a run of kChunkRun floats: 388 / 4 is odd, so eight threads'
// 16-byte loads from eight columns fall in distinct banks.
constexpr int kChunkRun = kChunkRows + 4;
constexpr int kChunkFloats = 21 * kChunkRun;
constexpr int kMaxLanes = 32;    // b's widest vector loop
constexpr int kStageSlot = kStageRows * 8;  // j's rows and wr's
constexpr int kSmemFloats = kStages * kStageSlot > kChunkFloats
                                ? kStages * kStageSlot
                                : kChunkFloats;
constexpr int kSmemBytes = kSmemFloats * 4;

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

// b's loop for M rows (_xla_dot.gemv_loop): lanes chains of the main loop
// (8 for the tiled loop, width for the rolled vector loop, 8 unrolled, 7
// columns' one chain for the scalar loops), the rows they cover, and the
// epilogue.
struct Gemv {
  int mode;       // 0 tiled, 1 one product, 2 scalar chain, 3 rolled, 4 unrolled
  int width;      // rows a trip of the vector loop (mode 3, 4)
  int trips;
  int main_rows;  // rows of the lane chains (tiled: M - M mod 8)
  int epilogue;   // lanes of the epilogue loop, 0 if none
  int etrips;
};

__host__ __device__ inline Gemv gemv_loop(int m) {
  Gemv g{0, 0, 0, 0, 0, 0};
  if (m >= kTiledFrom) {
    g.mode = 0;
    g.main_rows = (m / 8) * 8;
    return g;
  }
  if (m == 1) {
    g.mode = 1;
    return g;
  }
  if (m <= kSerialMax) {
    g.mode = 2;
    return g;
  }
  g.width = 8 * (m <= kInterleave2Max ? 2 : 4);
  g.trips = (m - 1) / g.width;  // one row is always left to the scalar loop
  g.mode = g.trips <= kFullUnroll ? 4 : 3;
  g.main_rows = g.trips * g.width;
  const int rem = m % g.width;
  if (rem < 2) {
    g.epilogue = 0;
  } else if (rem < 4 || rem == 6 || rem == 7) {
    g.epilogue = 2;
  } else {
    g.epilogue = rem >= 8 && rem % 8 < 4 ? 8 : 4;
  }
  g.etrips = g.epilogue ? (m - 1 - g.main_rows) / g.epilogue : 0;
  return g;
}

struct Operands {
  const float* jv;
  const float* jw;
  const float* j;
  const float* wr;
  // strides in elements: [batch, row, column] (wr: [batch, row])
  long long sjv[3], sjw[3], sj[3], swr[2];
};

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(s)),
               "l"(g)
               : "memory");
}

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives on `bar` and adds `bytes` to the bytes its phase waits for.
__device__ inline void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory; its bytes complete on `bar`.
__device__ inline void bulk_copy(float* s, const float* g, unsigned bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s)),
      "l"(g), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// acc = fma(x[i], y[i], acc) for i = 0, 1, ..., n - 1, in order, from
// shared memory (x and y 16-byte aligned). Four steps' operands come in one
// 16-byte load each, sixteen steps' at a time, so a step costs about the
// FMA's latency and not a load's.
__device__ inline float fma_run(const float* x, const float* y, int n,
                                float acc) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    float4 a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = x4[i / 4 + u];
      b[u] = y4[i / 4 + u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc = __fmaf_rn(a[u].x, b[u].x, acc);
      acc = __fmaf_rn(a[u].y, b[u].y, acc);
      acc = __fmaf_rn(a[u].z, b[u].z, acc);
      acc = __fmaf_rn(a[u].w, b[u].w, acc);
    }
  }
  for (; i < n; ++i) acc = __fmaf_rn(x[i], y[i], acc);
  return acc;
}

// A stage of b: j's rows [kStageRows][7], then wr's [kStageRows], row-major
// as in global memory.
constexpr int kStageJ = kStageRows * 7;

// Whether lane b's j and wr are row-major and 16-byte aligned: then a stage
// comes in by bulk copies, else float by float.
__device__ inline bool bulk_ok(const Operands& op, int b) {
  const uintptr_t j = reinterpret_cast<uintptr_t>(op.j + b * op.sj[0]);
  const uintptr_t w = reinterpret_cast<uintptr_t>(op.wr + b * op.swr[0]);
  return op.sj[1] == 7 && op.sj[2] == 1 && op.swr[1] == 1 &&
         ((j | w) & 15) == 0;
}

// Fills stage slot `slot` with rows [k0, k0 + rows) of lane b's j and wr
// and arrives on `bar`. Bulk (one thread): the 16-byte multiple of each
// range in one cp.async.bulk (the barrier counts its bytes), the last
// floats by the thread itself; otherwise float by float through the
// strides, by loader threads lt of nth, each arriving.
__device__ inline void fill_stage(float* slot, const Operands& op, int b,
                                  int k0, int rows, int lt, int nth,
                                  bool bulk, uint64_t* bar) {
  float* js = slot;
  float* ws = slot + kStageJ;
  if (bulk) {
    const float* gj = op.j + b * op.sj[0] + k0 * 7;
    const float* gw = op.wr + b * op.swr[0] + k0;
    const int jn = rows * 7 & ~3, wn = rows & ~3;
    for (int e = jn; e < rows * 7; ++e) js[e] = gj[e];
    for (int e = wn; e < rows; ++e) ws[e] = gw[e];
    mbar_arrive_tx(bar, 4 * (jn + wn));
    if (jn) bulk_copy(js, gj, 4 * jn, bar);
    if (wn) bulk_copy(ws, gw, 4 * wn, bar);
    return;
  }
  for (int e = lt; e < rows * 7; e += nth) {
    const int r = e / 7, c = e - 7 * r;
    js[e] = op.j[b * op.sj[0] + (k0 + r) * op.sj[1] + c * op.sj[2]];
  }
  for (int r = lt; r < rows; r += nth)
    ws[r] = op.wr[b * op.swr[0] + (k0 + r) * op.swr[1]];
  mbar_arrive(bar);
}

// acc over rows first, first + kStep, ... of a whole stage (kN of them)
// of column c, unrolled: straight-line code whose shared-memory loads the
// compiler issues ahead of their FMAs, so a step waits on no load.
template <int kStep, int kN>
__device__ inline float stage_run(const float* js, const float* ws, int c,
                                  int first, float acc) {
  const float* x = js + first * 7 + c;
  const float* y = ws + first;
#pragma unroll
  for (int u = 0; u < kN; ++u)
    acc = __fmaf_rn(x[u * 7 * kStep], y[u * kStep], acc);
  return acc;
}

// acc over rows first, first + step, ... < end of column c, one at a time.
__device__ inline float row_chain(const float* js, const float* ws, int c,
                                  int first, int end, int step, float acc) {
  for (int r = first; r < end; r += step)
    acc = __fmaf_rn(js[r * 7 + c], ws[r], acc);
  return acc;
}

// The horizontal sum of n lanes (a power of two) lanes[l * 7 + c]: lane l
// plus lane l + n/2, down to one.
__device__ inline float lane_tree(float* lanes, int n, int c) {
  for (int half = n / 2; half >= 1; half /= 2)
    for (int l = 0; l < half; ++l)
      lanes[l * 7 + c] = __fadd_rn(lanes[l * 7 + c], lanes[(l + half) * 7 + c]);
  return lanes[c];
}

// The D and A partial sums of chunk c, from its rows staged in shared
// memory column by column.
__device__ void chunk_sums(const Operands& op, int m, int b, int c,
                           float* smem, float* lane_work) {
  const int t = threadIdx.x;
  int lo, hi, block, blocks;
  tree_chunk(m, c, &lo, &hi, &block, &blocks);
  const int rows = hi - lo;
  if (rows > kChunkRows) __trap();
  for (int r = t; r < rows; r += kBlock) {
    const int k = lo + r;
    const float* v = op.jv + b * op.sjv[0] + k * op.sjv[1];
    const float* w = op.jw + b * op.sjw[0] + k * op.sjw[1];
    const float* jj = op.j + b * op.sj[0] + k * op.sj[1];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
      cp_async4(smem + i * kChunkRun + r, v + i * op.sjv[2]);
      cp_async4(smem + (7 + i) * kChunkRun + r, w + i * op.sjw[2]);
      cp_async4(smem + (14 + i) * kChunkRun + r, jj + i * op.sj[2]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (t < kEntries) {
    const int i = t / 7, col = t % 7;
    lane_work[c * kEntries + t] =
        fma_run(smem + i * kChunkRun, smem + (14 + col) * kChunkRun, rows,
                0.0f);
  }
}

// b of lane b (7 floats into out7), streaming j's rows and wr through the
// ring of stages.
__device__ void gradient(const Operands& op, int m, int b, float* smem,
                         float* out7) {
  // full: a stage has landed (the loaders' arrivals and the bulk bytes);
  // empty: the chain threads are done with a slot.
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ float lanes[kMaxLanes * 7];
  const int t = threadIdx.x;
  const Gemv g = gemv_loop(m);
  // Chain threads: (lane, column) pairs of the main loop, or the columns.
  const int chains = g.mode == 1 || g.mode == 2 ? 7
                     : g.mode == 3          ? 7 * g.width
                                            : 7 * 8;
  const int chain_threads = ceil_div(chains, 32) * 32;
  const int loaders = kBlock - chain_threads;
  const bool loader = t >= chain_threads;
  const int stages = ceil_div(m, kStageRows);
  const bool bulk = bulk_ok(op, b);
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, bulk ? 1 : loaders);
      mbar_init(empty + s, chains);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto fill = [&](int st) {
    const int k0 = st * kStageRows;
    fill_stage(smem + (st % kStages) * kStageSlot, op, b, k0,
               m - k0 < kStageRows ? m - k0 : kStageRows, t - chain_threads,
               loaders, bulk, full + st % kStages);
  };
  // One loader thread issues the bulk copies; float by float, all do.
  if (loader && (!bulk || t == chain_threads)) {
    for (int st = 0; st < stages; ++st) {
      if (st >= kStages) mbar_wait(empty + st % kStages,
                                   ((st - kStages) / kStages) & 1);
      fill(st);
    }
  }

  // Main loop's lane chains: lane q of column c.
  const int q = t / 7, c = t % 7;
  // The tiled loop's lanes start from +0, the vector loop's lane 0 from
  // +0 and its others from -0.
  float acc = g.mode == 0 || q == 0 ? 0.0f : -0.0f;
  for (int st = 0; st < stages; ++st) {
    if (t < chains) {
      mbar_wait(full + st % kStages, (st / kStages) & 1);
      const float* js = smem + (st % kStages) * kStageSlot;
      const float* ws = js + kStageJ;
      const int k0 = st * kStageRows;
      const int end = g.main_rows - k0 < kStageRows ? g.main_rows - k0
                                                    : kStageRows;
      if ((g.mode == 0 || g.mode == 3) && end < kStageRows) {
        // The last stage, or a short problem: row by row.
        acc = row_chain(js, ws, c, q, end, g.mode == 3 ? g.width : 8, acc);
      } else if (g.mode == 0) {
        acc = stage_run<8, kStageRows / 8>(js, ws, c, q, acc);
      } else if (g.mode == 3) {
        acc = g.width == 16
                  ? stage_run<16, kStageRows / 16>(js, ws, c, q, acc)
                  : stage_run<32, kStageRows / 32>(js, ws, c, q, acc);
      } else if (g.mode == 4 && st == 0) {
        // One 8-lane register: register 0's trips, then each other
        // register's with its first two trips swapped.
        for (int u = 0; u < g.width / 8; ++u)
          for (int idx = 0; idx < g.trips; ++idx) {
            const int i = u > 0 && g.trips > 1 && idx < 2 ? 1 - idx : idx;
            const int r = g.width * i + 8 * u + q;
            acc = __fmaf_rn(js[r * 7 + c], ws[r], acc);
          }
      }
      if (st + kStages < stages) mbar_arrive(empty + st % kStages);
    }
  }
  if (t < chains && g.mode != 1 && g.mode != 2) lanes[q * 7 + c] = acc;
  __syncthreads();
  if (t >= 7) return;
  // The last stage holds every row from main_rows on (main_rows and the
  // stages are multiples of the lane count); rows relative to it.
  const int k0 = (stages - 1) * kStageRows;
  const float* js = smem + ((stages - 1) % kStages) * kStageSlot;
  const float* ws = js + kStageJ;
  const int main_rel = g.main_rows - k0, m_rel = m - k0;
  float sum;
  if (g.mode == 1) {
    sum = __fmul_rn(js[t], ws[0]);
  } else if (g.mode == 2) {
    sum = row_chain(js, ws, t, 0, m_rel, 1, 0.0f);
  } else if (g.mode == 0) {
    const float s1 = lane_tree(lanes, 8, t);
    sum = __fadd_rn(s1, row_chain(js, ws, t, main_rel, m_rel, 1, 0.0f));
  } else {
    if (g.mode == 3) {
      // The registers of 8 lanes added in order.
      for (int u = 1; u < g.width / 8; ++u)
        for (int l = 0; l < 8; ++l)
          lanes[l * 7 + t] = __fadd_rn(lanes[l * 7 + t],
                                       lanes[(8 * u + l) * 7 + t]);
    }
    sum = lane_tree(lanes, 8, t);
    int done = main_rel;
    if (g.etrips) {
      float e[8];
      for (int l = 0; l < g.epilogue; ++l)
        e[l] = row_chain(js, ws, t, done + l, done + g.epilogue * g.etrips,
                         g.epilogue, l == 0 ? sum : -0.0f);
      for (int half = g.epilogue / 2; half >= 1; half /= 2)
        for (int l = 0; l < half; ++l) e[l] = __fadd_rn(e[l], e[l + half]);
      sum = e[0];
      done += g.epilogue * g.etrips;
    }
    sum = row_chain(js, ws, t, done, m_rel, 1, sum);
  }
  out7[t] = sum;
}

// Entry t's total from its chunk partials part[c * kEntries] (c in tree
// order): each block's chunks in order, then the blocks in groups of four
// (`packet`: (b0 + b1) + (b2 + b3), else b0 + ((b1 + b2) + b3)), a short
// group in order, then the groups in order. The walk is tree_chunk's.
// The partials are read from shared memory (kShared), or from global
// memory through L2.
template <bool kShared>
__device__ inline float part_at(const float* part, int i) {
  return kShared ? part[i] : __ldcg(part + i);
}

template <bool kShared>
__device__ inline float block_sum(const float* part, int first, int count) {
  float r = part_at<kShared>(part, first * kEntries);
  for (int c = 1; c < count; ++c)
    r = __fadd_rn(r, part_at<kShared>(part, (first + c) * kEntries));
  return r;
}

template <bool kShared>
__device__ inline float fold_entry(const float* part, int m, bool packet) {
  if (m <= kShardAbove) {
    int lo, hi, block, blocks;
    return block_sum<kShared>(
        part, 0, tree_chunk(m, -1, &lo, &hi, &block, &blocks));
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
    sums[blocks++] = block_sum<kShared>(part, c, count);
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

__global__ void __launch_bounds__(kBlock, 2)
    normal_equations_kernel(Operands op, int m, int chunks,
                            float* __restrict__ work,
                            unsigned* __restrict__ tickets,
                            float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // Every lane's chunks first, then the B blocks that compute b: a batch's
  // b blocks start as the chunks drain and run alone on their SMs (sharing
  // one with a chunk block slows b's chains).
  const int batch = gridDim.x / (chunks + 1);
  const int id = blockIdx.x;
  const bool grad = id >= chunks * batch;
  const int b = grad ? id - chunks * batch : id / chunks;
  const int c = grad ? chunks : id % chunks;
  const int t = threadIdx.x;
  float* lane_work = work + static_cast<long long>(b) * chunks * kEntries;
  float* o = out + static_cast<long long>(b) * kOut;
  if (c == chunks) {
    gradient(op, m, b, smem, o + kEntries);
    return;
  }
  chunk_sums(op, m, b, c, smem, lane_work);
  // Every thread's sums visible device-wide before the ticket; the chunk
  // block that finishes last folds D and A, while b's block still runs.
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (t == 0) last = atomicAdd(tickets + b, 1u) == chunks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The lane's sums into shared memory at once (they fit up to about
  // 80,000 rows), so the fold's serial adds wait on no L2 load.
  const int sums = chunks * kEntries;
  const bool staged = sums <= kSmemFloats;
  if (staged) {
    for (int i = t; i < sums; i += kBlock) smem[i] = __ldcg(lane_work + i);
    __syncthreads();
  }
  if (t < kEntries) {
    const bool packet = t % 49 < kPacketEntries;
    o[t] = staged ? fold_entry<true>(smem + t, m, packet)
                  : fold_entry<false>(lane_work + t, m, packet);
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
// B * chunks * 98 floats, tickets B zeros. Strides in elements.
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
  // The opt-in to more than 48 KB of dynamic shared memory, once per device.
  static bool ready[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device]) {
    err = cudaFuncSetAttribute(normal_equations_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[device] = true;
  }
  Operands op{jv, jw, j, wr, {}, {}, {}, {}};
  for (int d = 0; d < 3; ++d) {
    op.sjv[d] = sjv[d];
    op.sjw[d] = sjw[d];
    op.sj[d] = sj[d];
  }
  op.swr[0] = swr[0];
  op.swr[1] = swr[1];
  const long long grid = static_cast<long long>(chunks + 1) * batch;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  normal_equations_kernel<<<static_cast<unsigned>(grid), kBlock, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      op, m, chunks, work, tickets, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
