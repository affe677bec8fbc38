// lu_solve: the pose graph's dense float32 solve H x = g on Hopper, one
// cooperative launch per call, one group of CTAs per system of the batch.
//
// Replaces no TPU kernel. The reference solves the pose graph's normal
// equations with jnp.linalg.solve (lidar_feature_extraction_tpu/parallel/
// pose_graph.py::optimize_pose_graph), which XLA:CPU hands to OpenBLAS's
// sgetrf and two strsm calls. This kernel computes them in the order of the
// plain PyTorch version, lidar_feature_extraction_tpu_torch/fusion/
// kalman.py::lu_factor / lu_solve, and equals it bit for bit. The host
// passes kalman.lu_plan(n), OpenBLAS's blocked factorization at its pinned
// thread count as steps, each ended by a grid barrier:
//
// - GETF2 (off, w): the first CTA factors the panel of columns [off, off +
//   w) of rows [off, n) in shared memory, left-looking as OpenBLAS's getf2,
//   one CTA barrier a column (getf2 below). Its row swaps are applied to
//   every other column at the start of the next step, one column a thread
//   over all the CTAs (apply_swaps), before a grid barrier.
// - UPDATE (r0, k, c0, c1): the panel [r0, r0 + k) applied to columns
//   [c0, c1) by every CTA of the system: strsm's LT kernel on its rows
//   (blocks of 16 rows, then 8, 4, 2, 1; each block first minus one FMA
//   chain per entry over the rows above it, then each solved row fused into
//   the block's rows after it), then sgemm's kernel below: each entry minus
//   one FMA chain over the panel from +0, as float32 SIMT tiles of 64 x 64
//   (4 x 4 per thread) spread over the CTAs. No tensor cores: they would
//   round the operands to TF32 and sum in their own order. Up to kFusedK
//   rows, each tile solves its columns' strsm itself in shared memory and
//   the first row tile's rows go through a scratch (ubuf), copied into place
//   during the next step, so that one grid barrier ends the step; above,
//   strsm runs by column tiles (its chains carried right-looking, in their
//   order), a grid barrier, then the tiles.
// - The solve: the first CTA (one right-hand side is latency-bound):
//   strsm's blocks of kalman.GEMM_Q rows; the unit lower triangle from the
//   top, its chains carried right-looking, the upper from the bottom, each
//   block's chain staged in shared memory, each unknown times its pivot's
//   rounded reciprocal.
//
// Built with --fmad=false: every product and sum rounds as written
// (__fmaf_rn where the plain version fuses).
//
// What bounds it on the H100: the chain of dependent steps. 2n^3/3 float32
// operations (302 M at n = 768, 4.5 us at 67 TFLOP/s) against n^2 + 2n
// floats (0.7 us at 3.35 TB/s), but every panel column waits for the last
// (about 1,800 SM cycles a column at n = 768, profile_lu_solve.py
// --phases) and every
// step for a grid barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTrsmRows = 16;   // kalman.py's TRSM_ROWS
constexpr int kGemmQ = 448;     // kalman.py's GEMM_Q
constexpr int kMaxPanel = 17;   // widest getf2 panel (lu_plan's)
constexpr int kTile = 64;       // gemm tile (rows and columns)
constexpr int kChunk = 32;      // k staged per gemm pass
constexpr int kFusedK = 64;     // updates of up to this many rows in one phase
constexpr int kTrsmCols = 16;   // strsm column tile above kFusedK
constexpr int kGetf2 = 0;       // kalman.py's GETF2
constexpr float kFltMin = 1.17549435082228750797e-38f;

constexpr int kMaxN = 768;      // kalman.lu_plan's largest dense system
constexpr int kMaxParts = 132;  // CTAs per system (one per SM; a barrier
                                // costs more with each)

// Shared memory (floats): the largest of the phases' layouts.
constexpr int kPanelFloats = kMaxN * (kMaxPanel + 1);
constexpr int kSwapInts = 4 * kMaxPanel + 1;  // a panel's moved rows
constexpr int kFusedFloats = kFusedK * (kFusedK + 1) + kFusedK * kTile +
                             kTile * (kFusedK + 1);
constexpr int kTrsmFloats = kGemmQ * (2 * kTrsmCols + kTrsmRows);
constexpr int kGemmFloats = kTile * (kChunk + 1) + kChunk * kTile;
constexpr int kSolveCols = 4096;  // right-hand-side floats in shared memory
constexpr int kSolveFloats = kMaxN + 2 * kSolveCols + kTrsmRows * kGemmQ;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kSmemFloats =
    cmax(cmax(kPanelFloats, kFusedFloats),
         cmax(cmax(kTrsmFloats, kGemmFloats), kSolveFloats));

// A build with -DLU_PHASE_TIMING (profile_lu_solve.py --phases; the port
// never uses it) stamps %globaltimer from the first CTA: at the start, after
// the copy, at each step's start, end of its own work and end of its grid
// barrier, and around the solve.
#ifdef LU_PHASE_TIMING
constexpr int kStamps = 4096;
constexpr int kParts = 8;
__device__ unsigned long long g_stamps[kStamps];
__device__ unsigned long long g_parts[kParts];
__device__ __forceinline__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ bool timer_thread() {
  return blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
}
__device__ __forceinline__ void stamp(int i) {
  if (timer_thread() && i < kStamps) g_stamps[i] = now();
}
// Sub-phases of the first CTA's panels and solve, in SM cycles summed over
// a launch (shared memory, written out at the end): part(i) adds the
// cycles since the last part() or mark().
__shared__ unsigned long long s_parts[kParts];
__shared__ long long s_mark;
__device__ __forceinline__ void mark() {
  if (timer_thread()) s_mark = clock64();
}
__device__ __forceinline__ void part(int i) {
  if (timer_thread()) {
    const long long t = clock64();
    s_parts[i] += t - s_mark;
    s_mark = t;
  }
}
__device__ __forceinline__ void parts_begin() {
  if (timer_thread()) {
    for (int i = 0; i < kParts; ++i) s_parts[i] = 0;
  }
}
__device__ __forceinline__ void parts_end() {
  if (timer_thread()) {
    for (int i = 0; i < kParts; ++i) g_parts[i] += s_parts[i];
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
__device__ __forceinline__ void mark() {}
__device__ __forceinline__ void part(int) {}
__device__ __forceinline__ void parts_begin() {}
__device__ __forceinline__ void parts_end() {}
#endif

struct Args {
  const float* a;     // [batch, n, n]
  float* x;           // [batch, n, k]
  const float* b;     // [batch, n, k]
  const int* plan;    // [steps, 5]
  float* work;        // [batch, workspace_floats(n)]
  int steps, n, k;
};

// A system's workspace: the packed factors [n, n], the strsm rows of fused
// updates [2, kFusedK, n], then (as ints) the row permutation [n] and a
// panel's moved rows [kSwapInts].
__host__ __device__ constexpr int workspace_floats(int n) {
  return n * n + 2 * kFusedK * n + n + kSwapInts;
}

// strsm's row blocks of m rows: the count and block c's [lo, hi).
__device__ __forceinline__ int trsm_block_count(int m) {
  return m / kTrsmRows + __popc(m % kTrsmRows);
}

__device__ __forceinline__ void trsm_block(int m, int c, int* lo, int* hi) {
  const int full = m / kTrsmRows;
  *lo = c * kTrsmRows;
  *hi = *lo + kTrsmRows;
  if (c < full) return;
  int index = full;
  int start = full * kTrsmRows;
  for (int size = kTrsmRows / 2; size > 0; size /= 2) {
    if ((m - start) & size) {
      if (index == c) {
        *lo = start;
        *hi = start + size;
        return;
      }
      ++index;
      start += size;
    }
  }
}

// The first row of the block that holds row r of m.
__device__ __forceinline__ int trsm_block_start(int m, int r) {
  const int full = m / kTrsmRows * kTrsmRows;
  if (r < full) return r / kTrsmRows * kTrsmRows;
  int start = full;
  for (int size = kTrsmRows / 2; size > 0; size /= 2) {
    if ((m - start) & size) {
      if (r < start + size) return start;
      start += size;
    }
  }
  return start;
}

// Calls f(r, c) for every r < rows, c < cols, spread over the CTA without
// integer division: lanes take columns (a power of two of them for fewer
// than 32 columns), warps rows, so that row-major data is read coalesced.
// f must not wait at a barrier.
template <typename F>
__device__ __forceinline__ void for_tile(int rows, int cols, F&& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (cols >= 32) {
#pragma unroll 2
    for (int r = warp; r < rows; r += kWarps) {
#pragma unroll 4
      for (int c = lane; c < cols; c += 32) f(r, c);
    }
    return;
  }
  const int shift = 32 - __clz(max(cols - 1, 0));  // lanes per row: 2^shift
  const int c = lane & ((1 << shift) - 1);
  if (c >= cols) return;
  const int per = 32 >> shift;
#pragma unroll 4
  for (int r = warp * per + (lane >> shift); r < rows; r += kWarps * per) {
    f(r, c);
  }
}

// Pivot-search key: the magnitude's bits plus one (order-preserving for
// magnitudes), 0 for a NaN, which never wins.
__device__ __forceinline__ unsigned pivot_key(float v) {
  const float m = fabsf(v);
  return m != m ? 0u : __float_as_uint(m) + 1u;
}

// Block-wide argmax over (key, logical row) with OpenBLAS's isamax rule:
// the largest key, the smallest logical row on a tie; every thread gets the
// winner's logical row, physical row and value. One barrier; the shared
// slots are `buf` (two sets, by column parity, as a thread can run one
// column ahead of the slowest).
struct ArgmaxSlots {
  unsigned key[2][kWarps];
  int logical[2][kWarps];
  int phys[2][kWarps];
  float val[2][kWarps];
};

__device__ __forceinline__ void block_argmax(unsigned key, int logical,
                                             int phys, float val, int buf,
                                             ArgmaxSlots& s, int* win_logical,
                                             int* win_phys, float* win_val) {
  const int warp = threadIdx.x >> 5;
  const unsigned best = __reduce_max_sync(0xffffffffu, key);
  const int first = static_cast<int>(__reduce_min_sync(
      0xffffffffu,
      key == best ? static_cast<unsigned>(logical) : 0xffffffffu));
  if (key == best && logical == first) {
    s.key[buf][warp] = best;
    s.logical[buf][warp] = first;
    s.phys[buf][warp] = phys;
    s.val[buf][warp] = val;
  }
  __syncthreads();
  unsigned k = s.key[buf][0];
  int l = s.logical[buf][0], at = 0;
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    const unsigned kw = s.key[buf][w];
    const int lw = s.logical[buf][w];
    const bool wins = kw > k || (kw == k && lw < l);
    k = wins ? kw : k;
    l = wins ? lw : l;
    at = wins ? w : at;
  }
  *win_logical = l;
  *win_phys = s.phys[buf][at];
  *win_val = s.val[buf][at];
}

constexpr int kRowsPerThread = (kMaxN + kThreads - 1) / kThreads;

// sdot of row x (shared memory, stride 1) with y (registers), I terms:
// fused pairs fma(x0, y0, x1*y1) added in order in float64 from 0, a last
// odd product rounded, the total rounded to float32.
template <int I, int N>
__device__ __forceinline__ float sdot_fixed(const float* x,
                                            const float (&y)[N]) {
  double acc = 0.0;
#pragma unroll
  for (int t = 0; t + 1 < I; t += 2) {
    const float p = __fmaf_rn(x[t], y[t], __fmul_rn(x[t + 1], y[t + 1]));
    acc = __dadd_rn(acc, static_cast<double>(p));
  }
  if constexpr (I & 1) {
    acc = __dadd_rn(acc, static_cast<double>(__fmul_rn(x[I - 1], y[I - 1])));
  }
  return __double2float_rn(acc);
}

// The pivot search's candidate of one thread.
struct Candidate {
  unsigned key = 0u;
  int logical = 0x7fffffff;
  int phys = -1;
  float val = 0.0f;
};

// Panel column J (a compile-time constant: exact loop lengths, registers
// indexed by constants) up to the pivot search: its rows above the
// diagonal, u[t] for t < J, the last (u[J - 1]) computed by every thread
// from row J - 1 (physical `prev`), whose entries in the later columns one
// thread each computes too; then, for the thread's rows at or below the
// diagonal, y - A u as sgemv_n (at J = 4 the first (m - 4 - (m - 4) % 4)
// % 16 rows as the chains of columns (0, 2) and (1, 3), added), and its
// pivot candidate. Returns u[J - 1] (stored by the caller once every
// thread has read the old value).
template <int J>
__device__ __forceinline__ float panel_column(
    float* pan, int wp, int w, int m, int pt, const int* s_pph, int prev,
    const int (&lg)[kRowsPerThread], float (&v)[kRowsPerThread],
    Candidate& cand, int* s_pj) {
  float u[J > 0 ? J : 1];
#pragma unroll
  for (int t = 0; t + 1 < J; ++t) u[t] = pan[s_pph[t] * wp + J];
  float ujm1 = J > 0 ? pan[prev * wp + J] : 0.0f;
  if constexpr (J >= 2) {
    const float* lrow = pan + prev * wp;
    ujm1 = __fsub_rn(ujm1, sdot_fixed<J - 1>(lrow, u));
    const int c = J + 1 + pt;
    if (c < w) {
      float y[J - 1];
#pragma unroll
      for (int t = 0; t < J - 1; ++t) y[t] = pan[s_pph[t] * wp + c];
      pan[prev * wp + c] = __fsub_rn(pan[prev * wp + c],
                                     sdot_fixed<J - 1>(lrow, y));
    }
  }
  if constexpr (J > 0) u[J - 1] = ujm1;
  const int mj = m - J;
  const int split = J == 4 ? (mj - mj % 4) % 16 : 0;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int p = pt + kThreads * q;
    if (p < m && lg[q] >= J) {
      float* rp = pan + p * wp;
      float x = rp[J];
      if constexpr (J > 0) {
        float acc = 0.0f;
        if constexpr (J == 4) {
          if (lg[q] - J < split) {
            const float even = __fmaf_rn(rp[2], u[2],
                                         __fmaf_rn(rp[0], u[0], 0.0f));
            const float odd = __fmaf_rn(rp[3], u[3],
                                        __fmaf_rn(rp[1], u[1], 0.0f));
            acc = __fadd_rn(odd, even);
          } else {
#pragma unroll
            for (int t = 0; t < J; ++t) acc = __fmaf_rn(rp[t], u[t], acc);
          }
        } else {
#pragma unroll
          for (int t = 0; t < J; ++t) acc = __fmaf_rn(rp[t], u[t], acc);
        }
        x = __fsub_rn(x, acc);
        rp[J] = x;
      }
      v[q] = x;
      if (lg[q] == J) *s_pj = p;
      const unsigned kv = pivot_key(x);
      if (kv > cand.key || (kv == cand.key && lg[q] < cand.logical)) {
        cand.key = kv;
        cand.logical = lg[q];
        cand.phys = p;
        cand.val = x;
      }
    }
  }
  return ujm1;
}

// OpenBLAS's getf2 on columns [off, off + w) of rows [off, n), by one CTA,
// with one barrier a column. Rows never move in shared memory: panel
// thread t owns physical rows t, t + kThreads, ... and tracks each
// one's logical row (a pivot swaps two logical rows), so that swapping
// costs nothing and each row is scaled by its owner. A row's entries above
// the diagonal are computed once it is final (after its pivot); the same
// sums as getf2's column-by-column dots. On return the panel is in A at
// its logical rows, and `swaps` lists the rows that moved for apply_swaps.
__device__ void getf2(float* A, int n, int off, int w, int* swaps,
                      float* smem) {
  const int tid = threadIdx.x;
  const int m = n - off;
  const int wp = w | 1;  // odd row stride: rows fall in distinct banks
  float* pan = smem;
  __shared__ ArgmaxSlots slots;
  __shared__ int s_pj[2];      // physical row at logical j, by parity
  __shared__ int s_pph[kMaxPanel];  // physical row of each logical row < j
  __shared__ int s_count;

  mark();
  for_tile(m, w, [&](int r, int c) {
    pan[r * wp + c] = A[(size_t)(off + r) * n + off + c];
  });
  int lg[kRowsPerThread];      // logical row of physical row tid + 128 q
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) lg[q] = tid + kThreads * q;
  int prev = 0;                // s_pph[j - 1]
  if (tid < kMaxPanel) s_pph[tid] = 0;
  if (tid == 0) s_count = 0;
  __syncthreads();
  part(0);

  for (int j = 0; j < w; ++j) {
    const int buf = j & 1;
    float v[kRowsPerThread] = {};
    Candidate cand;
    float ujm1 = 0.0f;
    switch (j) {
#define LU_PANEL_COLUMN(J)                                                  \
  case J:                                                                   \
    ujm1 = panel_column<J>(pan, wp, w, m, tid, s_pph, prev, lg, v, cand,    \
                           &s_pj[buf]);                                     \
    break;
      LU_PANEL_COLUMN(0) LU_PANEL_COLUMN(1) LU_PANEL_COLUMN(2)
      LU_PANEL_COLUMN(3) LU_PANEL_COLUMN(4) LU_PANEL_COLUMN(5)
      LU_PANEL_COLUMN(6) LU_PANEL_COLUMN(7) LU_PANEL_COLUMN(8)
      LU_PANEL_COLUMN(9) LU_PANEL_COLUMN(10) LU_PANEL_COLUMN(11)
      LU_PANEL_COLUMN(12) LU_PANEL_COLUMN(13) LU_PANEL_COLUMN(14)
      LU_PANEL_COLUMN(15) LU_PANEL_COLUMN(16)
#undef LU_PANEL_COLUMN
      default:
        break;
    }
    static_assert(kMaxPanel == 17, "one LU_PANEL_COLUMN case per column");
    part(1);
    int jp, pw;
    float pivot;
    block_argmax(cand.key, cand.logical, cand.phys, cand.val, buf, slots,
                 &jp, &pw, &pivot);
    if (j >= 2 && tid == 0) pan[prev * wp + j] = ujm1;
    part(2);
    const bool normal = pivot != 0.0f && fabsf(pivot) >= kFltMin;
    if (!normal && jp != j) {
      // getf2 swaps the columns up to j only for a normal pivot: undo the
      // logical swap there by exchanging them between the two rows.
      const int pj = s_pj[buf];
      __syncthreads();
      for (int c = tid; c <= j; c += kThreads) {
        const float t = pan[pj * wp + c];
        pan[pj * wp + c] = pan[pw * wp + c];
        pan[pw * wp + c] = t;
      }
      __syncthreads();
    }
    s_pph[j] = pw;  // every thread writes it: each reads back its own
    prev = pw;
    const float rcp = normal ? __fdiv_rn(1.0f, pivot) : 1.0f;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int p = tid + kThreads * q;
      if (p < m && lg[q] >= j) {
        lg[q] = lg[q] == j ? jp : (lg[q] == jp ? j : lg[q]);
        if (normal && lg[q] > j) pan[p * wp + j] = __fmul_rn(v[q], rcp);
      }
    }
    part(3);
  }
  __syncthreads();

  // The panel back at its logical rows (through the inverse map, so that
  // the stores are coalesced); the rows that moved, for apply_swaps.
  int* inv = reinterpret_cast<int*>(pan + m * wp);  // [m] logical -> physical
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int p = tid + kThreads * q;
    if (p < m) {
      inv[lg[q]] = p;
      if (lg[q] != p) {
        const int at = atomicAdd(&s_count, 1);
        swaps[1 + at] = lg[q];
        swaps[1 + 2 * kMaxPanel + at] = p;
      }
    }
  }
  __syncthreads();
  for_tile(m, w, [&](int r, int c) {
    A[(size_t)(off + r) * n + off + c] = pan[inv[r] * wp + c];
  });
  if (tid == 0) swaps[0] = s_count;
  __syncthreads();
  part(4);
}

// One column of a block of rows (up to kTrsmRows) of the unit lower
// triangle L (stride ls): first minus the rows' chains `acc` (when given),
// then each solved row fused into the rows after it, in registers.
__device__ __forceinline__ void lower_block(const float* L, int ls, float* x,
                                            int xs, int rows,
                                            const float* acc = nullptr) {
  // Loads are unconditional (rows past the block read its last row) and
  // results selected, so that they issue ahead of the chain.
  float xr[kTrsmRows];
#pragma unroll
  for (int r = 0; r < kTrsmRows; ++r) {
    const int rr = min(r, rows - 1);
    const float v = x[rr * xs];
    xr[r] = acc != nullptr ? __fsub_rn(v, acc[rr * xs]) : v;
  }
#pragma unroll
  for (int i = 0; i < kTrsmRows - 1; ++i) {
#pragma unroll
    for (int r = i + 1; r < kTrsmRows; ++r) {
      const float l = L[(size_t)min(r, rows - 1) * ls + min(i, rows - 1)];
      const float v = __fmaf_rn(-xr[i], l, xr[r]);
      xr[r] = r < rows ? v : xr[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kTrsmRows; ++r) {
    if (r < rows) x[r * xs] = xr[r];
  }
}

// The same for the upper triangle U, from the block's last row up: each
// unknown times its pivot's rounded reciprocal (`rcp`), then fused into
// the rows above it.
__device__ __forceinline__ void upper_block(const float* U, int us,
                                            const float* rcp, float* x,
                                            int xs, int rows) {
  float xr[kTrsmRows];
#pragma unroll
  for (int r = 0; r < kTrsmRows; ++r) xr[r] = x[min(r, rows - 1) * xs];
#pragma unroll
  for (int i = kTrsmRows - 1; i >= 0; --i) {
    const int ic = min(i, rows - 1);
    const float xi = __fmul_rn(xr[i], rcp[ic]);
    xr[i] = i < rows ? xi : xr[i];
#pragma unroll
    for (int r = 0; r < i; ++r) {
      const float v = __fmaf_rn(-xi, U[(size_t)min(r, rows - 1) * us + ic],
                                xr[r]);
      xr[r] = i < rows ? v : xr[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kTrsmRows; ++r) {
    if (r < rows) x[r * xs] = xr[r];
  }
}

// acc[r, c] (rows [r0, r1), cols columns, stride xs, shared memory)
// extended by the chain terms L[r, t] X[t, c] for t in [t0, t1) (at most
// kTrsmRows), in ascending t: the right-looking form of a lower solve's
// dots, each entry's terms in the order of its one chain.
__device__ void extend_chains(const float* L, int ls, const float* X, int xs,
                              float* acc, int cols, int r0, int r1, int t0,
                              int t1) {
  for_tile(r1 - r0, cols, [&](int rr, int col) {
    const int r = r0 + rr;
    const float* lr = L + (size_t)r * ls + t0;
    const int len = t1 - t0;
    float a = acc[r * xs + col];
#pragma unroll
    for (int t = 0; t < kTrsmRows; ++t) {
      const int tc = min(t, len - 1);  // loads ahead, results selected
      const float v = __fmaf_rn(lr[tc], X[(t0 + tc) * xs + col], a);
      a = t < len ? v : a;
    }
    acc[r * xs + col] = a;
  });
}

// strsm's LT kernel on X [k, cols] (row stride xs) with the unit lower
// triangle L (row stride ls), both in shared memory: by row blocks top to
// bottom, each block first minus one chain per entry over the rows above
// it, then solved in registers.
__device__ void trsm_lower(const float* L, int ls, float* X, int xs, int k,
                           int cols) {
  const int nb = trsm_block_count(k);
  for (int c = 0; c < nb; ++c) {
    int lo, hi;
    trsm_block(k, c, &lo, &hi);
    const int rows = hi - lo;
    if (lo > 0) {
      for_tile(rows, cols, [&](int rr, int col) {
        const int r = lo + rr;
        const float* lr = L + (size_t)r * ls;
        float acc = 0.0f;
#pragma unroll 8
        for (int t = 0; t < lo; ++t) {
          acc = __fmaf_rn(lr[t], X[t * xs + col], acc);
        }
        X[r * xs + col] = __fsub_rn(X[r * xs + col], acc);
      });
      __syncthreads();
    }
    for (int col = threadIdx.x; col < cols; col += kThreads) {
      lower_block(L + (size_t)lo * ls + lo, ls, X + lo * xs + col, xs, rows);
    }
    __syncthreads();
  }
}

// C [rows, cols] (row stride n) minus W [rows, k] (stride ws) times
// V [k, cols] (stride vs), both in shared memory, one FMA chain per entry
// from +0 (each thread 4 x 4 entries of a kTile x kTile tile).
__device__ __forceinline__ void tile_chain(const float* W, int ws,
                                           const float* V, int vs, int k,
                                           float acc[4][4]) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  for (int t = 0; t < k; ++t) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = W[(tr + 16 * i) * ws + t];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = V[t * vs + tc + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void tile_store(float* A, int n, int row0,
                                           int rows, int col0, int cols,
                                           float acc[4][4]) {
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tc + 16 * j;
      if (c >= cols) continue;
      float* e = A + (size_t)(row0 + r) * n + col0 + c;
      *e = __fsub_rn(*e, acc[i][j]);
    }
  }
}

// UPDATE with k <= kFusedK: every tile solves its columns' strsm in shared
// memory; the first row tile stores the solved rows into ubuf.
__device__ void update_fused(float* A, float* U, int n, int r0, int k, int c0,
                             int c1, float* smem, int part, int parts) {
  const int ls = k + 1;
  float* Ls = smem;                 // [k, k + 1]
  float* Us = Ls + k * ls;          // [k, kTile]
  float* Ws = Us + k * kTile;       // [kTile, k + 1]
  const int below = n - r0 - k;
  const int nrt = below > 0 ? (below + kTile - 1) / kTile : 1;
  const int nct = (c1 - c0 + kTile - 1) / kTile;
  for (int t = part; t < nrt * nct; t += parts) {
    const int rt = t % nrt, ct = t / nrt;
    const int col0 = c0 + ct * kTile;
    const int cols = min(kTile, c1 - col0);
    const int row0 = r0 + k + rt * kTile;
    const int rows = below > 0 ? min(kTile, n - row0) : 0;
    for_tile(k, k, [&](int r, int c) {
      Ls[r * ls + c] = A[(size_t)(r0 + r) * n + r0 + c];
    });
    for_tile(k, cols, [&](int r, int c) {
      Us[r * kTile + c] = A[(size_t)(r0 + r) * n + col0 + c];
    });
    for_tile(rows, k, [&](int r, int c) {
      Ws[r * ls + c] = A[(size_t)(row0 + r) * n + r0 + c];
    });
    __syncthreads();
    trsm_lower(Ls, ls, Us, kTile, k, cols);
    if (rt == 0) {
      for_tile(k, cols, [&](int r, int c) {
        U[(size_t)r * n + col0 + c] = Us[r * kTile + c];
      });
    }
    if (rows > 0) {
      float acc[4][4] = {};
      tile_chain(Ws, ls, Us, kTile, k, acc);
      tile_store(A, n, row0, rows, col0, cols, acc);
    }
    __syncthreads();
  }
}

// UPDATE above kFusedK, first phase: strsm by column tiles of kTrsmCols,
// in place: the diagonal blocks staged once, each block solved in
// registers, then every row below it extends its chain (right-looking, in
// the chains' order).
__device__ void update_trsm(float* A, int n, int r0, int k, int c0, int c1,
                            float* smem, int part, int parts) {
  const int tid = threadIdx.x;
  float* Xs = smem;                          // [k, kTrsmCols]
  float* acc = Xs + k * kTrsmCols;           // [k, kTrsmCols]
  float* diag = acc + k * kTrsmCols;         // [k, kTrsmRows] by block
  const float* L = A + (size_t)r0 * n + r0;
  const int nb = trsm_block_count(k);
  const int nct = (c1 - c0 + kTrsmCols - 1) / kTrsmCols;
  for (int t = part; t < nct; t += parts) {
    const int col0 = c0 + t * kTrsmCols;
    const int cols = min(kTrsmCols, c1 - col0);
    for_tile(k, cols, [&](int r, int c) {
      Xs[r * kTrsmCols + c] = A[(size_t)(r0 + r) * n + col0 + c];
      acc[r * kTrsmCols + c] = 0.0f;
    });
    for_tile(k, kTrsmRows, [&](int r, int i) {
      const int lo = trsm_block_start(k, r);
      diag[r * kTrsmRows + i] = lo + i < k ? L[(size_t)r * n + lo + i] : 0.0f;
    });
    __syncthreads();
    for (int c = 0; c < nb; ++c) {
      int lo, hi;
      trsm_block(k, c, &lo, &hi);
      for (int col = tid; col < cols; col += kThreads) {
        lower_block(diag + lo * kTrsmRows, kTrsmRows,
                    Xs + lo * kTrsmCols + col, kTrsmCols, hi - lo,
                    lo > 0 ? acc + lo * kTrsmCols + col : nullptr);
      }
      __syncthreads();
      extend_chains(L, n, Xs, kTrsmCols, acc, cols, hi, k, lo, hi);
      __syncthreads();
    }
    for_tile(k, cols, [&](int r, int c) {
      A[(size_t)(r0 + r) * n + col0 + c] = Xs[r * kTrsmCols + c];
    });
    __syncthreads();
  }
}

// UPDATE above kFusedK, second phase: the tiles below, k staged by kChunk.
__device__ void update_gemm(float* A, int n, int r0, int k, int c0, int c1,
                            float* smem, int part, int parts) {
  const int ws = kChunk + 1;
  float* Ws = smem;                  // [kTile, kChunk + 1]
  float* Vs = Ws + kTile * ws;       // [kChunk, kTile]
  const int below = n - r0 - k;
  if (below <= 0) return;
  const int nrt = (below + kTile - 1) / kTile;
  const int nct = (c1 - c0 + kTile - 1) / kTile;
  for (int t = part; t < nrt * nct; t += parts) {
    const int rt = t % nrt, ct = t / nrt;
    const int col0 = c0 + ct * kTile, cols = min(kTile, c1 - col0);
    const int row0 = r0 + k + rt * kTile, rows = min(kTile, n - row0);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < k; k0 += kChunk) {
      const int kc = min(kChunk, k - k0);
      for_tile(kTile, kc, [&](int r, int c) {
        Ws[r * ws + c] = r < rows ? A[(size_t)(row0 + r) * n + r0 + k0 + c]
                                  : 0.0f;
      });
      for_tile(kc, kTile, [&](int r, int c) {
        Vs[r * kTile + c] = c < cols ? A[(size_t)(r0 + k0 + r) * n + col0 + c]
                                     : 0.0f;
      });
      __syncthreads();
      tile_chain(Ws, ws, Vs, kTile, kc, acc);
      __syncthreads();
    }
    tile_store(A, n, row0, rows, col0, cols, acc);
  }
}

// Rows [r0, r0 + rows) of X (shared memory, [n, kx]) minus A[those rows,
// t0:t1] X[t0:t1], one chain per entry (ascending t) from +0, each thread
// an entry reading its row of A from global memory.
__device__ void solve_chain(const float* A, int n, float* X, int kx, int r0,
                            int rows, int t0, int t1) {
  for_tile(rows, kx, [&](int rr, int col) {
    const int r = r0 + rr;
    const float* ar = A + (size_t)r * n;
    float a = 0.0f;
#pragma unroll 8
    for (int t = t0; t < t1; ++t) a = __fmaf_rn(ar[t], X[t * kx + col], a);
    X[r * kx + col] = __fsub_rn(X[r * kx + col], a);
  });
  __syncthreads();
}

// The same for at most kTrsmRows rows, their row segments first staged
// in shared memory by the whole CTA (the upper solve's block chains).
__device__ void block_chain(const float* A, int n, float* X, int kx, int r0,
                            int rows, int t0, int t1, float* stage) {
  const int len = t1 - t0;
  for_tile(rows, len, [&](int r, int t) {
    stage[r * len + t] = A[(size_t)(r0 + r) * n + t0 + t];
  });
  __syncthreads();
  for_tile(rows, kx, [&](int r, int col) {
    const float* lr = stage + r * len;
    const float* xc = X + t0 * kx + col;
    float a = 0.0f;
#pragma unroll 8
    for (int t = 0; t < len; ++t) a = __fmaf_rn(lr[t], xc[t * kx], a);
    float* out = X + (r0 + r) * kx + col;
    *out = __fsub_rn(*out, a);
  });
  __syncthreads();
}

// Both triangular solves of one system by one CTA, kSolveCols floats of
// right-hand sides at a time in shared memory.
__device__ void solve(const float* A, const int* P, float* Xg,
                      const float* B, int n, int k, float* smem) {
  const int tid = threadIdx.x;
  float* rcp = smem;                       // [n] the pivots' reciprocals
  float* X = rcp + kMaxN;                  // [n, kx]
  float* acc = X + kSolveCols;             // [n, kx] lower-solve chains
  float* stage = acc + kSolveCols;         // [kTrsmRows, kGemmQ]
  const int group = max(1, kSolveCols / n);
  mark();
  for (int i = tid; i < n; i += kThreads) {
    rcp[i] = __fdiv_rn(1.0f, A[(size_t)i * n + i]);
  }
  for (int c0 = 0; c0 < k; c0 += group) {
    const int kx = min(group, k - c0);
    for_tile(n, kx, [&](int r, int c) {
      X[r * kx + c] = B[(size_t)P[r] * k + c0 + c];
      acc[r * kx + c] = 0.0f;
    });
    __syncthreads();
    // Unit lower triangle, blocks of kGemmQ rows from the top: a block's
    // rows take their chain over the rows above them in the block, the
    // rows below it the chain over the whole block, all carried in acc.
    for (int s = 0; s < n; s += kGemmQ) {
      const int e = min(s + kGemmQ, n), m = e - s;
      const int nb = trsm_block_count(m);
      for (int c = 0; c < nb; ++c) {
        int lo, hi;
        trsm_block(m, c, &lo, &hi);
        for (int col = tid; col < kx; col += kThreads) {
          lower_block(A + (size_t)(s + lo) * n + s + lo, n,
                      X + (s + lo) * kx + col, kx, hi - lo,
                      lo > 0 ? acc + (s + lo) * kx + col : nullptr);
        }
        __syncthreads();
        part(5);
        extend_chains(A, n, X, kx, acc, kx, s + hi, n, s + lo, s + hi);
        __syncthreads();
        part(6);
      }
      for (int i = tid; i < (n - e) * kx; i += kThreads) {
        const int at = e * kx + i;
        X[at] = __fsub_rn(X[at], acc[at]);
        acc[at] = 0.0f;
      }
      __syncthreads();
    }
    mark();
    // Upper triangle, blocks of kGemmQ rows from the bottom: a block's
    // rows first minus the chain over the rows below them in the block.
    for (int e = n; e > 0; e -= kGemmQ) {
      const int s = max(e - kGemmQ, 0), m = e - s;
      const int nb = trsm_block_count(m);
      for (int c = nb - 1; c >= 0; --c) {
        int lo, hi;
        trsm_block(m, c, &lo, &hi);
        if (s + hi < e) {
          block_chain(A, n, X, kx, s + lo, hi - lo, s + hi, e, stage);
        }
        for (int col = tid; col < kx; col += kThreads) {
          upper_block(A + (size_t)(s + lo) * n + s + lo, n, rcp + s + lo,
                      X + (s + lo) * kx + col, kx, hi - lo);
        }
        __syncthreads();
      }
      if (s > 0) solve_chain(A, n, X, kx, 0, s, s, e);
    }
    part(7);
    for_tile(n, kx, [&](int r, int c) {
      Xg[(size_t)r * k + c0 + c] = X[r * kx + c];
    });
    __syncthreads();
  }
}

// A panel's moved rows (getf2's `swaps`: a count, then each moved row's
// logical and physical row) in every column outside it and in P, spread
// over the system's CTAs, a column a thread: all loads first.
__device__ void apply_swaps(float* A, int* P, int n, const int* swaps,
                            int off, int w, int part, int parts) {
  const int count = swaps[0];
  if (count == 0) return;
  const int* moved = swaps + 1;
  const int* src = swaps + 1 + 2 * kMaxPanel;
  for (int c = part * kThreads + threadIdx.x; c <= n; c += parts * kThreads) {
    if (c >= off && c < off + w) continue;
    float v[2 * kMaxPanel];
    int pv[2 * kMaxPanel];
#pragma unroll
    for (int q = 0; q < 2 * kMaxPanel; ++q) {
      const int from = off + src[min(q, count - 1)];
      if (c < n) {
        v[q] = A[(size_t)from * n + c];
      } else {
        pv[q] = P[from];
      }
    }
#pragma unroll
    for (int q = 0; q < 2 * kMaxPanel; ++q) {
      if (q < count) {
        if (c < n) {
          A[(size_t)(off + moved[q]) * n + c] = v[q];
        } else {
          P[off + moved[q]] = pv[q];
        }
      }
    }
  }
}

// Copies the solved rows of the last fused update from ubuf into place.
__device__ void flush_ubuf(float* A, const float* U, int n, int r0, int k,
                           int c0, int c1, int part, int parts) {
  for (int r = part; r < k; r += parts) {
    for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
      A[(size_t)(r0 + r) * n + c] = U[(size_t)r * n + c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
lu_solve_kernel(Args p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int n = p.n;
  const size_t sys = blockIdx.y;
  const int part = blockIdx.x, parts = gridDim.x;
  float* A = p.work + sys * workspace_floats(n);
  float* ubuf = A + n * n;
  int* P = reinterpret_cast<int*>(ubuf + 2 * kFusedK * n);
  int* swaps = P + n;

  stamp(0);
  parts_begin();
  const float* A0 = p.a + sys * n * n;
  for (int e = part * kThreads + threadIdx.x; e < n * n;
       e += parts * kThreads) {
    A[e] = A0[e];
  }
  if (part == 0) {
    for (int i = threadIdx.x; i < n; i += kThreads) P[i] = i;
  }
  grid.sync();
  stamp(1);

  // A fused update's solved rows wait in one half of ubuf until the next
  // step, which copies them into place while the following fused update
  // writes the other half. A panel's row swaps wait for the next step,
  // whose CTAs apply them to their columns before a grid barrier.
  int pend_r0 = 0, pend_k = 0, pend_c0 = 0, pend_c1 = 0;  // ubuf rows
  int panel_off = -1, panel_w = 0;                          // swaps
  int slot = 0;
  for (int s = 0; s < p.steps; ++s) {
    const int* step = p.plan + 5 * s;
    if (pend_c1 > pend_c0) {
      flush_ubuf(A, ubuf + (1 - slot) * kFusedK * n, n, pend_r0, pend_k,
                 pend_c0, pend_c1, part, parts);
      pend_c1 = pend_c0;
    }
    if (panel_off >= 0) {
      apply_swaps(A, P, n, swaps, panel_off, panel_w, part, parts);
      panel_off = -1;
      grid.sync();
    }
    stamp(2 + 3 * s);
    const int r0 = step[1], k = step[2], c0 = step[3], c1 = step[4];
    if (step[0] == kGetf2) {
      if (part == 0) getf2(A, n, step[1], step[2], swaps, smem);
      panel_off = step[1];
      panel_w = step[2];
    } else if (k <= kFusedK) {
      update_fused(A, ubuf + slot * kFusedK * n, n, r0, k, c0, c1, smem,
                   part, parts);
      pend_r0 = r0, pend_k = k, pend_c0 = c0, pend_c1 = c1;
      slot = 1 - slot;
    } else {
      update_trsm(A, n, r0, k, c0, c1, smem, part, parts);
      grid.sync();
      update_gemm(A, n, r0, k, c0, c1, smem, part, parts);
    }
    stamp(3 + 3 * s);
    grid.sync();
    stamp(4 + 3 * s);
  }
  if (pend_c1 > pend_c0) {
    flush_ubuf(A, ubuf + (1 - slot) * kFusedK * n, n, pend_r0, pend_k,
               pend_c0, pend_c1, part, parts);
  }
  if (panel_off >= 0) {
    apply_swaps(A, P, n, swaps, panel_off, panel_w, part, parts);
  }
  grid.sync();
  stamp(2 + 3 * p.steps);
  if (part == 0) {
    solve(A, P, p.x + sys * n * p.k, p.b + sys * n * p.k, n, p.k, smem);
  }
  __syncthreads();
  stamp(3 + 3 * p.steps);
  parts_end();
}

}  // namespace

extern "C" {

int lu_solve_trsm_rows() { return kTrsmRows; }
int lu_solve_gemm_q() { return kGemmQ; }
int lu_solve_max_n() { return kMaxN; }
int lu_solve_max_panel() { return kMaxPanel; }

#ifdef LU_PHASE_TIMING
int lu_solve_stamps(unsigned long long* out, int count) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_stamps, sizeof(unsigned long long) * min(count, kStamps)));
}

// The sub-phase sums (g_parts, SM cycles), then zeroed.
int lu_solve_parts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_parts, sizeof(g_parts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kParts] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_parts, zero, sizeof(zero)));
}
#endif

const char* lu_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// CTAs per system for a batch of `batch` on the current device: the
// co-resident CTAs (one launch must fit for the grid barrier) split among
// the systems, at most kMaxParts each; 0 if the batch does not fit.
int lu_solve_grid(int batch) {
  const size_t smem = kSmemFloats * sizeof(float);
  if (cudaFuncSetAttribute(lu_solve_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess) {
    return 0;
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lu_solve_kernel,
                                                kThreads, smem);
  const int total = sms * per_sm;
  if (batch <= 0 || total < batch) return 0;
  return total / batch < kMaxParts ? total / batch : kMaxParts;
}

int lu_solve_workspace_floats(int n) { return workspace_floats(n); }

// Solves `batch` systems A x = b on `stream`: a [batch, n, n] (unchanged),
// b and x [batch, n, k], plan [steps, 5] kalman.lu_plan(n) on the device,
// work [batch, lu_solve_workspace_floats(n)] scratch; `parts` CTAs work on
// each system (lu_solve_grid). Returns a CUDA error code.
int lu_solve(const void* a, void* x, const void* b, const void* plan,
             void* work, int steps, int batch, int n, int k, int parts,
             void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0) return 0;
  if (n > kMaxN || parts <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args args{static_cast<const float*>(a), static_cast<float*>(x),
            static_cast<const float*>(b), static_cast<const int*>(plan),
            static_cast<float*>(work), steps, n, k};
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lu_solve_kernel), dim3(parts, batch),
      dim3(kThreads), params, kSmemFloats * sizeof(float),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
