// lu_solve: the pose graph's dense float32 solve H x = g, one CTA per system.
//
// Replaces no TPU kernel. The reference solves the pose graph's normal
// equations with jnp.linalg.solve (lidar_feature_extraction_tpu/parallel/
// pose_graph.py::optimize_pose_graph), which XLA:CPU hands to LAPACK's
// sgetrf and two strsm calls (OpenBLAS). This kernel computes the LU
// factorization and the two triangular solves in the order of the plain
// PyTorch version, lidar_feature_extraction_tpu_torch/fusion/kalman.py::
// lu_factor / lu_solve, and equals it bit for bit:
//
// - factorization (OpenBLAS's unblocked left-looking getf2): every entry's
//   updates are one dot product, the first product rounded and the rest
//   fused in ascending order, subtracted once. The dots are carried as
//   running sums in a scratch matrix `acc`, one rank-1 step per column, so
//   an entry's products are added in the same order as the dot's. Pivot:
//   the first row of largest magnitude (a NaN never wins); the column
//   below it is scaled by the pivot's rounded reciprocal (not when the
//   pivot is 0).
// - solves: the unit lower, then the upper triangle by blocks of 16 rows,
//   then 8, 4, 2, 1 (the remainder's bits); within a block a solved row's
//   update is fused into the rows after it, the earlier blocks' as one
//   dot per row (ascending, first product rounded), each unknown
//   multiplied by its pivot's rounded reciprocal.
//
// Built with --fmad=false: every product and sum rounds as written
// (__fmaf_rn where the plain version fuses).
//
// What bounds it on the H100: operations. 2n^3/3 float32 operations
// (37.7 M at n = 384, 0.56 us at 67 TFLOP/s) against n^2 + 2n floats of
// input and output (0.18 us at 3.35 TB/s). One CTA walks the n columns
// in order, a barrier between each step's phases, so one SM does all the
// work and each step waits for the last: the simple kernel that is right
// first. The matrix and the running sums stay in global memory (L2 at
// these sizes: 2.4 MB each at n = 768), each step reading and writing the
// trailing block once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTrsmRows = 16;  // kalman.py's TRSM_ROWS

// Magnitude for the pivot search: a NaN never wins.
__device__ __forceinline__ float pivot_key(float v) {
  const float m = fabsf(v);
  return m != m ? -1.0f : m;
}

// (key, row) pairs: the larger key wins, the smaller row on a tie.
__device__ __forceinline__ bool beats(float k1, int r1, float k0, int r0) {
  return k1 > k0 || (k1 == k0 && r1 < r0);
}

// Number of row blocks of the triangular solves and block c's [lo, hi).
__device__ __forceinline__ int trsm_block_count(int n) {
  return n / kTrsmRows + __popc(n % kTrsmRows);
}

__device__ __forceinline__ void trsm_block(int n, int c, int* lo, int* hi) {
  const int full = n / kTrsmRows;
  *lo = c * kTrsmRows;
  *hi = *lo + kTrsmRows;
  if (c < full) return;
  int index = full;
  int start = full * kTrsmRows;
  for (int size = kTrsmRows / 2; size > 0; size /= 2) {
    if ((n - start) & size) {
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

// Row r of x (k columns) minus the dot of A[r, ks] with x[ks], ks the
// rows k_begin .. k_end - 1 in ascending order.
__device__ __forceinline__ float subtract_dot(const float* A, const float* X,
                                              int n, int k, int r, int col,
                                              int k_begin, int k_end) {
  float acc = __fmul_rn(A[r * n + k_begin], X[k_begin * k + col]);
  for (int kk = k_begin + 1; kk < k_end; ++kk) {
    acc = __fmaf_rn(A[r * n + kk], X[kk * k + col], acc);
  }
  return __fsub_rn(X[r * k + col], acc);
}

__global__ void __launch_bounds__(kThreads)
lu_solve_kernel(float* __restrict__ lu, float* __restrict__ acc,
                int* __restrict__ perm, float* __restrict__ x,
                const float* __restrict__ b, int n, int k) {
  const size_t sys = blockIdx.x;
  float* A = lu + sys * n * n;   // a on entry, the packed factors on exit
  float* C = acc + sys * n * n;  // running dot products
  int* P = perm + sys * n;
  float* X = x + sys * n * k;
  const float* B = b + sys * n * k;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __shared__ float s_key[kWarps];
  __shared__ int s_row[kWarps];
  __shared__ int s_pivot;

  for (int i = tid; i < n; i += kThreads) P[i] = i;
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // 1. Column j below the diagonal: subtract its dots, find the pivot.
    float key = -2.0f;
    int row = n;
    for (int r = j + tid; r < n; r += kThreads) {
      float v = A[r * n + j];
      if (j > 0) {
        v = __fsub_rn(v, C[r * n + j]);
        A[r * n + j] = v;
      }
      const float m = pivot_key(v);
      if (beats(m, r, key, row)) {
        key = m;
        row = r;
      }
    }
    for (int off = 16; off > 0; off /= 2) {
      const float k2 = __shfl_down_sync(0xffffffffu, key, off);
      const int r2 = __shfl_down_sync(0xffffffffu, row, off);
      if (beats(k2, r2, key, row)) {
        key = k2;
        row = r2;
      }
    }
    if (lane == 0) {
      s_key[warp] = key;
      s_row[warp] = row;
    }
    __syncthreads();
    if (warp == 0) {
      key = s_key[lane];
      row = s_row[lane];
      for (int off = 16; off > 0; off /= 2) {
        const float k2 = __shfl_down_sync(0xffffffffu, key, off);
        const int r2 = __shfl_down_sync(0xffffffffu, row, off);
        if (beats(k2, r2, key, row)) {
          key = k2;
          row = r2;
        }
      }
      if (lane == 0) s_pivot = row;
    }
    __syncthreads();

    // 2. Swap rows j and p of the factors, the running sums and perm.
    const int p = s_pivot;
    if (p != j) {
      for (int c = tid; c < n; c += kThreads) {
        const float a0 = A[j * n + c], a1 = A[p * n + c];
        A[j * n + c] = a1;
        A[p * n + c] = a0;
        const float c0 = C[j * n + c], c1 = C[p * n + c];
        C[j * n + c] = c1;
        C[p * n + c] = c0;
      }
      if (tid == 0) {
        const int t = P[j];
        P[j] = P[p];
        P[p] = t;
      }
    }
    __syncthreads();

    // 3. Scale the column below the pivot; finish row j of U.
    const float pivot = A[j * n + j];
    if (pivot != 0.0f) {
      const float rcp = __fdiv_rn(1.0f, pivot);
      for (int r = j + 1 + tid; r < n; r += kThreads) {
        A[r * n + j] = __fmul_rn(A[r * n + j], rcp);
      }
    }
    if (j > 0) {
      for (int c = j + 1 + tid; c < n; c += kThreads) {
        A[j * n + c] = __fsub_rn(A[j * n + c], C[j * n + c]);
      }
    }
    __syncthreads();

    // 4. Add column j's products to the trailing running sums.
    const int m = n - j - 1;
    for (int e = tid; e < m * m; e += kThreads) {
      const int r = j + 1 + e / m;
      const int c = j + 1 + e % m;
      const float l = A[r * n + j], u = A[j * n + c];
      C[r * n + c] = j == 0 ? __fmul_rn(l, u) : __fmaf_rn(l, u, C[r * n + c]);
    }
    __syncthreads();
  }

  // The right-hand side in pivot order.
  for (int e = tid; e < n * k; e += kThreads) {
    X[e] = B[P[e / k] * k + e % k];
  }
  __syncthreads();

  // Unit lower triangle, blocks top to bottom.
  const int nb = trsm_block_count(n);
  for (int c = 0; c < nb; ++c) {
    int lo, hi;
    trsm_block(n, c, &lo, &hi);
    if (lo > 0) {
      // Each thread reads rows < lo and writes one row in [lo, hi).
      for (int e = tid; e < (hi - lo) * k; e += kThreads) {
        const int r = lo + e / k, col = e % k;
        const float v = subtract_dot(A, X, n, k, r, col, 0, lo);
        X[r * k + col] = v;
      }
      __syncthreads();
    }
    for (int i = lo; i < hi - 1; ++i) {
      for (int e = tid; e < (hi - i - 1) * k; e += kThreads) {
        const int r = i + 1 + e / k, col = e % k;
        X[r * k + col] = __fmaf_rn(-X[i * k + col], A[r * n + i],
                                   X[r * k + col]);
      }
      __syncthreads();
    }
  }

  // Upper triangle, blocks bottom to top.
  for (int c = nb - 1; c >= 0; --c) {
    int lo, hi;
    trsm_block(n, c, &lo, &hi);
    if (hi < n) {
      for (int e = tid; e < (hi - lo) * k; e += kThreads) {
        const int r = lo + e / k, col = e % k;
        const float v = subtract_dot(A, X, n, k, r, col, hi, n);
        X[r * k + col] = v;
      }
      __syncthreads();
    }
    for (int i = hi - 1; i >= lo; --i) {
      const float rcp = __fdiv_rn(1.0f, A[i * n + i]);
      for (int col = tid; col < k; col += kThreads) {
        X[i * k + col] = __fmul_rn(X[i * k + col], rcp);
      }
      __syncthreads();
      for (int e = tid; e < (i - lo) * k; e += kThreads) {
        const int r = lo + e / k, col = e % k;
        X[r * k + col] = __fmaf_rn(-X[i * k + col], A[r * n + i],
                                   X[r * k + col]);
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

int lu_solve_threads() { return kThreads; }
int lu_solve_trsm_rows() { return kTrsmRows; }

const char* lu_solve_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Solves `batch` systems A x = b on `stream`, one CTA each: lu [batch, n, n]
// holds A on entry and the packed factors on exit, acc [batch, n, n] is
// scratch, perm [batch, n] receives the row permutation, b and x are
// [batch, n, k]. Returns a CUDA error code.
int lu_solve(void* lu, void* acc, void* perm, void* x, const void* b,
             int batch, int n, int k, void* stream) {
  if (batch <= 0 || n <= 0 || k <= 0) return 0;
  lu_solve_kernel<<<batch, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(lu), static_cast<float*>(acc),
      static_cast<int*>(perm), static_cast<float*>(x),
      static_cast<const float*>(b), n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
