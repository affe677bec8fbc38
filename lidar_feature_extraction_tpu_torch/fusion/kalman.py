"""Kalman-filter primitives and the time-delay (augmented-state) filter.

Port of ``lidar_feature_extraction_tpu/fusion/kalman.py:1-128``. The
state is a shift register of the last ``max_delay_step`` states, newest
first; a measurement delayed by ``delay_step`` predict ticks hits that
block. The block measurement matrix D = [0..C..0] is never built:
``P D^T`` and ``D P D^T`` are block slices of P.

``delay_step`` may be a tensor, and nothing here reads it back to the
host: the slices are ``index_select`` with indices computed on the
device. ``lax.dynamic_slice`` wraps a negative start once and clamps
it so that the slice fits; torch indexing does neither, so the block
index is wrapped and clamped into ``[0, n - 1]`` here. An out-of-range
delay thus gives a well-shaped, wrong update, which the gate of
``fusion/ekf.py`` discards, as in the reference.

In float32 the time-delay filter computes the reference's jitted
arithmetic (ROADMAP §C21), read from the optimized programs of
``ekf.predict`` / ``update_pose`` / ``update_twist``: the products as
XLA:CPU sums them (in-order FMA chains from the first product, but the
bottom-left block of the predicted covariance as rounded products added
pairwise, and two of the pose gain's three columns unfused where XLA
vectorized them), and the inverse of the innovation covariance as
OpenBLAS's ``sgetrf`` and two ``strsm`` (``lu_inverse``, ``lu_solve``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf


# --- stateless kernels ---

def predict_next_state(x, u, a, b):
    return a @ x + b @ u


def predict_next_covariance(p, a, q):
    return a @ p @ a.T + q


def calc_kalman_gain(p, c, r):
    pct = p @ c.T
    return pct @ torch.linalg.inv_ex(r + c @ pct).inverse


def update_state(x, y, c, k):
    return x + k @ (y - c @ x)


def update_covariance(p, c, k):
    return p - k @ c @ p


# --- time-delay filter ---

class TimeDelayState(NamedTuple):
    """x: [n*d] newest-first shift register; p: [n*d, n*d]."""

    x: torch.Tensor
    p: torch.Tensor


def init_time_delay(x0: torch.Tensor, p0: torch.Tensor,
                    max_delay_step: int) -> TimeDelayState:
    """Replicate the initial state and covariance into every delay
    block."""
    n = max_delay_step
    return TimeDelayState(
        x=x0.repeat(n),
        p=torch.kron(torch.eye(n, dtype=p0.dtype, device=p0.device), p0))


def predict_with_delay(state: TimeDelayState, x_next: torch.Tensor,
                       a: torch.Tensor, q: torch.Tensor) -> TimeDelayState:
    """Shift the register and propagate the covariance:
    x <- [x_next, x[:-d]];  P <- [[A P11 A' + Q, A P1:], [P:1 A', P::]]
    with P11 / P1: / P:1 / P:: the blocks of the old P."""
    d = a.shape[0]
    c = state.x.shape[0] - d
    x1 = torch.cat([x_next, state.x[:c]])

    bb = state.p[:d, :d]
    bc = state.p[:d, :c]
    cb = state.p[:c, :d]
    cc = state.p[:c, :c]
    if xf._float32(state.p, a):
        top = torch.cat([xf.matmul(xf.matmul(a, bb), a.T) + q,
                         xf.matmul(a, bc)], dim=1)
        bot = torch.cat([_pairwise_products(cb, a), cc], dim=1)
    else:
        top = torch.cat([a @ bb @ a.T + q, a @ bc], dim=1)
        bot = torch.cat([cb @ a.T, cc], dim=1)
    return TimeDelayState(x=x1, p=torch.cat([top, bot], dim=0))


def _pairwise_products(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``u @ v.T`` ([n, d] x [m, d], d even) with every product rounded
    and the products added pairwise, then the pairs in order:
    ``((p0 + p1) + (p2 + p3)) + (p4 + p5)`` for d = 6, as XLA:CPU sums
    the reference's [294, 6] x [6, 6]^T block."""
    prod = u[:, None, :] * v[None, :, :]
    pairs = prod[..., 0::2] + prod[..., 1::2]
    return xf.sum_in_order(pairs, -1)


# --- the reference's float32 dense solves: OpenBLAS's sgetrf and strsm ---
#
# jnp.linalg.solve and jnp.linalg.inv in float32 reach LAPACK's sgetrf and
# BLAS's strsm in the OpenBLAS that scipy's wheel ships (0.3.30, the SkylakeX
# kernels), whose order was read from the library's object code (ROADMAP
# §C23):
#
# - sgetrf threads from PARALLEL_ENTRIES entries (``sgetrf_threads``), and
#   its panels depend on the thread count: single-threaded, a recursion that
#   halves each panel (rounded up to GEMM_UNROLL_N, at most GEMM_Q) down to
#   ``getf2`` at 2 GEMM_UNROLL_N; threaded, a first panel of that width
#   factored by the same threaded recursion (``getf2`` at GEMM_UNROLL_N),
#   then panels whose width a formula of the thread count sets, each
#   factored single-threaded (``lu_plan``);
# - after each panel, the columns to its right: ``strsm``'s kernel on the
#   panel's rows (``_trsm_lower_unit``), then ``sgemm``'s kernel on the
#   rows below, one FMA chain per entry over the panel from +0, subtracted
#   once (``_chain``). Which thread takes which tile changes no entry;
# - ``getf2`` is left-looking: a column's rows above the diagonal by
#   ``sdot`` (fused pairs summed in float64), below it by ``sgemv``
#   (one chain per row; at the panel's column 4 its 4x4 kernel's split
#   sums, ``_gemv_sub``), the pivot the first
#   largest magnitude, the column below it scaled by the pivot's rounded
#   reciprocal; a zero or subnormal pivot swaps and scales nothing in the
#   panel's columns up to it (``_getf2``).
#
# OPENBLAS_THREADS is pinned, as core/_xla_dot.py pins XLA_CPU_THREADS: the
# machine that wrote the reference records had 8 threads, and n = 384 and
# 768 factor differently at 1, 2 and 8.

OPENBLAS_THREADS = 8
GEMM_UNROLL_N = 4
GEMM_Q = 448
PARALLEL_ENTRIES = 40_000
# strsm's kernels solve a block of rows of this many, then the rest in
# blocks of 8, 4, 2 and 1 rows (largest first).
TRSM_ROWS = 16
FLT_MIN = 2.0 ** -126
GETF2, UPDATE = 0, 1


def sgetrf_threads(n: int, cpu: int = OPENBLAS_THREADS) -> int:
    """The threads OpenBLAS's sgetrf gives an [n, n] system on ``cpu``
    threads: one below PARALLEL_ENTRIES entries, else ``cpu`` while each
    keeps PARALLEL_ENTRIES entries, else one per PARALLEL_ENTRIES."""
    entries = n * n
    if entries < PARALLEL_ENTRIES or cpu == 1:
        return 1
    if entries // cpu >= PARALLEL_ENTRIES:
        return cpu
    return entries // PARALLEL_ENTRIES


def _round_up(x: int, unit: int = GEMM_UNROLL_N) -> int:
    return (x + unit - 1) // unit * unit


def _plan_single(n: int, off: int, w: int, steps: list) -> None:
    """``sgetrf_single`` on columns [off, off + w) of rows [off, n)."""
    mn = min(n - off, w)
    blocking = min(_round_up(mn // 2), GEMM_Q)
    if blocking <= 2 * GEMM_UNROLL_N:
        steps.append((GETF2, off, w, 0, 0))
        return
    for j in range(0, mn, blocking):
        jmin = min(mn - j, blocking)
        _plan_single(n, off + j, jmin, steps)
        if j + jmin < w:
            steps.append((UPDATE, off + j, jmin, off + j + jmin, off + w))


def _plan_parallel(n: int, off: int, w: int, t: int, steps: list) -> None:
    """``sgetrf_parallel`` on columns [off, off + w) with ``t`` threads:
    the next panel's width from the thread count (both formulas in
    float64, as the library computes them)."""
    m = n - off
    mn = min(m, w)
    bk = min(_round_up(mn // 2), GEMM_Q)
    if bk <= GEMM_UNROLL_N:
        steps.append((GETF2, off, w, 0, 0))
        return
    next_bk = bk
    bk = min(mn, bk)
    _plan_parallel(n, off, bk, t, steps)
    done = 0
    while done < mn:
        width = int((float(m - done - bk) * float(bk) * (1.0 - t)
                     / float(m - done) + float(w - done - bk)) / t)
        if min(_round_up(width), mn - done - bk) < bk:
            shrink = int((1.0 - math.sqrt(1.0 - 1.0 / t))
                         * float(w - done + bk))
            next_bk = min((shrink + GEMM_UNROLL_N) // GEMM_UNROLL_N
                          * GEMM_UNROLL_N, bk)
        if done + bk < w:
            steps.append((UPDATE, off + done, bk, off + done + bk, off + w))
        done += bk
        bk = min(mn - done, next_bk)
        if bk > 0:
            _plan_single(n, off + done, bk, steps)


@functools.lru_cache(maxsize=None)
def lu_plan(n: int, cpu: int = OPENBLAS_THREADS) -> tuple:
    """OpenBLAS's sgetrf of an [n, n] system on ``cpu`` threads as steps in
    order: ``(GETF2, off, w, 0, 0)`` factors columns [off, off + w) of rows
    [off, n); ``(UPDATE, r0, k, c0, c1)`` applies the panel [r0, r0 + k)
    to columns [c0, c1) (``strsm`` on its rows, then ``sgemm`` below).
    ``csrc/lu_solve.cu`` runs the same steps."""
    steps: list = []
    t = sgetrf_threads(n, cpu)
    if t == 1:
        _plan_single(n, 0, n, steps)
    else:
        _plan_parallel(n, 0, n, t, steps)
    return tuple(steps)


@np.errstate(all="ignore")  # NaN and inf round as they are
def _fma_np(p: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 ``p + c`` rounded once (``p`` an exact float64 product of
    two float32 values, ``c`` float32 values in float64): the float64 sum
    rounded to float32, which is the fused result unless that sum was
    inexact and fell on a float32 halfway point or below float32's normal
    range; those entries are rounded to odd in float64 first."""
    s = p + c
    bits = s.view(np.int64)
    suspect = ((bits & 0x1FFFFFFF) == 0x10000000) | (
        (bits & 0x7FF0000000000000) < 0x3810000000000000)
    if np.count_nonzero(suspect & (s != 0)):
        v = s - p
        err = (p - (s - v)) + (c - v)
        odd = (err != 0) & ((bits & 1) == 0) & np.isfinite(s)
        s = np.where(odd, np.nextafter(s, err * np.inf), s)
    return s.astype(np.float32)


def _chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` ([r, k] x [k, c], float32) as OpenBLAS's sgemm, sgemv and
    strsm kernels sum it: each entry one FMA chain over k in order from +0.
    On the CPU in numpy (exact float64 products, ``_fma_np``)."""
    if a.device.type != "cpu":
        acc = a.new_zeros(a.shape[0], b.shape[1])
        for k in range(a.shape[1]):
            acc = xf.fma(a[:, k:k + 1], b[k:k + 1, :], acc)
        return acc
    a64 = a.numpy().astype(np.float64)
    b64 = b.numpy().astype(np.float64)
    acc = np.zeros((a.shape[0], b.shape[1]))
    with np.errstate(all="ignore"):
        for k in range(a.shape[1]):
            acc = _fma_np(np.multiply.outer(a64[:, k], b64[k]), acc) \
                .astype(np.float64)
    return torch.from_numpy(acc.astype(np.float32))


def _fms(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``c - x * y`` rounded once (strsm's in-block steps)."""
    if c.device.type != "cpu":
        return xf.fma(-x, y, c)
    x, y = torch.broadcast_tensors(x, y)
    with np.errstate(all="ignore"):
        p = x.numpy().astype(np.float64) * y.numpy().astype(np.float64)
    return torch.from_numpy(_fma_np(-p, c.numpy().astype(np.float64)))


def trsm_blocks(n: int) -> list[tuple[int, int]]:
    """The row blocks [lo, hi) of strsm's kernels on n rows, top to
    bottom."""
    blocks = [(lo, lo + TRSM_ROWS) for lo in range(0, n - TRSM_ROWS + 1,
                                                   TRSM_ROWS)]
    lo = len(blocks) * TRSM_ROWS
    size = TRSM_ROWS // 2
    while size:
        if (n - lo) & size:
            blocks.append((lo, lo + size))
            lo += size
        size //= 2
    return blocks


def _trsm_lower_unit(lo_tri: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` [k, c] solved by the unit lower triangle of ``lo_tri`` [k, k]
    as strsm's LT kernel: by row blocks (``trsm_blocks``) top to bottom,
    each block first minus the earlier rows' chain (``_chain``), then
    each solved row's update fused into the block's rows after it."""
    x = x.clone()
    for lo, hi in trsm_blocks(x.shape[0]):
        if lo:
            x[lo:hi] = x[lo:hi] - _chain(lo_tri[lo:hi, :lo], x[:lo])
        for i in range(lo, hi - 1):
            x[i + 1:hi] = _fms(x[i], lo_tri[i + 1:hi, i, None], x[i + 1:hi])
    return x


def _trsm_upper(up_tri: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` [k, c] solved by the upper triangle of ``up_tri`` [k, k] as
    strsm's LN kernel: the same row blocks bottom to top, each first minus
    the later rows' chain, then from its last row up: the unknown times
    the pivot's rounded reciprocal, its update fused into the rows
    above it in the block."""
    x = x.clone()
    n = x.shape[0]
    for lo, hi in reversed(trsm_blocks(n)):
        if hi < n:
            x[lo:hi] = x[lo:hi] - _chain(up_tri[lo:hi, hi:], x[hi:])
        for i in reversed(range(lo, hi)):
            x[i] = x[i] * (1.0 / up_tri[i, i])
            if i > lo:
                x[lo:i] = _fms(x[i], up_tri[lo:i, i, None], x[lo:i])
    return x


def _sdot_strided(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``sdot`` of a row (stride lda) with a column: fused pairs
    ``fma(x0, y0, x1*y1)`` in float32, added in order in float64 from 0,
    a last odd product rounded, the total rounded to float32."""
    i = x.shape[0]
    h = i // 2
    terms = []
    if h:
        pairs = xf.fma(x[0:2 * h:2], y[0:2 * h:2],
                       x[1:2 * h:2] * y[1:2 * h:2])
        terms = list(pairs.double().unbind(0))
    if i % 2:
        terms.append((x[i - 1] * y[i - 1]).double())
    acc = torch.zeros((), dtype=torch.float64, device=x.device)
    for t in terms:
        acc = acc + t
    return acc.float()


def _gemv_sub(a: torch.Tensor, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """``y - a x`` ([m, j] columns, j <= 48) as ``sgemv_n`` computes it in
    ``getf2``: one chain per row, subtracted; at j = 4 its 4x4 kernel
    sums the first (m - m % 4) % 16 rows as the chains (from +0) of
    columns (0, 2) and (1, 3), added, then subtracted."""
    j = a.shape[1]
    if j != 4:
        return y - _chain(a, x[:, None])[:, 0]
    m = a.shape[0]
    split = (m - m % 4) % 16
    out = y - _chain(a, x[:, None])[:, 0]
    if split:
        s, zero = a[:split], a.new_zeros(split)
        even = xf.fma(s[:, 2], x[2], xf.fma(s[:, 0], x[0], zero))
        odd = xf.fma(s[:, 3], x[3], xf.fma(s[:, 1], x[1], zero))
        out[:split] = y[:split] - (odd + even)
    return out


def _getf2(lu: torch.Tensor, perm: torch.Tensor, off: int, w: int):
    """OpenBLAS's ``getf2`` on columns [off, off + w) of rows [off, n)
    (w <= 48), row swaps applied to whole rows. The pivot is the first
    largest magnitude (a NaN never wins, where isamax's vector code
    differs); nothing is read back to the host."""
    n = lu.shape[-1]
    for j in range(w):
        c = off + j
        for i in range(1, j):
            lu[off + i, c] = lu[off + i, c] - _sdot_strided(
                lu[off + i, off:off + i], lu[off:off + i, c])
        if j:
            lu[c:, c] = _gemv_sub(lu[c:, off:c], lu[off:c, c], lu[c:, c])
        mag = torch.abs(lu[c:, c])
        jp = c + torch.argmax(torch.where(torch.isnan(mag), -1.0, mag))
        idx = torch.stack([torch.full_like(jp, c), jp])
        old = lu.index_select(0, idx)
        new = old.flip(0)
        pivot = new[0, c]
        normal = (pivot != 0) & (torch.abs(pivot) >= FLT_MIN)
        new[:, off:c + 1] = torch.where(normal, new[:, off:c + 1],
                                        old[:, off:c + 1])
        lu.index_copy_(0, idx, new)
        perm.index_copy_(0, idx, perm.index_select(0, idx).flip(0))
        if c + 1 < n:
            below = lu[c + 1:, c]
            lu[c + 1:, c] = torch.where(normal, below * (1.0 / pivot), below)


def lu_factor(a: torch.Tensor):
    """OpenBLAS's ``sgetrf`` of a float32 [n, n] at OPENBLAS_THREADS
    threads, bit for bit: ``lu_plan``'s steps (``_getf2``, and for each
    panel ``_trsm_lower_unit`` and ``_chain`` on the columns to its right).
    Returns the packed factors and the row permutation (tensors on ``a``'s
    device, nothing read back). ``csrc/lu_solve.cu`` computes the same on
    the card."""
    n = a.shape[-1]
    lu = a.clone()
    perm = torch.arange(n, device=a.device)
    for op, p, q, r, s in lu_plan(n):
        if op == GETF2:
            _getf2(lu, perm, p, q)
            continue
        u12 = _trsm_lower_unit(lu[p:p + q, p:p + q], lu[p:p + q, r:s])
        lu[p:p + q, r:s] = u12
        lu[p + q:, r:s] = lu[p + q:, r:s] - _chain(lu[p + q:, p:p + q], u12)
    return lu, perm


def _solve_blocks(n: int, upper: bool) -> list[tuple[int, int]]:
    """strsm's blocks of GEMM_Q rows [s, e) in the order it solves them:
    from the top for the lower triangle, from the bottom for the upper."""
    if not upper:
        return [(s, min(s + GEMM_Q, n)) for s in range(0, n, GEMM_Q)]
    return [(max(e - GEMM_Q, 0), e) for e in range(n, 0, -GEMM_Q)]


def lu_solve(lu: torch.Tensor, perm: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` (b [n] or [n, k]) from ``lu_factor`` as
    OpenBLAS's two ``strsm`` calls compute it: the unit lower, then the
    upper triangle, by blocks of GEMM_Q rows (``_solve_blocks``), each
    solved by the kernel (``_trsm_lower_unit``, ``_trsm_upper``) and then
    taken from the rows after it as one chain. ``csrc/lu_solve.cu``
    computes the same on the card."""
    n = lu.shape[-1]
    vector = b.dim() == 1
    x = b.index_select(0, perm)
    x = x[:, None] if vector else x.clone()
    for s, e in _solve_blocks(n, upper=False):
        x[s:e] = _trsm_lower_unit(lu[s:e, s:e], x[s:e])
        if e < n:
            x[e:] = x[e:] - _chain(lu[e:, s:e], x[s:e])
    for s, e in _solve_blocks(n, upper=True):
        x[s:e] = _trsm_upper(lu[s:e, s:e], x[s:e])
        if s:
            x[:s] = x[:s] - _chain(lu[:s, s:e], x[s:e])
    return x[:, 0] if vector else x


def lu_inverse(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.inv`` of a float32 [n, n] (n = 2 or 3) as XLA:CPU
    computes it: ``lu_factor``, then ``lu_solve`` of the identity."""
    lu, perm = lu_factor(a)
    return lu_solve(lu, perm, torch.eye(a.shape[-1], dtype=a.dtype,
                                        device=a.device))


def _gain(pct: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """K = P D^T S^-1 ([nd, m] x [m, m]) in float32: in-order FMA chains,
    except that for a pose update (m = 3) XLA vectorized the rows eight
    at a time and left the products of columns 0 and 1 unfused there
    (``(p0 + p1) + p2``); the last nd mod 8 rows are chains."""
    k = xf.matmul(pct, inv)
    if inv.shape[-1] != 3:
        return k
    nv = (pct.shape[0] // 8) * 8
    prod = pct[:nv, :, None] * inv[None, :, :2]
    plain = (prod[:, 0] + prod[:, 1]) + prod[:, 2]
    return torch.cat([torch.cat([plain, k[:nv, 2:]], dim=1), k[nv:]])


def _block_index(delay_step, n_blocks: int, dim_x: int,
                 device) -> torch.Tensor:
    """Indices of state block ``delay_step``, computed on the device as
    ``lax.dynamic_slice`` places its slice: a negative block wraps once,
    then the block is clamped into the register."""
    step = torch.as_tensor(delay_step, device=device)
    step = torch.where(step < 0, step + n_blocks, step)
    step = torch.clamp(step, 0, n_blocks - 1)
    return step * dim_x + torch.arange(dim_x, device=device)


def update_with_delay(state: TimeDelayState, y: torch.Tensor,
                      c_mat: torch.Tensor, r: torch.Tensor,
                      delay_step, dim_x: int) -> TimeDelayState:
    """Apply the measurement y = C x(t - delay_step) + v, with
    P D^T = P[:, s:s+d] C^T and D P D^T = C P[s:s+d, s:s+d] C^T."""
    nd = state.x.shape[0]
    idx = _block_index(delay_step, nd // dim_x, dim_x, state.x.device)

    p_cols = state.p.index_select(1, idx)                   # P[:, s:s+d]
    pct = p_cols @ c_mat.T                                  # [nd, m]
    p_block = p_cols.index_select(0, idx)                   # P[s:s+d, s:s+d]
    innov_cov = r + c_mat @ p_block @ c_mat.T               # [m, m]
    x_at = state.x.index_select(0, idx)
    innovation = y - c_mat @ x_at
    if xf._float32(state.p, c_mat, r) and innov_cov.shape[-1] in (2, 3):
        # The selections above are exact; the gain, the state and the
        # covariance in the reference's forms.
        k = _gain(pct, lu_inverse(innov_cov))
        x1 = state.x + xf.dot(k, innovation)
        p1 = state.p - xf.matmul(k, pct.T)
        return TimeDelayState(x=x1, p=p1)
    k = pct @ torch.linalg.inv_ex(innov_cov).inverse        # [nd, m]
    x1 = state.x + k @ innovation
    # P <- P - K D P;  D P = (P D^T)^T by symmetry of P.
    p1 = state.p - k @ pct.T
    return TimeDelayState(x=x1, p=p1)


def latest(state: TimeDelayState, dim_x: int):
    """Newest state block and its covariance."""
    return state.x[:dim_x], state.p[:dim_x, :dim_x]


def state_at(state: TimeDelayState, delay_step, dim_x: int):
    """State block ``delay_step`` steps in the past (clamped into the
    register)."""
    nd = state.x.shape[0]
    return state.x.index_select(
        0, _block_index(delay_step, nd // dim_x, dim_x, state.x.device))
