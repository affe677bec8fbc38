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

from typing import NamedTuple

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


def lu_factor(a: torch.Tensor):
    """OpenBLAS's ``sgetrf`` of a float32 [n, n] as its unblocked
    left-looking ``getf2`` computes it: each entry's updates as one dot
    product (the first product rounded, the rest fused in ascending
    order), then subtracted; the pivot the first largest magnitude (a
    NaN never wins); the column below it scaled by the pivot's rounded
    reciprocal (not when the pivot is 0). Returns the packed factors and
    the row permutation (tensors on ``a``'s device, nothing read back).

    The dot products are carried as running sums, one rank-1 step per
    column (``acc``), which adds each entry's products in the same
    order as the column-by-column dots. Equal to the reference's bits at
    n = 2 and 3 (the EKF's); above OpenBLAS's blocking threshold its
    ``sgetrf`` recurses into panels whose trailing updates its ``sgemm``
    kernel sums by blocks (ROADMAP §C23), which this does not follow.
    ``csrc/lu_solve.cu`` computes the same on the card."""
    n = a.shape[-1]
    lu = a.clone()
    acc = torch.zeros_like(a)
    rows = torch.arange(n, device=a.device)
    perm = rows
    for j in range(n):
        if j:
            lu[j:, j] = lu[j:, j] - acc[j:, j]
        mag = torch.abs(lu[j:, j])
        jp = j + torch.argmax(torch.where(torch.isnan(mag), -1.0, mag))
        swap = torch.where(rows == j, jp, torch.where(rows == jp, j, rows))
        lu, acc = lu.index_select(0, swap), acc.index_select(0, swap)
        perm = perm.index_select(0, swap)
        pivot = lu[j, j]
        below = lu[j + 1:, j]
        lu[j + 1:, j] = torch.where(pivot != 0, below * (1.0 / pivot), below)
        if j:
            lu[j, j + 1:] = lu[j, j + 1:] - acc[j, j + 1:]
        l_col, u_row = lu[j + 1:, j, None], lu[None, j, j + 1:]
        acc[j + 1:, j + 1:] = l_col * u_row if j == 0 else xf.fma(
            l_col, u_row, acc[j + 1:, j + 1:])
    return lu, perm


# OpenBLAS's trsm kernels solve a block of rows of this many, then the
# rest in blocks of 8, 4, 2 and 1 rows (the remainder's bits, largest
# first).
TRSM_ROWS = 16


def trsm_blocks(n: int) -> list[tuple[int, int]]:
    """The row blocks [lo, hi) of ``lu_solve``, top to bottom."""
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


def _subtract_dot(x: torch.Tensor, lu: torch.Tensor, lo: int, hi: int,
                  ks: range) -> torch.Tensor:
    """Rows lo:hi of ``x`` minus the dot products of ``lu[lo:hi, ks]``
    with ``x[ks]``: the first product rounded, the rest fused in the
    order of ``ks``."""
    k0, *rest = ks
    acc = lu[lo:hi, k0, None] * x[k0]
    for k in rest:
        acc = xf.fma(lu[lo:hi, k, None], x[k], acc)
    return x[lo:hi] - acc


def lu_solve(lu: torch.Tensor, perm: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` (b [n] or [n, k]) from ``lu_factor`` as
    OpenBLAS's two ``strsm`` calls compute it: the unit lower, then the
    upper triangle, by blocks of rows (``trsm_blocks``); within a block
    a solved row's updates fused into the rows after it, the earlier
    blocks' as one dot product per row (``_subtract_dot``, ascending),
    and each unknown multiplied by its pivot's rounded reciprocal.
    Equal to the reference's bits at n = 2 and 3 (ROADMAP §C23 for
    more); ``csrc/lu_solve.cu`` computes the same on the card."""
    n = lu.shape[-1]
    vector = b.dim() == 1
    x = b.index_select(0, perm)
    x = x[:, None] if vector else x.clone()
    blocks = trsm_blocks(n)
    for lo, hi in blocks:
        if lo:
            x[lo:hi] = _subtract_dot(x, lu, lo, hi, range(lo))
        for i in range(lo, hi - 1):
            x[i + 1:hi] = xf.fma(-x[i], lu[i + 1:hi, i, None], x[i + 1:hi])
    for lo, hi in reversed(blocks):
        if hi < n:
            x[lo:hi] = _subtract_dot(x, lu, lo, hi, range(hi, n))
        for i in reversed(range(lo, hi)):
            x[i] = x[i] * (1.0 / lu[i, i])
            if i > lo:
                x[lo:i] = xf.fma(-x[i], lu[lo:i, i, None], x[lo:i])
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
