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
"""

from __future__ import annotations

from typing import NamedTuple

import torch


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
    top = torch.cat([a @ bb @ a.T + q, a @ bc], dim=1)
    bot = torch.cat([cb @ a.T, cc], dim=1)
    return TimeDelayState(x=x1, p=torch.cat([top, bot], dim=0))


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
    k = pct @ torch.linalg.inv_ex(innov_cov).inverse        # [nd, m]

    x_at = state.x.index_select(0, idx)
    x1 = state.x + k @ (y - c_mat @ x_at)
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
