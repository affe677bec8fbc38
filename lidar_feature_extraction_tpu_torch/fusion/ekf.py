"""2D-dynamics EKF for LiDAR pose fusion (the ekf_localizer equivalent).

Port of ``lidar_feature_extraction_tpu/fusion/ekf.py:1-218``. State
[x, y, yaw, yaw_bias, vx, wz]:

- bicycle-model predict with its analytic Jacobian and process noise;
- delayed pose (x, y, yaw) and twist (vx, wz) measurements behind a
  Mahalanobis gate: an update that fails the gate, or is not finite,
  leaves the state as it was (``torch.where`` keep-or-replace, no host
  read);
- the time-delay filter of ``fusion/kalman.py``;
- scalar filters for z / roll / pitch (``Filter1D``).

The state lives on the device of the tensors it was made from (the
card, unless the caller asks for the CPU); the queues and clocks are
the host's (``pipeline/``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_feature_extraction_tpu_torch.config import EkfConfig
from lidar_feature_extraction_tpu_torch.fusion import kalman

DIM_X = 6
IDX_X, IDX_Y, IDX_YAW, IDX_YAWB, IDX_VX, IDX_WZ = range(6)


def normalize_yaw(yaw):
    """atan2(sin, cos) wrap."""
    return torch.atan2(torch.sin(yaw), torch.cos(yaw))


def predict_next_state(x, dt):
    """Nonlinear bicycle-model step."""
    yaw = x[IDX_YAW] + x[IDX_YAWB]
    return torch.stack([
        x[IDX_X] + x[IDX_VX] * torch.cos(yaw) * dt,
        x[IDX_Y] + x[IDX_VX] * torch.sin(yaw) * dt,
        normalize_yaw(x[IDX_YAW] + x[IDX_WZ] * dt),
        x[IDX_YAWB],
        x[IDX_VX],
        x[IDX_WZ],
    ])


def state_transition_matrix(x, dt):
    """Analytic 6x6 Jacobian A of ``predict_next_state``."""
    yaw = x[IDX_YAW] + x[IDX_YAWB]
    vx = x[IDX_VX]
    a = torch.eye(DIM_X, dtype=x.dtype, device=x.device)
    a[IDX_X, IDX_YAW] = -vx * torch.sin(yaw) * dt
    a[IDX_X, IDX_YAWB] = -vx * torch.sin(yaw) * dt
    a[IDX_X, IDX_VX] = torch.cos(yaw) * dt
    a[IDX_Y, IDX_YAW] = vx * torch.cos(yaw) * dt
    a[IDX_Y, IDX_YAWB] = vx * torch.cos(yaw) * dt
    a[IDX_Y, IDX_VX] = torch.sin(yaw) * dt
    a[IDX_YAW, IDX_WZ] = dt
    return a


def process_noise(variances, dtype=torch.float32,
                  device="cuda") -> torch.Tensor:
    """diag(0, 0, q_yaw, q_yawb, q_vx, q_wz) of the four variances (a
    sequence or a tensor) in ``dtype`` on ``device``: x and y get no
    direct process noise."""
    v = torch.as_tensor(variances, dtype=dtype, device=device)
    return torch.diag(torch.cat([v.new_zeros(2), v]))


def squared_mahalanobis(x, y, cov):
    d = x - y
    return d @ torch.linalg.solve_ex(cov, d).result


class EkfState(NamedTuple):
    td: kalman.TimeDelayState


def init_ekf(cfg: EkfConfig, x0=None, p0=None, pose_cov=(1e4, 1e4, 1e2),
             dtype=torch.float32, device="cuda") -> EkfState:
    """Initial state and covariance: pose entries from the initial-pose
    covariance, yaw_bias variance 1e-4, vx and wz 1e-2. ``x0`` / ``p0``
    given as tensors keep their device."""
    if x0 is None:
        x0 = torch.zeros(DIM_X, dtype=dtype, device=device)
    if p0 is None:
        p0 = torch.diag(torch.tensor(
            [pose_cov[0], pose_cov[1], pose_cov[2], 1e-4, 1e-2, 1e-2],
            dtype=x0.dtype, device=x0.device))
    return EkfState(td=kalman.init_time_delay(x0, p0, cfg.extend_state_step))


def predict(state: EkfState, dt: float, cfg: EkfConfig) -> EkfState:
    """One timer tick: nonlinear predict through the shift register."""
    x = state.td.x
    x_curr = x[:DIM_X]
    x_next = predict_next_state(x_curr, dt)
    a = state_transition_matrix(x_curr, dt)
    yaw_bias_var = ((cfg.proc_stddev_yaw_bias_c * dt) ** 2
                    if cfg.enable_yaw_bias_estimation else 0.0)
    q = process_noise([(cfg.proc_stddev_yaw_c * dt) ** 2, yaw_bias_var,
                       (cfg.proc_stddev_vx_c * dt) ** 2,
                       (cfg.proc_stddev_wz_c * dt) ** 2],
                      dtype=x.dtype, device=x.device)
    return EkfState(td=kalman.predict_with_delay(state.td, x_next, a, q))


def _selector(rows, like: torch.Tensor) -> torch.Tensor:
    """Measurement matrix picking the state entries ``rows``."""
    c = torch.zeros((len(rows), DIM_X), dtype=like.dtype, device=like.device)
    c[range(len(rows)), list(rows)] = 1.0
    return c


def _gated_update(state: EkfState, y, r, delay_step, cfg: EkfConfig,
                  rows, gate_dist: float) -> EkfState:
    """The delayed update of the entries ``rows``, kept only when the
    measurement passes the Mahalanobis gate, the delay lies inside the
    register and the result is finite."""
    td = state.td
    dev = td.x.device
    c = _selector(rows, td.x)
    idx = torch.tensor(rows, device=dev)
    y_ekf = kalman.state_at(td, delay_step, DIM_X).index_select(0, idx)
    p_y = td.p.index_select(0, idx).index_select(1, idx)
    md2 = squared_mahalanobis(y_ekf, y, p_y)
    step = torch.as_tensor(delay_step, device=dev)
    ok = ((md2 <= gate_dist ** 2) & torch.all(torch.isfinite(y))
          & (step < cfg.extend_state_step) & (step >= 0))
    new = kalman.update_with_delay(td, y, c, r, step, DIM_X)
    ok = ok & torch.all(torch.isfinite(new.x)) & torch.all(
        torch.isfinite(new.p))
    return EkfState(td=kalman.TimeDelayState(
        x=torch.where(ok, new.x, td.x), p=torch.where(ok, new.p, td.p)))


def update_pose(state: EkfState, y: torch.Tensor, r: torch.Tensor,
                delay_step, cfg: EkfConfig) -> EkfState:
    """Delayed (x, y, yaw) update behind the Mahalanobis gate. ``r`` is
    the 3x3 measurement covariance, already scaled by the smoothing
    steps."""
    y = torch.cat([y[:2], normalize_yaw(y[2:3])])
    return _gated_update(state, y, r, delay_step, cfg,
                         (IDX_X, IDX_Y, IDX_YAW), cfg.pose_gate_dist)


def update_twist(state: EkfState, y: torch.Tensor, r: torch.Tensor,
                 delay_step, cfg: EkfConfig) -> EkfState:
    """Delayed (vx, wz) update behind the Mahalanobis gate."""
    return _gated_update(state, y, r, delay_step, cfg, (IDX_VX, IDX_WZ),
                         cfg.twist_gate_dist)


def current_pose_twist(state: EkfState):
    """(x, y, unbiased yaw), (vx, wz) and the 6x6 covariance of the
    newest state."""
    x, p = kalman.latest(state.td, DIM_X)
    pose = torch.stack([x[IDX_X], x[IDX_Y],
                        normalize_yaw(x[IDX_YAW] + x[IDX_YAWB])])
    twist = torch.stack([x[IDX_VX], x[IDX_WZ]])
    return pose, twist, p


class Filter1D(NamedTuple):
    """Scalar Kalman filter for z / roll / pitch; ``initialized`` is part
    of the state, so an update reads nothing back."""

    x: torch.Tensor
    stddev: torch.Tensor
    proc_stddev: torch.Tensor
    initialized: torch.Tensor

    @staticmethod
    def create(proc_stddev=0.0, dtype=torch.float32,
               device="cuda") -> "Filter1D":
        f = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
        return Filter1D(x=f(0.0), stddev=f(1e9), proc_stddev=f(proc_stddev),
                        initialized=torch.zeros((), dtype=torch.bool,
                                                device=device))


def filter1d_update(f: Filter1D, obs, obs_stddev, dt) -> Filter1D:
    proc = f.proc_stddev * dt
    pred_std = torch.sqrt(f.stddev ** 2 + proc ** 2)
    gain = pred_std ** 2 / (pred_std ** 2 + obs_stddev ** 2)
    x_new = f.x + gain * (obs - f.x)
    std_new = torch.sqrt(1 - gain) * pred_std
    init = f.initialized
    return Filter1D(
        x=torch.where(init, x_new, obs),
        stddev=torch.where(init, std_new, obs_stddev),
        proc_stddev=f.proc_stddev,
        initialized=torch.ones_like(init))
