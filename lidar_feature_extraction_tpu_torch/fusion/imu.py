"""On-manifold IMU preintegration (Forster et al., TRO 2017 style).

Port of ``lidar_feature_extraction_tpu/fusion/imu.py``. The reference
integrates a sample window in one ``lax.scan``; here the same step runs
as a Python loop over the samples on the window's device, masked lanes
included (they are computed and discarded, as the scan does). The terms
that depend on one sample only (bias-corrected rates, the step rotation,
its right Jacobian, the noise scales) are computed for the whole window
before the loop.

State deltas between body times i and j (gravity-free, body frame of i):
  dq: rotation,  dv: velocity delta,  dp: position delta.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.core import quaternion as quat

# Plain numpy; consumers cast to their operand dtype and device.
GRAVITY = np.asarray([0.0, 0.0, -9.80665])


class ImuPreintegration(NamedTuple):
    dq: torch.Tensor       # [4] preintegrated rotation (wxyz)
    dv: torch.Tensor       # [3] preintegrated velocity delta
    dp: torch.Tensor       # [3] preintegrated position delta
    dt: torch.Tensor       # scalar total time
    # Bias-correction Jacobians (first-order, at the linearization bias).
    dq_dbg: torch.Tensor   # [3, 3] d(log dq)/d(gyro bias)
    dv_dbg: torch.Tensor   # [3, 3]
    dv_dba: torch.Tensor   # [3, 3]
    dp_dbg: torch.Tensor   # [3, 3]
    dp_dba: torch.Tensor   # [3, 3]
    cov: torch.Tensor      # [9, 9] (theta, v, p) covariance


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def preintegrate(gyro: torch.Tensor, accel: torch.Tensor, dts: torch.Tensor,
                 gyro_bias, accel_bias, valid: torch.Tensor | None = None,
                 gyro_noise: float = 1.7e-4,
                 accel_noise: float = 2.0e-3) -> ImuPreintegration:
    """Integrate an IMU sample window into one relative-motion factor.

    gyro, accel: [N, 3] raw measurements; dts: [N] per-sample intervals;
    ``valid`` masks padding lanes. Noise densities are continuous-time
    (rad/s/sqrt(Hz), m/s^2/sqrt(Hz)). Every operand is pinned to the
    measurement's dtype and device."""
    n = gyro.shape[0]
    dtype, dev = gyro.dtype, gyro.device
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool, device=dev))
    accel = _as(accel, gyro)
    dts = torch.where(valid, _as(dts, gyro), 0.0)
    w = gyro - _as(gyro_bias, gyro)
    a = accel - _as(accel_bias, gyro)

    # Per-sample terms, all samples at once.
    theta = w * dts[:, None]
    dq_step = quat.exp_so3(theta)
    r_step_t = quat.quat_to_matrix(dq_step).transpose(-1, -2)
    jr = _so3_right_jacobian(theta)
    hat_a = quat.hat(a)
    dt_safe = torch.clamp_min(dts, 1e-9)
    g_sq = gyro_noise * gyro_noise / dt_safe
    a_sq = accel_noise * accel_noise / dt_safe
    eye = torch.eye(3, dtype=dtype, device=dev)
    zero = torch.zeros((3, 3), dtype=dtype, device=dev)
    z_n = torch.zeros((n, 3, 3), dtype=dtype, device=dev)
    q_cont = torch.cat([
        torch.cat([eye * g_sq[:, None, None], z_n], dim=-1),
        torch.cat([z_n, eye * a_sq[:, None, None]], dim=-1)], dim=-2)
    jr_dt = jr * dts[:, None, None]

    dq = quat.quat_identity(dtype, dev)
    dv = torch.zeros(3, dtype=dtype, device=dev)
    dp = torch.zeros(3, dtype=dtype, device=dev)
    dq_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba = (
        torch.zeros((3, 3), dtype=dtype, device=dev) for _ in range(5))
    cov = torch.zeros((9, 9), dtype=dtype, device=dev)
    for k in range(n):
        dt, ok = dts[k], valid[k]
        r = quat.quat_to_matrix(dq)
        # Plain rotations: the reference's loop is a jitted lax.scan,
        # whose float32 forms are not read yet (ROADMAP §C24).
        a_rot = quat.quat_rotate(dq, a[k], plain=True)
        dp_new = dp + dv * dt + 0.5 * a_rot * dt * dt
        dv_new = dv + a_rot * dt
        dq_new = quat.quat_normalize(quat.quat_multiply(dq, dq_step[k]))

        r_hat_a = r @ hat_a[k]
        dq_dbg_new = r_step_t[k] @ dq_dbg - jr_dt[k]
        dv_dbg_new = dv_dbg - r_hat_a @ dq_dbg * dt
        dv_dba_new = dv_dba - r * dt
        dp_dbg_new = dp_dbg + dv_dbg * dt - 0.5 * r_hat_a @ dq_dbg * dt * dt
        dp_dba_new = dp_dba + dv_dba * dt - 0.5 * r * dt * dt

        a_mat = torch.cat([
            torch.cat([r_step_t[k], zero, zero], dim=-1),
            torch.cat([-r_hat_a * dt, eye, zero], dim=-1),
            torch.cat([-0.5 * r_hat_a * dt * dt, eye * dt, eye], dim=-1),
        ], dim=-2)
        noise = torch.cat([
            torch.cat([jr_dt[k], zero], dim=-1),
            torch.cat([zero, r * dt], dim=-1),
            torch.cat([zero, 0.5 * r * dt * dt], dim=-1),
        ], dim=-2)
        cov_new = a_mat @ cov @ a_mat.T + noise @ q_cont[k] @ noise.T

        dq = torch.where(ok, dq_new, dq)
        dv = torch.where(ok, dv_new, dv)
        dp = torch.where(ok, dp_new, dp)
        dq_dbg = torch.where(ok, dq_dbg_new, dq_dbg)
        dv_dbg = torch.where(ok, dv_dbg_new, dv_dbg)
        dv_dba = torch.where(ok, dv_dba_new, dv_dba)
        dp_dbg = torch.where(ok, dp_dbg_new, dp_dbg)
        dp_dba = torch.where(ok, dp_dba_new, dp_dba)
        cov = torch.where(ok, cov_new, cov)
    return ImuPreintegration(dq=dq, dv=dv, dp=dp, dt=torch.sum(dts),
                             dq_dbg=dq_dbg, dv_dbg=dv_dbg, dv_dba=dv_dba,
                             dp_dbg=dp_dbg, dp_dba=dp_dba, cov=cov)


def _so3_right_jacobian(theta: torch.Tensor, eps: float = 1e-8):
    """Right Jacobian of SO(3), J_r(theta) [..., 3, 3], closed form with a
    small-angle guard (series to second order)."""
    t = quat._norm(theta)[..., None, None]
    hat = quat.hat(theta)
    hat2 = hat @ hat
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    small = t < eps
    t_safe = torch.where(small, 1.0, t)
    c1 = torch.where(small, 0.5, (1 - torch.cos(t_safe)) / (t_safe * t_safe))
    c2 = torch.where(small, 1.0 / 6.0,
                     (t_safe - torch.sin(t_safe)) / (t_safe ** 3))
    return eye - c1 * hat + c2 * hat2


def predict_state(q, t, v, pre: ImuPreintegration, gravity=GRAVITY):
    """Dead-reckon a world-frame state (q, t, v) through a preintegrated
    window: the IMU-aided Gauss-Newton prior (``imu_factor_residual``
    is zero at exactly this prediction)."""
    dt = pre.dt
    gravity = _as(gravity, t)
    t_new = t + v * dt + 0.5 * gravity * dt * dt \
        + quat.quat_rotate(q, pre.dp)
    v_new = v + gravity * dt + quat.quat_rotate(q, pre.dv)
    q_new = quat.quat_normalize(quat.quat_multiply(q, pre.dq))
    return q_new, t_new, v_new


def synthesize_imu(poses_q, poses_t, dt: float, gravity=GRAVITY):
    """Ideal IMU measurements from a pose sequence [N, 4] / [N, 3]
    sampled every ``dt`` seconds (gyro = body rates from finite rotation
    deltas, accel = specific force from second differences). Returns
    (gyro [N-1, 3], accel [N-1, 3], dts [N-1], vel0 [3]); sample k covers
    the interval k -> k+1 (zeroth-order hold)."""
    q, t = poses_q, poses_t
    gravity = _as(gravity, t)
    n = q.shape[0]
    rel = quat.quat_multiply(quat.quat_conjugate(q[:-1]), q[1:])
    gyro = quat.log_so3(rel) / dt
    v = (t[1:] - t[:-1]) / dt                        # [N-1, 3] v_{k+1/2}
    a_w = torch.diff(v, dim=0, append=v[-1:]) / dt   # [N-1, 3]
    accel = quat.quat_rotate(quat.quat_conjugate(q[:-1]), a_w - gravity)
    dts = torch.full((n - 1,), dt, dtype=t.dtype, device=t.device)
    return gyro, accel, dts, v[0]


class ImuFactorResidual(NamedTuple):
    r_theta: torch.Tensor  # [3]
    r_v: torch.Tensor      # [3]
    r_p: torch.Tensor      # [3]


def imu_factor_residual(pre: ImuPreintegration, qi, pi, vi, qj, pj, vj,
                        delta_bg=None, delta_ba=None,
                        gravity=GRAVITY) -> ImuFactorResidual:
    """Preintegration residual between keyframe states i and j (world
    orientation q, position p, velocity v), corrected to first order by
    the bias deltas ``delta_bg`` / ``delta_ba`` when given."""
    dt = pre.dt
    gravity = _as(gravity, pi)
    dq, dv, dp = pre.dq, pre.dv, pre.dp
    if delta_bg is not None:
        dq = quat.quat_multiply(dq, quat.exp_so3(pre.dq_dbg @ delta_bg))
        dv = dv + pre.dv_dbg @ delta_bg
        dp = dp + pre.dp_dbg @ delta_bg
    if delta_ba is not None:
        dv = dv + pre.dv_dba @ delta_ba
        dp = dp + pre.dp_dba @ delta_ba

    qi_inv = quat.quat_conjugate(qi)
    rel_q = quat.quat_multiply(qi_inv, qj)
    r_theta = quat.log_so3(quat.quat_multiply(quat.quat_conjugate(dq), rel_q))
    r_v = quat.quat_rotate(qi_inv, vj - vi - gravity * dt) - dv
    r_p = quat.quat_rotate(
        qi_inv, pj - pi - vi * dt - 0.5 * gravity * dt * dt) - dp
    return ImuFactorResidual(r_theta=r_theta, r_v=r_v, r_p=r_p)
