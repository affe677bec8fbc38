"""Asynchronous EKF fusion driver: the node-equivalent of the
reference's ``ekf_localizer``.

Port of ``lidar_feature_extraction_tpu/pipeline/ekf_node.py``.
``FusedLocalizationPipeline`` (``pipeline/replay.py``) is the
synchronous replay loop where queueing degenerates away; this driver
keeps the reference's asynchronous structure for deployments where
measurements arrive on their own clocks:

- ``tick`` owns predict and drains the measurement queues;
- pose / twist measurements wait in ``AgedMessageQueue``s between ticks
  and are retried for ``smoothing_steps`` ticks;
- per measurement: finite check, delay quantization against the
  measured dt, covariance scaling by the smoothing steps, then the
  delayed update with its Mahalanobis gate on the device. It is the one
  caller of the updates with ``delay_step > 0``;
- ``current_estimate`` composes the published pose: EKF (x, y, yaw) +
  the scalar filters for z / roll / pitch, and the flat-36 covariances.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.config import EkfConfig
from lidar_feature_extraction_tpu_torch.fusion import ekf as ekf_mod
from lidar_feature_extraction_tpu_torch.fusion import queues


class PoseMeasurement(NamedTuple):
    """(x, y, yaw) measurement with stamp and flat-36 covariance."""

    stamp: float
    x: float
    y: float
    yaw: float
    covariance: np.ndarray     # flat 36, row-major pose layout
    frame_id: str = "map"


class TwistMeasurement(NamedTuple):
    """(vx, wz) measurement with stamp and flat-36 covariance."""

    stamp: float
    vx: float
    wz: float
    covariance: np.ndarray     # flat 36, row-major twist layout
    frame_id: str = "base_link"


class EkfEstimate(NamedTuple):
    pose_xyyaw: np.ndarray       # [3] x, y, unbiased yaw
    z: float
    roll: float
    pitch: float
    twist: np.ndarray            # [2] vx, wz
    pose_covariance: np.ndarray  # flat 36
    twist_covariance: np.ndarray  # flat 36


class EkfNode:
    """Queue-driven EKF fusion node.

    ``push_pose`` / ``push_twist`` may be called at any time between
    ticks; ``tick(now)`` advances the filter one predict step and
    applies every queued measurement (with aging and retry), in the
    reference's timer order: predict, pose updates, twist updates,
    publish. The filter state lives on ``device``.
    """

    def __init__(self, cfg: EkfConfig, pose_frame: str = "map",
                 twist_frame: str = "base_link",
                 warn: Optional[queues.Warning] = None,
                 dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.warn = warn if warn is not None else queues.Warning()
        self.pose_frame = pose_frame
        self.twist_frame = twist_frame
        self.ekf = ekf_mod.init_ekf(cfg, dtype=dtype, device=self.device)
        self.z_filter = self._filter()
        self.roll_filter = self._filter()
        self.pitch_filter = self._filter()
        self.pose_queue = queues.AgedMessageQueue(cfg.pose_smoothing_steps)
        self.twist_queue = queues.AgedMessageQueue(
            cfg.twist_smoothing_steps)
        self.interval = queues.UpdateInterval(cfg.predict_frequency)
        self.clock: Optional[float] = None

    def _filter(self) -> ekf_mod.Filter1D:
        return ekf_mod.Filter1D.create(dtype=self.dtype, device=self.device)

    def _t(self, v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v), dtype=self.dtype,
                               device=self.device)

    # -- inputs -----------------------------------------------------------
    def push_pose(self, m: PoseMeasurement) -> None:
        if not queues.check_frame(m.frame_id, self.pose_frame, self.warn):
            return
        if not queues.check_measurement_finite(
                [m.x, m.y, m.yaw], "pose", self.warn):
            return
        self.pose_queue.push(m)

    def push_twist(self, m: TwistMeasurement) -> None:
        if not queues.check_frame(m.frame_id, self.twist_frame, self.warn):
            return
        if not queues.check_measurement_finite(
                [m.vx, m.wz], "twist", self.warn):
            return
        self.twist_queue.push(m)

    def set_initial_pose(self, x: float, y: float, yaw: float,
                         z: float = 0.0, roll: float = 0.0,
                         pitch: float = 0.0,
                         pose_cov: tuple = (1e4, 1e4, 1e2)) -> None:
        """Re-initialize from an external pose: the EKF restarts at
        (x, y, yaw), the scalar filters at z / roll / pitch, and the
        queues are flushed."""
        self.ekf = ekf_mod.init_ekf(self.cfg,
                                    x0=self._t([x, y, yaw, 0.0, 0.0, 0.0]),
                                    pose_cov=pose_cov)
        std = self._t(np.sqrt(0.1))
        one = self._t(1.0)
        for name, val in (("z_filter", z), ("roll_filter", roll),
                          ("pitch_filter", pitch)):
            setattr(self, name, ekf_mod.filter1d_update(
                self._filter(), self._t(val), std, one))
        self.pose_queue.clear()
        self.twist_queue.clear()

    # -- timer ------------------------------------------------------------
    def tick(self, now: float) -> EkfEstimate:
        dt = self.interval.compute(now)
        self.clock = now
        self.ekf = ekf_mod.predict(self.ekf, dt, self.cfg)

        for m in self.pose_queue.pop_increment_age():
            step = queues.delay_step(now - m.stamp, dt,
                                     self.cfg.extend_state_step, self.warn)
            if step is None:
                continue
            r = queues.pose_covariance_to_measurement_r(
                m.covariance, self.cfg.pose_smoothing_steps)
            self.ekf = ekf_mod.update_pose(
                self.ekf, self._t([m.x, m.y, m.yaw]), self._t(r), step,
                self.cfg)

        for m in self.twist_queue.pop_increment_age():
            step = queues.delay_step(now - m.stamp, dt,
                                     self.cfg.extend_state_step, self.warn)
            if step is None:
                continue
            r = queues.twist_covariance_to_measurement_r(
                m.covariance, self.cfg.twist_smoothing_steps)
            self.ekf = ekf_mod.update_twist(
                self.ekf, self._t([m.vx, m.wz]), self._t(r), step, self.cfg)

        return self.current_estimate()

    def update_1d_filters(self, z: float, roll: float, pitch: float,
                          obs_stddev: float = float(np.sqrt(0.1))) -> None:
        """Feed the z / roll / pitch scalar filters from a 3D pose
        measurement."""
        dt = self._t(self.interval.default_dt)
        std = self._t(obs_stddev)
        self.z_filter = ekf_mod.filter1d_update(self.z_filter, self._t(z),
                                                std, dt)
        self.roll_filter = ekf_mod.filter1d_update(
            self.roll_filter, self._t(roll), std, dt)
        self.pitch_filter = ekf_mod.filter1d_update(
            self.pitch_filter, self._t(pitch), std, dt)

    # -- outputs ----------------------------------------------------------
    def current_estimate(self) -> EkfEstimate:
        pose2d, twist, p = ekf_mod.current_pose_twist(self.ekf)
        p_np = p.detach().cpu().numpy().astype(np.float64)
        return EkfEstimate(
            pose_xyyaw=pose2d.detach().cpu().numpy().astype(np.float64),
            z=float(self.z_filter.x),
            roll=float(self.roll_filter.x),
            pitch=float(self.pitch_filter.x),
            twist=twist.detach().cpu().numpy().astype(np.float64),
            pose_covariance=queues.ekf_covariance_to_pose_covariance(p_np),
            twist_covariance=queues.ekf_covariance_to_twist_covariance(
                p_np))
