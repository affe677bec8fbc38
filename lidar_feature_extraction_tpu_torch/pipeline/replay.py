"""Closed-loop replay: scan-to-map localization with a time-delay EKF
whose prediction seeds each registration.

Port of ``lidar_feature_extraction_tpu/pipeline/replay.py:29-165``. The
reference's process graph (extraction -> localization -> EKF -> prior
feedback) collapses into one registration per scan and a small host
driver that owns the EKF clock. The EKF state, its prior and the scalar
filters stay on the pipeline's device; the host reads back the
registration's status each Gauss-Newton iteration and nothing of the
filter.

``run_kitti_localization`` replays a KITTI velodyne sequence through
the pipeline.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.core.scan import (RangeImage,
                                                          build_range_image)
from lidar_feature_extraction_tpu_torch.fusion import ekf as ekf_mod
from lidar_feature_extraction_tpu_torch.io import kitti
from lidar_feature_extraction_tpu_torch.pipeline.localization import (
    localize_scan)


class ScanResult(NamedTuple):
    fused_pose: Pose          # EKF-fused SE(3) pose
    measured_pose: Pose       # raw scan-matcher pose
    gn_status: int
    gn_iterations: int


def scan_range_image(xyz: np.ndarray, ring: np.ndarray,
                     cfg: PipelineConfig, device) -> RangeImage:
    """One scan's points [M, 3] (sensor frame) and ring ids [M] as the
    range image the pipeline registers: the first
    ``n_rings * max_points_per_ring`` points, rings with fewer than
    ``padding + 1`` points dropped."""
    ex = cfg.extraction
    n = ex.n_rings * ex.max_points_per_ring
    m = min(len(xyz), n)
    pts = np.zeros((n, 3), np.float32)
    rng_ids = np.zeros(n, np.int32)
    pts[:m] = xyz[:m]
    rng_ids[:m] = ring[:m]
    return build_range_image(
        torch.as_tensor(pts, device=device),
        torch.as_tensor(rng_ids, device=device),
        torch.arange(n, device=device) < m,
        ex.n_rings, ex.max_points_per_ring,
        min_points_per_ring=ex.padding + 1)


class FusedLocalizationPipeline:
    """Scan-to-map localization + time-delay EKF, closed loop:

    - the EKF prediction seeds the Gauss-Newton registration;
    - the registered pose feeds back as an EKF pose measurement with the
      reference's hardcoded output covariance;
    - z / roll / pitch ride the three scalar filters.

    ``maps`` are ``GeometryMaps`` or ``FeatureMaps`` on ``device``; the
    pipeline registers with ``localize_scan`` and the branch ``cfg``
    selects.
    """

    def __init__(self, maps, cfg: PipelineConfig,
                 initial_pose: Optional[Pose] = None,
                 dtype=torch.float32, device="cuda"):
        self.maps = maps
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.ekf_dt = 1.0 / cfg.ekf.predict_frequency
        x0 = torch.zeros(6, dtype=dtype, device=self.device)
        if initial_pose is not None:
            q = initial_pose.q.to(device=self.device, dtype=dtype)
            t = initial_pose.t.to(device=self.device, dtype=dtype)
            x0[0], x0[1], x0[2] = t[0], t[1], quat.quat_yaw(q)
        self.ekf = ekf_mod.init_ekf(cfg.ekf, x0=x0)
        self.z_filter = self._filter()
        self.roll_filter = self._filter()
        self.pitch_filter = self._filter()
        self.clock: Optional[float] = None
        # Measurement covariance: the reference hardcodes the
        # localization output covariance; pose R rows (x, y, yaw) scaled
        # by the smoothing steps.
        self.pose_r = torch.diag(self._t([1.0, 1.0, 0.1])) \
            * cfg.ekf.pose_smoothing_steps
        # Twist measurement covariance (vx, wz): vehicle-odometry-grade
        # noise, scaled by the smoothing steps like the pose R.
        self.twist_r = torch.diag(self._t([0.04, 0.01])) \
            * cfg.ekf.twist_smoothing_steps

    def _t(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _filter(self) -> ekf_mod.Filter1D:
        return ekf_mod.Filter1D.create(dtype=self.dtype, device=self.device)

    def _ekf_prior(self) -> Pose:
        pose2d, _, _ = ekf_mod.current_pose_twist(self.ekf)
        q = quat.rpy_to_quat(self.roll_filter.x, self.pitch_filter.x,
                             pose2d[2])
        return Pose(q=q, t=torch.stack([pose2d[0], pose2d[1],
                                        self.z_filter.x]))

    def process_scan(self, xyz: np.ndarray, ring: np.ndarray,
                     stamp: float,
                     twist: Optional[tuple] = None) -> ScanResult:
        """One scan (points [M, 3] in the sensor frame, ring ids [M])
        through the closed loop. ``twist`` optionally feeds a (vx, wz)
        vehicle-odometry measurement for the elapsed interval."""
        image = scan_range_image(xyz, ring, self.cfg, self.device)

        # EKF clock: predict ticks up to the scan stamp.
        if self.clock is None:
            self.clock = stamp
        while self.clock < stamp:
            self.ekf = ekf_mod.predict(self.ekf, self.ekf_dt, self.cfg.ekf)
            self.clock += self.ekf_dt

        # Then the twist measurement (predict before measurements).
        if twist is not None:
            self.ekf = ekf_mod.update_twist(self.ekf, self._t(twist),
                                            self.twist_r, 0, self.cfg.ekf)

        result, _feats = localize_scan(self.maps, image, self._ekf_prior(),
                                       self.cfg)

        # Feed the measurement back (delay 0 in synchronous replay).
        mq, mt = result.pose.q, result.pose.t
        y = torch.stack([mt[0], mt[1], quat.quat_yaw(mq)]).to(self.dtype)
        self.ekf = ekf_mod.update_pose(self.ekf, y, self.pose_r, 0,
                                       self.cfg.ekf)
        # z / roll / pitch scalar filters (observation stddev sqrt(.1)).
        roll = xf.atan2(2 * (mq[0] * mq[1] + mq[2] * mq[3]),
                        1 - 2 * (mq[1] ** 2 + mq[2] ** 2))
        pitch = xf.asin(torch.clamp(
            2 * (mq[0] * mq[2] - mq[3] * mq[1]), -1, 1))
        dt = self._t(self.ekf_dt)
        std = self._t(np.sqrt(0.1))
        self.z_filter = ekf_mod.filter1d_update(self.z_filter, mt[2], std, dt)
        self.roll_filter = ekf_mod.filter1d_update(self.roll_filter, roll,
                                                   std, dt)
        self.pitch_filter = ekf_mod.filter1d_update(self.pitch_filter, pitch,
                                                    std, dt)

        return ScanResult(fused_pose=self._ekf_prior(),
                          measured_pose=Pose(mq, mt),
                          gn_status=int(result.status),
                          gn_iterations=int(result.iterations))


def run_kitti_localization(sequence_dir: str, maps, cfg: PipelineConfig,
                           limit: int | None = None,
                           scan_period: float = 0.1,
                           device="cuda") -> np.ndarray:
    """Replay a KITTI velodyne sequence (its ``.bin`` scans in name
    order, rings estimated from elevation) against pre-built maps on
    ``device``, one scan every ``scan_period`` seconds and no twists.
    Returns the [N, 3] fused positions."""
    pipeline = FusedLocalizationPipeline(maps, cfg, device=device)
    out = []
    for i, scan in enumerate(kitti.iter_scans(sequence_dir, limit)):
        ring = kitti.estimate_rings(scan[:, :3], cfg.extraction.n_rings)
        res = pipeline.process_scan(scan[:, :3], ring, i * scan_period)
        out.append(res.fused_pose.t)
    return torch.stack(out).cpu().numpy()
