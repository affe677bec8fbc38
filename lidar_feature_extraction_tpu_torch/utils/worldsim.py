"""Synthetic LiDAR world and drive simulator for closed-loop evaluation.

Numpy copy of ``lidar_feature_extraction_tpu/utils/worldsim.py``: the
same draws from ``rng`` in the same order, so one seed gives the same
world, maps, scans, twists and IMU windows as the reference.

- ``make_world``: vertical pole cylinders (edge features) over a ground
  plane (surface features);
- ``world_maps``: the feature map clouds sampled from the world;
- ``raycast_scan``: a spinning-LiDAR sweep, per-ray nearest hit over the
  ground and the poles, so range images carry real arcs,
  discontinuities and occlusions;
- ``straight_drive`` / ``circle_pose``: scripted trajectories, as the
  port's ``Pose`` on the CPU;
- ``run_mapping_drive``: the mapping workload (odometry, keyframes, loop
  closure, pose graph or IMU graph) over a closed circular drive;
- ``run_drive``: the closed-loop localization + EKF replay of a scan
  sequence through ``FusedLocalizationPipeline``.

Rotation matrices are computed in float32 by ``quat_to_matrix`` and then
widened to float64, as the reference does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.core.pose import Pose


class World(NamedTuple):
    poles_xy: np.ndarray      # [K, 2] cylinder axes
    pole_radius: float
    pole_z: Tuple[float, float]
    ground_z: float
    extent: float


def make_world(rng: np.random.Generator, n_poles: int = 40,
               extent: float = 25.0, pole_radius: float = 0.15,
               ground_z: float = -1.7, min_spacing: float = 3.0) -> World:
    """``n_poles`` vertical cylinders at least ``min_spacing`` apart on a
    ground plane below the sensor."""
    poles = []
    for _ in range(n_poles * 20):
        if len(poles) >= n_poles:
            break
        xy = rng.uniform(-extent, extent, size=2)
        if poles and np.min(np.linalg.norm(
                np.asarray(poles) - xy, axis=-1)) < min_spacing:
            continue
        poles.append(xy)
    return World(poles_xy=np.asarray(poles, np.float64),
                 pole_radius=pole_radius, pole_z=(-2.0, 4.0),
                 ground_z=ground_z, extent=extent)


def world_maps(world: World, rng: np.random.Generator,
               points_per_pole: int = 60, n_ground: int = 12000,
               noise: float = 0.01) -> Tuple[np.ndarray, np.ndarray]:
    """(edge_points [Ne, 3], surface_points [Ns, 3]): pole-axis samples
    for the edge map, ground samples for the surface map."""
    zs = np.linspace(world.pole_z[0], world.pole_z[1], points_per_pole)
    edge = np.concatenate([
        np.concatenate([np.tile(xy, (points_per_pole, 1)), zs[:, None]],
                       axis=-1)
        for xy in world.poles_xy])
    edge = edge + rng.normal(scale=noise, size=edge.shape)
    g = rng.uniform(-world.extent - 5, world.extent + 5,
                    size=(n_ground, 2))
    ground = np.concatenate(
        [g, world.ground_z + rng.normal(scale=noise, size=(n_ground, 1))],
        axis=-1)
    return edge.astype(np.float64), ground


def raycast_scan(world: World, pose: Pose, rng: np.random.Generator,
                 n_rings: int = 16, n_az: int = 512,
                 elev_deg: Tuple[float, float] = (15.0, -15.0),
                 range_noise: float = 0.01, max_range: float = 80.0,
                 min_range: float = 0.5
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One sweep from ``pose``: per-ray nearest hit over the ground and
    every pole (z-extent clipped). Returns (points [M, 3] in the SENSOR
    frame, ring ids [M]) of the valid rays."""
    elev = np.radians(np.linspace(elev_deg[0], elev_deg[1], n_rings))
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    az = az + rng.uniform(0, 2 * np.pi / n_az)   # dither the grid phase
    e, a = np.meshgrid(elev, az, indexing="ij")  # [R, P]
    d_sensor = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a),
                         np.sin(e)], axis=-1)     # [R, P, 3]

    r_mat = quat.quat_to_matrix(pose.q.cpu()).numpy().astype(np.float64)
    o = pose.t.cpu().numpy().astype(np.float64)
    d = d_sensor @ r_mat.T                        # world-frame dirs

    inf = np.float64(np.inf)
    dz = d[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(dz < -1e-9, (world.ground_z - o[2]) / dz, inf)

    # Cylinder hits: the nearest positive root of
    # |o_xy + t d_xy - c|^2 = r^2 whose hit-z lies in the pole extent.
    d_xy = d[..., :2].astype(np.float32)          # [R, P, 2]
    o_xy = o[:2].astype(np.float32)
    t_pole = np.full(d_xy.shape[:2], inf, np.float32)
    aa = np.einsum("rpi,rpi->rp", d_xy, d_xy)     # [R, P]
    for c in world.poles_xy:
        oc = (o_xy - c).astype(np.float32)
        b = 2.0 * (d_xy @ oc)
        cc = float(oc @ oc - world.pole_radius ** 2)
        disc = b * b - 4.0 * aa * cc
        with np.errstate(invalid="ignore", divide="ignore"):
            t = (-b - np.sqrt(disc)) / (2.0 * aa)
        z_hit = o[2] + t * dz
        ok = ((disc > 0) & (t > min_range)
              & (z_hit > world.pole_z[0]) & (z_hit < world.pole_z[1]))
        t_pole = np.where(ok & (t < t_pole), t, t_pole)

    t = np.minimum(t_ground, t_pole)
    valid = (t > min_range) & (t < max_range)
    t = np.where(valid, t, max_range)  # keep the arithmetic finite
    t = t + rng.normal(scale=range_noise, size=t.shape)   # range noise

    hits_w = o + t[..., None] * d                 # [R, P, 3] world frame
    hits_s = (hits_w - o) @ r_mat                 # sensor frame
    ring = np.broadcast_to(np.arange(n_rings)[:, None], t.shape)
    return (hits_s[valid].astype(np.float32),
            ring[valid].astype(np.int32))


def _yaw_pose(yaw: float, t) -> Pose:
    return Pose(q=quat.exp_so3(torch.tensor([0.0, 0.0, yaw],
                                            dtype=torch.float32)),
                t=torch.as_tensor(np.asarray(t), dtype=torch.float32))


def straight_drive(i: int) -> Pose:
    """Default scripted trajectory: forward + slight lateral + yaw."""
    return _yaw_pose(0.03 * i, [0.5 * i, 0.1 * i, 0.0])


def make_scan_sequence(world: World, rng: np.random.Generator,
                       n_scans: int,
                       trajectory: Callable[[int], Pose] = straight_drive,
                       **scan_kwargs) -> Tuple[list, np.ndarray]:
    """One ray-cast scan sequence, made once so that several pipeline
    variants replay identical inputs. Returns (scans, ground-truth
    positions [N, 3])."""
    scans = []
    gt = []
    for i in range(n_scans):
        pose = trajectory(i)
        scans.append(raycast_scan(world, pose, rng, **scan_kwargs))
        gt.append(pose.t.cpu().numpy())
    return scans, np.stack(gt)


def synth_twists(n_scans: int,
                 trajectory: Callable[[int], Pose] = straight_drive,
                 period: float = 0.1,
                 rng: np.random.Generator | None = None,
                 v_noise: float = 0.1, w_noise: float = 0.01) -> list:
    """Vehicle-odometry (vx, wz) measurements along the trajectory, with
    wheel-odometry-grade noise when ``rng`` is given."""
    out = []
    for i in range(n_scans):
        a = trajectory(i)
        b = trajectory(i + 1)
        vx = float(np.linalg.norm((b.t - a.t).cpu().numpy()[:2])) / period
        # Wrap the yaw difference into (-pi, pi].
        dyaw = float(quat.quat_yaw(b.q)) - float(quat.quat_yaw(a.q))
        wz = float(np.arctan2(np.sin(dyaw), np.cos(dyaw))) / period
        if rng is not None:
            vx += rng.normal(scale=v_noise)
            wz += rng.normal(scale=w_noise)
        out.append((vx, wz))
    return out


def circle_pose(i: float, n_scans: int, radius: float) -> Pose:
    """Scan ``i`` of ``n_scans`` around a circle of ``radius``, heading
    tangent to the path."""
    th = 2 * np.pi * i / n_scans
    return _yaw_pose(th, [radius * np.sin(th), radius * (1 - np.cos(th)),
                          0.0])


def run_mapping_drive(world: World, cfg: PipelineConfig,
                      rng: np.random.Generator, n_scans: int,
                      radius: float, scan_period: float = 0.1,
                      with_imu: bool = False, imu_substeps: int = 100,
                      pipeline_kwargs: dict | None = None, device="cuda",
                      **scan_kwargs):
    """The mapping workload over a closed circular drive: ray-cast ->
    ``extract_features`` (K1 on the card) -> odometry -> keyframes ->
    loop closure -> pose-graph back end, on ``device``. Returns
    ``(pipeline, ground-truth keyframe positions [K, 3])`` after the
    final optimization. ``with_imu`` synthesizes noisy IMU windows, fed
    as scan-matcher priors and keyframe factors, with the reference's
    trust model for the back end (``imu_accel_noise`` matched to the
    zeroth-order-hold sampler's coherent error at the keyframe horizon);
    the draws from ``rng`` are the reference's, in its order."""
    from lidar_feature_extraction_tpu_torch.fusion import imu as imu_mod
    from lidar_feature_extraction_tpu_torch.ops.extraction import (
        extract_features)
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.pipeline.slam import (
        MappingPipeline)

    gyro = accel = dts = None
    sub = imu_substeps
    pipeline_kwargs = dict(pipeline_kwargs or {})
    if with_imu:
        fine = [circle_pose(k / sub, n_scans, radius)
                for k in range(n_scans * sub + 1)]
        gyro, accel, dts, _v0 = imu_mod.synthesize_imu(
            torch.stack([p.q for p in fine]),
            torch.stack([p.t for p in fine]), scan_period / sub)
        gyro = gyro.numpy() + rng.normal(scale=1e-3, size=gyro.shape)
        accel = accel.numpy() + rng.normal(scale=1e-2, size=accel.shape)
        dts = dts.numpy()
        # synthesize_imu holds each sample for its interval, so on the
        # turning platform its accel carries a coherent error of about
        # jerk * dt_sub / 2: the factors' noise density is matched to it
        # at the keyframe horizon (sigma_c = e_a * sqrt(T)).
        speed = 2 * np.pi * radius / (n_scans * scan_period)
        omega = speed / radius
        jerk = (speed * speed / radius) * omega
        e_a = jerk * (scan_period / sub) / 2 + 1e-2
        pipeline_kwargs.setdefault(
            "imu_accel_noise",
            max(2.0e-3, float(e_a * np.sqrt(scan_period))))

    pipeline = MappingPipeline(cfg, device=device, **pipeline_kwargs)
    for i in range(n_scans):
        pts, ring = raycast_scan(world, circle_pose(i, n_scans, radius), rng,
                                 **scan_kwargs)
        feats = extract_features(scan_range_image(pts, ring, cfg, device),
                                 cfg.extraction)
        scan = (feats.edge_xyz, feats.edge_valid, feats.surface_xyz,
                feats.surface_valid)
        if with_imu and i >= 1:
            sl = slice((i - 1) * sub, i * sub)
            pipeline.process_scan(*scan, stamp=float(i) * scan_period,
                                  imu_gyro=gyro[sl], imu_accel=accel[sl],
                                  imu_dts=dts[sl])
        else:
            pipeline.process_scan(*scan, stamp=float(i) * scan_period)
    pipeline.optimize()
    gt = np.stack([
        circle_pose(round(kf.stamp / scan_period), n_scans, radius).t.numpy()
        for kf in pipeline.keyframes])
    return pipeline, gt


def run_drive(maps, cfg: PipelineConfig, scans: Sequence,
              scan_period: float = 0.1,
              twists: Sequence | None = None,
              device="cuda") -> np.ndarray:
    """Closed-loop replay of a scan sequence against ``maps`` (on
    ``device``). Returns the raw scan-matcher positions [N, 3]."""
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        FusedLocalizationPipeline)

    pipeline = FusedLocalizationPipeline(
        maps, cfg, initial_pose=Pose.identity(device=device), device=device)
    est = []
    for i, (pts, ring) in enumerate(scans):
        res = pipeline.process_scan(
            pts, ring, stamp=scan_period * i,
            twist=None if twists is None else twists[i])
        est.append(res.measured_pose.t.cpu().numpy())
    return np.stack(est)
