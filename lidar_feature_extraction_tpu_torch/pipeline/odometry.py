"""Scan-to-scan odometry (the reference's library-only odometry path,
``odometry.hpp:43-73``, ``recent_scans.hpp:56-87``).

Port of ``lidar_feature_extraction_tpu/pipeline/odometry.py``:

- ``odometry_step``: the last N transformed feature scans in a ring
  buffer, dense voxel grids of the merged window rebuilt every step,
  k-nearest-neighbour registration against them;
- ``geometry_odometry_step``: the window as two persistent per-voxel
  moment grids instead, re-centred by whole-voxel rolls, one signed
  scatter per step evicting the scan that leaves the window and
  inserting the new one, registration by one record gather per point
  per iteration (the production path's cost);
- ``register_to_window``: scaled-grid registration, the wide-basin stage
  of the re-seed ladder;
- ``Odometry``: the host facade, with the constant-velocity prior, the
  fallback ladder and the IMU-aided prior.

Every step is functional (the state it is given is not modified), so the
ladder can rerun a scan on the original state. Slots are device tensors
(``index_copy`` / ``index_select``): nothing in a step reads the device.
The facade reads ``status`` and the edge block's median error once per
attempt, and keeps the scan count on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.fusion import imu as imu_mod
from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
from lidar_feature_extraction_tpu_torch.ops import geometry_grid as gg
from lidar_feature_extraction_tpu_torch.ops import voxel_grid as vg
from lidar_feature_extraction_tpu_torch.ops.downsample import voxel_downsample
from lidar_feature_extraction_tpu_torch.ops.residuals import (
    edge_residuals, surface_residuals)


class OdometryState(NamedTuple):
    """Rolling window of transformed feature scans + current pose."""

    edge_window: torch.Tensor   # [W, E, 3] map-frame edge points
    edge_mask: torch.Tensor     # [W, E]
    surf_window: torch.Tensor   # [W, S, 3]
    surf_mask: torch.Tensor     # [W, S]
    slot: torch.Tensor          # scalar int32 next write slot (ring)
    n_scans: torch.Tensor       # scalar int32 total scans inserted
    pose_q: torch.Tensor
    pose_t: torch.Tensor


class GeometryOdometryState(NamedTuple):
    """Incremental moment-grid odometry map + rolling eviction window."""

    edge_m: torch.Tensor        # [Ce, 10] raw per-voxel moments
    surf_m: torch.Tensor        # [Cs, 10]
    edge_origin: torch.Tensor   # [3]
    surf_origin: torch.Tensor   # [3]
    edge_window: torch.Tensor   # [W, E, 3] world-frame inserted points
    edge_mask: torch.Tensor     # [W, E]
    surf_window: torch.Tensor   # [W, S, 3]
    surf_mask: torch.Tensor     # [W, S]
    slot: torch.Tensor
    n_scans: torch.Tensor
    pose_q: torch.Tensor
    pose_t: torch.Tensor


def _window_fields(cfg: PipelineConfig, dtype, device) -> dict:
    w = cfg.mapping.recent_scans_window
    e = cfg.extraction.max_edges
    s = cfg.extraction.max_surfaces
    return dict(
        edge_window=torch.zeros((w, e, 3), dtype=dtype, device=device),
        edge_mask=torch.zeros((w, e), dtype=torch.bool, device=device),
        surf_window=torch.zeros((w, s, 3), dtype=dtype, device=device),
        surf_mask=torch.zeros((w, s), dtype=torch.bool, device=device),
        slot=torch.zeros((), dtype=torch.int32, device=device),
        n_scans=torch.zeros((), dtype=torch.int32, device=device),
        pose_q=torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device),
        pose_t=torch.zeros(3, dtype=dtype, device=device))


def init_odometry(cfg: PipelineConfig, dtype=torch.float32,
                  device="cuda") -> OdometryState:
    return OdometryState(**_window_fields(cfg, dtype, device))


def init_geometry_odometry(cfg: PipelineConfig, dtype=torch.float32,
                           device="cuda") -> GeometryOdometryState:
    reg = cfg.registration
    dims = reg.odometry_grid_dims
    cap = dims[0] * dims[1] * dims[2]
    half = torch.tensor(dims, dtype=torch.float64)
    return GeometryOdometryState(
        edge_m=torch.zeros((cap, 10), dtype=dtype, device=device),
        surf_m=torch.zeros((cap, 10), dtype=dtype, device=device),
        edge_origin=(-half * reg.edge_map.voxel_size / 2.0).to(dtype).to(
            device),
        surf_origin=(-half * reg.surface_map.voxel_size / 2.0).to(dtype).to(
            device),
        **_window_fields(cfg, dtype, device))


def chained_prior(cur: Pose, prev: Pose) -> Pose:
    """The constant-velocity prior ``cur (prev^-1 cur)`` as the
    reference's odometry chain computes it inside its jitted
    ``lax.scan`` (bench_odometry.py's ``bench_mode``): in float32 the
    rotations ``quat_rotate_fma``, the inner product
    ``quat_multiply_fma`` and the outer one with its second product
    fused first, each normalized by ``quat_normalize``. (``Odometry``'s
    own prior runs on the host, as ``Pose.compose``.)"""
    inv_q = quat.quat_conjugate(prev.q)
    inv_t = -quat.quat_rotate_fma(inv_q, prev.t)
    delta_q = quat.quat_normalize(quat.quat_multiply_fma(inv_q, cur.q))
    delta_t = quat.quat_rotate_fma(inv_q, cur.t) + inv_t
    return Pose(quat.quat_normalize(quat.quat_multiply_fma(
        cur.q, delta_q, fuse_second=True)),
        quat.quat_rotate_fma(cur.q, delta_t) + cur.t)


def _prior(state, prior_q, prior_t) -> Pose:
    return Pose(state.pose_q if prior_q is None else prior_q,
                state.pose_t if prior_t is None else prior_t)


def _put(window: torch.Tensor, slot: torch.Tensor, row: torch.Tensor):
    """``window`` with row ``slot`` replaced (out of place)."""
    return window.index_copy(0, slot.reshape(1).long(), row[None])


def _take(window: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    return window.index_select(0, slot.reshape(1).long())[0]


def _gauss_newton(problem_fn, prior: Pose, cfg: PipelineConfig,
                  abort_on_increase: bool = True) -> gn.GNResult:
    reg = cfg.registration
    return gn.run_gauss_newton(
        problem_fn, prior, max_iterations=reg.max_iterations,
        convergence_tol=reg.convergence_tol, huber_k=reg.huber_k,
        degeneracy_threshold=reg.degeneracy_threshold,
        abort_on_increase=abort_on_increase)


def _knn_problem(edge_map, surf_map, edge_pts, edge_valid, surf_ds,
                 surf_ds_valid, k: int):
    def problem_fn(p: Pose) -> gn.Problem:
        eb = edge_residuals(edge_map, edge_pts, edge_valid, p, k)
        sb = surface_residuals(surf_map, surf_ds, surf_ds_valid, p, k)
        return gn.make_problem([eb, sb])
    return problem_fn


def _downsample(surf_pts, surf_valid, cfg: PipelineConfig):
    reg = cfg.registration
    return voxel_downsample(surf_pts, surf_valid, reg.surface_downsample_leaf,
                            reg.max_surface_points)


def odometry_step(state: OdometryState, edge_pts, edge_valid, surf_pts,
                  surf_valid, cfg: PipelineConfig, prior_q=None,
                  prior_t=None):
    """One odometry update (``Odometry::Update``, odometry.hpp:52-64):
    register the scan's features against the merged recent window, then
    insert the transformed scan at the new pose. The first scan only
    initializes the window. ``prior_q`` / ``prior_t`` replace the GN
    starting pose (default: the previous pose)."""
    reg = cfg.registration
    pose = _prior(state, prior_q, prior_t)
    is_first = state.n_scans == 0

    em, sm = reg.edge_map, reg.surface_map
    dims = reg.odometry_grid_dims
    dims_t = torch.tensor(dims, dtype=state.pose_t.dtype,
                          device=state.pose_t.device)
    edge_map = vg.build_voxel_grid(
        state.edge_window.reshape(-1, 3), state.edge_mask.reshape(-1),
        em.voxel_size, state.pose_t - dims_t * em.voxel_size / 2.0, dims,
        em.points_per_voxel)
    surf_map = vg.build_voxel_grid(
        state.surf_window.reshape(-1, 3), state.surf_mask.reshape(-1),
        sm.voxel_size, state.pose_t - dims_t * sm.voxel_size / 2.0, dims,
        sm.points_per_voxel)
    surf_ds, surf_ds_valid = _downsample(surf_pts, surf_valid, cfg)
    result = _gauss_newton(
        _knn_problem(edge_map, surf_map, edge_pts, edge_valid, surf_ds,
                     surf_ds_valid, reg.n_neighbors), pose, cfg)

    new_q = torch.where(is_first, state.pose_q, result.pose.q)
    new_t = torch.where(is_first, state.pose_t, result.pose.t)
    new_pose = Pose(new_q, new_t)
    w = state.edge_window.shape[0]
    new_state = OdometryState(
        edge_window=_put(state.edge_window, state.slot,
                         new_pose.apply_fma(edge_pts)),
        edge_mask=_put(state.edge_mask, state.slot, edge_valid),
        surf_window=_put(state.surf_window, state.slot,
                         new_pose.apply_fma(surf_pts)),
        surf_mask=_put(state.surf_mask, state.slot, surf_valid),
        slot=(state.slot + 1) % w, n_scans=state.n_scans + 1,
        pose_q=new_q, pose_t=new_t)
    return new_state, result


def _in_bounds(pts, origin, voxel, dims):
    idx = torch.floor((pts - origin) / voxel)
    return torch.all((idx >= 0) & (idx < torch.tensor(
        dims, dtype=idx.dtype, device=idx.device)), dim=-1)


def geometry_odometry_step(state: GeometryOdometryState, edge_pts,
                           edge_valid, surf_pts, surf_valid,
                           cfg: PipelineConfig, prior_q=None, prior_t=None):
    """One incremental odometry update: re-centre, fit, register, evict +
    insert. The same ``Odometry::Update`` semantics as
    ``odometry_step``."""
    reg = cfg.registration
    em, sm = reg.edge_map, reg.surface_map
    dims = reg.odometry_grid_dims
    pose = _prior(state, prior_q, prior_t)
    is_first = state.n_scans == 0

    # 1. The grids follow the vehicle (whole-voxel rolls, no rebuild).
    edge_m, edge_origin = gg.recenter_moments(
        state.edge_m, dims, em.voxel_size, state.edge_origin, pose.t)
    surf_m, surf_origin = gg.recenter_moments(
        state.surf_m, dims, sm.voxel_size, state.surf_origin, pose.t)

    # Window points whose voxels rolled off the grid lost their moments:
    # clear their mask bits so no later eviction subtracts them. The AND
    # is one-way: a dropped point stays dropped if the grid comes back.
    edge_wmask = state.edge_mask & _in_bounds(
        state.edge_window, edge_origin, em.voxel_size, dims)
    surf_wmask = state.surf_mask & _in_bounds(
        state.surf_window, surf_origin, sm.voxel_size, dims)

    # 2. Per-voxel line/plane fits (box filter + eig3).
    edge_grid = gg._grid(gg.edge_records_from_moments(
        edge_m, dims, em.voxel_size, edge_origin), em.voxel_size,
        edge_origin, dims)
    surf_grid = gg._grid(gg.surface_records_from_moments(
        surf_m, dims, sm.voxel_size, surf_origin), sm.voxel_size,
        surf_origin, dims)
    surf_ds, surf_ds_valid = _downsample(surf_pts, surf_valid, cfg)

    def problem_fn(p: Pose) -> gn.Problem:
        eb = gg.edge_rows_from_grid(edge_grid, edge_pts, edge_valid, p,
                                    reg.min_fit_points)
        sb = gg.surface_rows_from_grid(surf_grid, surf_ds, surf_ds_valid, p,
                                       reg.min_fit_points)
        return gn.make_problem([eb, sb])

    result = _gauss_newton(problem_fn, pose, cfg)
    new_q = torch.where(is_first, state.pose_q, result.pose.q)
    new_t = torch.where(is_first, state.pose_t, result.pose.t)
    new_pose = Pose(new_q, new_t)

    # 3. Evict the slot leaving the window and insert the new scan: one
    # signed moment scatter per grid. The inserted masks record what the
    # scatter really adds (out-of-bounds points go to its dump row), so
    # no eviction ever subtracts a point that was not added. The points
    # move as the reference's jitted step moves them (``apply_fma``).
    te = new_pose.apply_fma(edge_pts)
    ts = new_pose.apply_fma(surf_pts)
    old_e = _take(state.edge_window, state.slot)
    old_s = _take(state.surf_window, state.slot)
    ins_em = edge_valid & _in_bounds(te, edge_origin, em.voxel_size, dims)
    ins_sm = surf_valid & _in_bounds(ts, surf_origin, sm.voxel_size, dims)

    def signs(n_new, n_old, like):
        return torch.cat([torch.ones(n_new, dtype=like.dtype,
                                     device=like.device),
                          torch.full((n_old,), -1.0, dtype=like.dtype,
                                     device=like.device)])

    edge_m = edge_m + gg.voxel_moments(
        torch.cat([te, old_e]),
        torch.cat([ins_em, _take(edge_wmask, state.slot)]),
        em.voxel_size, edge_origin, dims,
        weight=signs(te.shape[0], old_e.shape[0], te))
    surf_m = surf_m + gg.voxel_moments(
        torch.cat([ts, old_s]),
        torch.cat([ins_sm, _take(surf_wmask, state.slot)]),
        sm.voxel_size, surf_origin, dims,
        weight=signs(ts.shape[0], old_s.shape[0], ts))

    w = state.edge_window.shape[0]
    new_state = GeometryOdometryState(
        edge_m=edge_m, surf_m=surf_m,
        edge_origin=edge_origin, surf_origin=surf_origin,
        edge_window=_put(state.edge_window, state.slot, te),
        edge_mask=_put(edge_wmask, state.slot, ins_em),
        surf_window=_put(state.surf_window, state.slot, ts),
        surf_mask=_put(surf_wmask, state.slot, ins_sm),
        slot=(state.slot + 1) % w, n_scans=state.n_scans + 1,
        pose_q=new_q, pose_t=new_t)
    return new_state, result


def register_to_window(edge_window, edge_mask, surf_window, surf_mask,
                       edge_pts, edge_valid, surf_pts, surf_valid,
                       prior_q, prior_t, cfg: PipelineConfig,
                       scale: int) -> gn.GNResult:
    """Coarse registration of a scan against the merged window at
    ``scale`` times the map voxel size (cell counts divided by the same
    factor, so the extent stays and the 3x3x3 reach grows to
    +-1.5 * scale voxels), error-increase aborts off."""
    reg = cfg.registration
    em, sm = reg.edge_map, reg.surface_map
    dims = tuple(max(d // scale, 8) for d in reg.odometry_grid_dims)
    dims_t = torch.tensor(dims, dtype=prior_t.dtype, device=prior_t.device)
    ve = scale * em.voxel_size
    vs = scale * sm.voxel_size
    edge_map = vg.build_voxel_grid(edge_window.reshape(-1, 3),
                                   edge_mask.reshape(-1), ve,
                                   prior_t - dims_t * ve / 2.0, dims,
                                   em.points_per_voxel)
    surf_map = vg.build_voxel_grid(surf_window.reshape(-1, 3),
                                   surf_mask.reshape(-1), vs,
                                   prior_t - dims_t * vs / 2.0, dims,
                                   sm.points_per_voxel)
    surf_ds, surf_ds_valid = _downsample(surf_pts, surf_valid, cfg)
    return _gauss_newton(
        _knn_problem(edge_map, surf_map, edge_pts, edge_valid, surf_ds,
                     surf_ds_valid, reg.n_neighbors),
        Pose(prior_q, prior_t), cfg, abort_on_increase=False)


class Odometry:
    """Host facade of the C++ ``Odometry`` template, plus the IMU-aided
    prior path.

    ``use_geometry=True`` (default) runs ``geometry_odometry_step``;
    ``False`` the point-grid kNN path ``odometry_step``.
    ``edge_gate_distance``: the median point-to-line distance of the
    edge correspondences at the registered pose above which an attempt
    is taken to have snapped onto aliased geometry."""

    def __init__(self, cfg: PipelineConfig, dtype=torch.float32,
                 use_geometry: bool = True,
                 constant_velocity_prior: bool = True,
                 edge_gate_distance: float = 0.3, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.use_geometry = use_geometry
        self.constant_velocity_prior = constant_velocity_prior
        self.edge_gate_distance = edge_gate_distance
        self._step = (geometry_odometry_step if use_geometry
                      else odometry_step)
        self.state = (init_geometry_odometry(cfg, dtype, device)
                      if use_geometry else init_odometry(cfg, dtype, device))
        # Host mirror of state.n_scans.
        self.n_scans = 0
        self.velocity = torch.zeros(3, dtype=dtype, device=device)
        self._last_pose: Pose | None = None

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype or self.dtype,
                               device=self.device)

    def _scan(self, edge_pts, edge_valid, surf_pts, surf_valid):
        return (self._t(edge_pts), self._t(edge_valid, torch.bool),
                self._t(surf_pts), self._t(surf_valid, torch.bool))

    @staticmethod
    def _edge_median_distance(block_error: float) -> float:
        """Median point-to-line distance of the edge block at the
        registered pose from its median squared residual: the residual
        (p - p1) x (p - p2) has |p2 - p1| = 2, so |r| = 2 x distance."""
        return block_error ** 0.5 / 2.0

    def _check(self, result) -> tuple[bool, float]:
        """(suspect, edge median distance) of one attempt: one read."""
        status, med = torch.stack([
            result.status.to(result.block_errors.dtype),
            result.block_errors[0]]).tolist()
        d = self._edge_median_distance(med)
        if int(status) in (gn.EMPTY_INPUT, gn.MAX_ITERATIONS):
            return True, d
        if self.edge_gate_distance is None:
            return False, d
        return d == d and d > self.edge_gate_distance, d

    def update(self, edge_pts, edge_valid, surf_pts, surf_valid,
               prior: Pose | None = None):
        scan = self._scan(edge_pts, edge_valid, surf_pts, surf_valid)
        prev = self.pose
        cv_prior = None
        if prior is None and self.constant_velocity_prior \
                and self._last_pose is not None:
            # Constant-velocity extrapolation: the previous inter-scan
            # delta composed onto the current pose.
            delta = self._last_pose.inverse().compose(prev)
            cv_prior = prev.compose(delta)
            prior = cv_prior
        state0 = self.state
        if prior is not None:
            prior = Pose(self._t(prior.q), self._t(prior.t))
            self.state, result = self._step(state0, *scan, self.cfg,
                                            prior_q=prior.q, prior_t=prior.t)
        else:
            self.state, result = self._step(state0, *scan, self.cfg)
        self.n_scans += 1
        suspect, d = self._check(result)
        if suspect and self.n_scans > 1:
            # Cold start, abrupt reversal or motion break: each fallback
            # reruns on the ORIGINAL state (the failed attempt inserted
            # the scan at a bad pose). Ladder: constant-position seed,
            # then a coarse-to-fine re-seed against the window; keep the
            # attempt with the best edge fit.
            candidates = [(d, self.state, result)]
            if cv_prior is not None:
                self.state, result = self._step(
                    state0, *scan, self.cfg, prior_q=prev.q, prior_t=prev.t)
                suspect, d = self._check(result)
                candidates.append((d, self.state, result))
            if suspect:
                seed = prev
                for scale in (4, 2):
                    coarse = register_to_window(
                        state0.edge_window, state0.edge_mask,
                        state0.surf_window, state0.surf_mask, *scan,
                        seed.q, seed.t, self.cfg, scale)
                    if int(coarse.status) in (gn.CONVERGED,
                                              gn.MAX_ITERATIONS):
                        seed = coarse.pose
                self.state, result = self._step(
                    state0, *scan, self.cfg, prior_q=seed.q, prior_t=seed.t)
                suspect, d = self._check(result)
                candidates.append((d, self.state, result))
            if suspect:
                # Every attempt failed the gate: the best edge fit (nan
                # sorts last).
                _, self.state, result = min(
                    candidates,
                    key=lambda c: c[0] if c[0] == c[0] else float("inf"))
        self._last_pose = prev
        return result

    def update_with_imu(self, edge_pts, edge_valid, surf_pts, surf_valid,
                        gyro, accel, dts):
        """Odometry update seeded by the IMU prediction over the window
        since the previous scan (gyro / accel / dts: [N, 3] / [N, 3] /
        [N]); the velocity is then taken from the registered motion."""
        zero = torch.zeros(3, dtype=self.dtype, device=self.device)
        pre = imu_mod.preintegrate(self._t(gyro), self._t(accel),
                                   self._t(dts), zero, zero)
        q, t, _v = imu_mod.predict_state(self.state.pose_q,
                                         self.state.pose_t, self.velocity,
                                         pre)
        prev_t = self.state.pose_t
        result = self.update(edge_pts, edge_valid, surf_pts, surf_valid,
                             prior=Pose(q, t))
        self.velocity = (self.state.pose_t - prev_t) / torch.clamp_min(
            pre.dt, 1e-6)
        return result

    @property
    def pose(self) -> Pose:
        return Pose(self.state.pose_q, self.state.pose_t)
