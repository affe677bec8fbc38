"""Full mapping pipeline: odometry front end, keyframe store, radius loop
closure, pose-graph back end (or the IMU-aware graph), map assembly.

Port of ``lidar_feature_extraction_tpu/pipeline/slam.py``. The keyframes,
constraints and factors live on the pipeline's device; what the host
needs to decide lives in host mirrors instead of per-call reads:

- the keyframe gate reads the two pose-delta magnitudes and the scan's
  map position together, once per scan;
- the loop-closure radius search runs over a host mirror of the keyframe
  positions, filled when a keyframe is added and refreshed by one read
  after each ``optimize``;
- a loop candidate's acceptance reads the pyramid stages' statuses and
  the four inlier counts of the final pose (one read), and each new
  constraint's 6x6 information is computed on the host in float64, as in
  the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.core.pose import (
    Pose, pose_delta_magnitudes)
from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
from lidar_feature_extraction_tpu_torch.ops import voxel_grid as vg
from lidar_feature_extraction_tpu_torch.ops.downsample import voxel_downsample
from lidar_feature_extraction_tpu_torch.ops.residuals import (
    edge_residuals, surface_residuals, surface_residuals_eager)
from lidar_feature_extraction_tpu_torch.parallel.pose_graph import (
    Constraints, PoseGraph, optimize_pose_graph, optimize_pose_graph_cg)
from lidar_feature_extraction_tpu_torch.pipeline.odometry import Odometry


class Keyframe(NamedTuple):
    pose: Pose
    edge_pts: torch.Tensor    # sensor-frame features
    edge_valid: torch.Tensor
    surf_pts: torch.Tensor
    surf_valid: torch.Tensor
    stamp: float


def relative_pose(a: Pose, b: Pose) -> Pose:
    return a.inverse().compose(b)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def constraint_info_from_hessian(hessian, q, eig_floor: float = 0.01,
                                 eig_cap: float = 100.0
                                 ) -> Optional[np.ndarray]:
    """Registration Hessian M^T A M -> normalized [6, 6] constraint
    information in the pose-graph residual tangent, on the host in
    float64: the translation block conjugated by R(q) (the graph's
    translation tangent is local), the whole divided by the translation
    block's largest eigenvalue, the spectrum clipped to
    [eig_floor, eig_cap]. None when the Hessian is unusable."""
    if hessian is None:
        return None
    if isinstance(hessian, torch.Tensor):
        flat = torch.cat([hessian.reshape(-1), quat.quat_to_matrix(
            torch.as_tensor(q, dtype=hessian.dtype,
                            device=hessian.device)).reshape(-1)])
        flat = flat.cpu().numpy().astype(np.float64)    # one read
        h, r = flat[:36].reshape(6, 6), flat[36:].reshape(3, 3)
    else:
        h = np.asarray(hessian, np.float64)
        r = _np(quat.quat_to_matrix(torch.as_tensor(
            np.asarray(q, np.float32)))).astype(np.float64)
    if not np.all(np.isfinite(h)) or np.trace(h) <= 0:
        return None
    j = np.eye(6)
    j[3:, 3:] = r
    lam = j.T @ h @ j
    lam = 0.5 * (lam + lam.T)
    t_max = float(np.linalg.eigvalsh(lam[3:, 3:]).max())
    if not np.isfinite(t_max) or t_max <= 0:
        return None
    lam = lam / t_max
    w, v = np.linalg.eigh(lam)
    w = np.clip(w, eig_floor, eig_cap)
    lam = (v * w) @ v.T
    return lam.astype(np.float32)


class MappingPipeline:
    """Feed per-scan features; get an optimized keyframe trajectory and a
    globally consistent feature map. The arguments are the reference's
    (its docstrings give the reasons for each default); ``dtype`` and
    ``device`` place the state, on the card unless asked otherwise."""

    def __init__(self, cfg: PipelineConfig,
                 loop_radius: float = 5.0,
                 loop_min_gap: int = 20,
                 optimize_every: int = 10,
                 loop_inlier_threshold: float = 0.3,
                 loop_min_inlier_frac: float = 0.6,
                 loop_min_matches: int = 50,
                 loop_min_edge_matches: int = 20,
                 dense_solver_max_keyframes: int = 128,
                 estimate_imu_bias: bool = True,
                 imu_gyro_noise: float = 1.7e-4,
                 imu_accel_noise: float = 2.0e-3,
                 dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.odometry = Odometry(cfg, dtype=dtype, device=device)
        self.keyframes: list[Keyframe] = []
        # (i, j, relative Pose, weight, info [6, 6] or None) each.
        self.constraints: list[tuple] = []
        self.loop_radius = loop_radius
        self.loop_min_gap = loop_min_gap
        self.optimize_every = optimize_every
        self.loop_inlier_threshold = loop_inlier_threshold
        self.loop_min_inlier_frac = loop_min_inlier_frac
        self.loop_min_matches = loop_min_matches
        self.loop_min_edge_matches = loop_min_edge_matches
        self.dense_solver_max_keyframes = dense_solver_max_keyframes
        self.estimate_imu_bias = estimate_imu_bias
        self.imu_gyro_noise = imu_gyro_noise
        self.imu_accel_noise = imu_accel_noise
        self.imu_bias: Optional[tuple] = None
        self._optimized: Optional[PoseGraph] = None
        self._kf_since_opt = 0
        # Raw odometry poses per keyframe feed the chain constraints;
        # _corr maps the odometry frame to the optimized map frame.
        self._odom_poses: list[Pose] = []
        self._corr: Pose = Pose.identity(dtype, device)
        # Host mirror of the keyframes' map positions (float32).
        self._kf_pos: list[np.ndarray] = []
        self._imu_buffer: list = []
        self.imu_factors: list = []   # (i, j, ImuPreintegration)
        self._vels: Optional[np.ndarray] = None

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype or self.dtype,
                               device=self.device)

    def _pose(self, p: Pose) -> Pose:
        return Pose(self._t(p.q), self._t(p.t))

    # ---- front end -------------------------------------------------

    def process_scan(self, edge_pts, edge_valid, surf_pts, surf_valid,
                     stamp: float = 0.0, imu_gyro=None, imu_accel=None,
                     imu_dts=None) -> Pose:
        """Odometry update + keyframe / loop bookkeeping; returns the
        scan's map-frame pose. ``imu_*``: the raw samples since the
        previous scan ([N, 3], [N, 3], [N]); they seed the scan matcher
        and accumulate into the next keyframe's IMU factor."""
        scan = self.odometry._scan(edge_pts, edge_valid, surf_pts,
                                   surf_valid)
        if imu_gyro is not None:
            reg = self.odometry.update_with_imu(*scan, imu_gyro, imu_accel,
                                                imu_dts)
            self._imu_buffer.append((_np(imu_gyro), _np(imu_accel),
                                     _np(imu_dts)))
        else:
            reg = self.odometry.update(*scan)
        return self.ingest_odometry_result(
            *scan, self.odometry.pose,
            hessian=None if reg is None else reg.hessian, stamp=stamp)

    def ingest_odometry_result(self, edge_pts, edge_valid, surf_pts,
                               surf_valid, odom_pose: Pose,
                               hessian=None, stamp: float = 0.0) -> Pose:
        """Keyframe / loop / back-end bookkeeping for an odometry result
        produced elsewhere."""
        edge_pts, edge_valid, surf_pts, surf_valid = self.odometry._scan(
            edge_pts, edge_valid, surf_pts, surf_valid)
        odom_pose = self._pose(odom_pose)
        map_pose = self._corr.compose(odom_pose)
        add, position = self._should_add_keyframe(odom_pose, map_pose)
        if add:
            kf = Keyframe(pose=map_pose, edge_pts=edge_pts,
                          edge_valid=edge_valid, surf_pts=surf_pts,
                          surf_valid=surf_valid, stamp=stamp)
            self._add_keyframe(kf, odom_pose, hessian, position)
        return map_pose

    def _should_add_keyframe(self, odom_pose: Pose, map_pose: Pose):
        """(add?, the scan's map position on the host): the first scan,
        or a move past either keyframe threshold since the last
        keyframe's odometry pose. One read per scan."""
        if not self.keyframes:
            return True, map_pose.t.cpu().numpy()
        m = self.cfg.mapping
        dt, dq = pose_delta_magnitudes(self._odom_poses[-1], odom_pose)
        vals = torch.cat([dt[None], dq[None], map_pose.t]).cpu().numpy()
        add = bool((vals[0] >= m.keyframe_translation_threshold)
                   | (vals[1] >= m.keyframe_rotation_threshold))
        return add, vals[2:]

    def _add_keyframe(self, kf: Keyframe, odom_pose: Pose, hessian=None,
                      position: Optional[np.ndarray] = None) -> None:
        idx = len(self.keyframes)
        self.keyframes.append(kf)
        self._odom_poses.append(odom_pose)
        self._kf_pos.append(kf.pose.t.cpu().numpy() if position is None
                            else np.asarray(position, np.float32))
        if idx > 0:
            rel = relative_pose(self._odom_poses[idx - 1], odom_pose)
            # Chain information: the triggering registration's Hessian.
            info = constraint_info_from_hessian(hessian, odom_pose.q)
            self.constraints.append((idx - 1, idx, rel, 1.0, info))
            if self._imu_buffer:
                from lidar_feature_extraction_tpu_torch.fusion.imu import (
                    preintegrate)

                g, a, d = (np.concatenate([b[n] for b in self._imu_buffer])
                           for n in range(3))
                f32 = torch.float32
                zero = torch.zeros(3, dtype=f32, device=self.device)
                pre = preintegrate(
                    self._t(g, f32), self._t(a, f32), self._t(d, f32),
                    zero, zero, gyro_noise=self.imu_gyro_noise,
                    accel_noise=self.imu_accel_noise)
                self.imu_factors.append((idx - 1, idx, pre))
        self._imu_buffer = []
        closure = self._try_loop_closure(idx)
        self._kf_since_opt += 1
        if closure or self._kf_since_opt >= self.optimize_every:
            self.optimize()
            self._kf_since_opt = 0

    # ---- loop closure ----------------------------------------------

    def _try_loop_closure(self, idx: int) -> bool:
        """Radius search over the host mirror of past keyframe positions;
        re-register the new keyframe against the nearest one; accept on
        convergence and the inlier gate."""
        if idx < self.loop_min_gap:
            return False
        n_old = idx - self.loop_min_gap
        if n_old <= 0:
            return False
        pos = np.asarray(self._kf_pos[idx])
        dist = np.linalg.norm(np.stack(self._kf_pos[:n_old]) - pos, axis=-1)
        if not np.any(dist < self.loop_radius):
            return False
        j = int(np.argmin(np.where(dist < self.loop_radius, dist, np.inf)))
        match = self._register_to_keyframe(self.keyframes[idx],
                                           self.keyframes[j])
        if match is None:
            return False
        rel, quality, info = match
        self.constraints.append((j, idx, rel, quality, info))
        return True

    def _register_to_keyframe(self, kf: Keyframe, target: Keyframe):
        """GN-register kf's features against target's (both in their
        sensor frames) through a 4x / 2x coarse-to-fine pyramid; returns
        (measured relative pose target -> kf, quality weight in (0, 1],
        info) or None: non-convergence, correspondence starvation or a
        low inlier fraction at the final pose, per feature class."""
        reg = self.cfg.registration
        em, sm = reg.edge_map, reg.surface_map
        dims = reg.odometry_grid_dims
        dims_t = torch.tensor(dims, dtype=torch.float32, device=self.device)
        half_e = dims_t * em.voxel_size / 2.0
        half_s = dims_t * sm.voxel_size / 2.0

        def grids(scale):
            return (vg.build_voxel_grid(
                target.edge_pts, target.edge_valid, scale * em.voxel_size,
                -scale * half_e, dims, em.points_per_voxel),
                vg.build_voxel_grid(
                target.surf_pts, target.surf_valid, scale * sm.voxel_size,
                -scale * half_s, dims, sm.points_per_voxel))

        surf_ds, surf_ds_valid = voxel_downsample(
            kf.surf_pts, kf.surf_valid, reg.surface_downsample_leaf,
            reg.max_surface_points)

        def problem(edge_map, surf_map):
            def problem_fn(p: Pose) -> gn.Problem:
                return gn.make_problem([
                    edge_residuals(edge_map, kf.edge_pts, kf.edge_valid, p,
                                   reg.n_neighbors),
                    surface_residuals(surf_map, surf_ds, surf_ds_valid, p,
                                      reg.n_neighbors)])
            return problem_fn

        def register(problem_fn, prior):
            # Error-increase aborts off: the inlier gate below decides.
            return gn.run_gauss_newton(
                problem_fn, prior, max_iterations=reg.max_iterations,
                convergence_tol=reg.convergence_tol, huber_k=reg.huber_k,
                degeneracy_threshold=reg.degeneracy_threshold,
                abort_on_increase=False)

        # The prior carries the loop's whole accumulated drift, beyond
        # the fine grids' 3x3x3-voxel reach: scaled grids pull it into
        # the next basin first.
        prior = relative_pose(target.pose, kf.pose)
        for scale in (4.0, 2.0):
            coarse = register(problem(*grids(scale)), prior)
            if int(coarse.status) in (gn.CONVERGED, gn.MAX_ITERATIONS):
                prior = coarse.pose
        edge_map, surf_map = grids(1.0)
        result = register(problem(edge_map, surf_map), prior)
        if int(result.status) != gn.CONVERGED:
            return None

        # Fitness gate at the final pose, per feature class: surface
        # inliers alone cannot certify a closure (a ground plane aligns
        # with any other); the edges, which pin x / y / yaw, must agree.
        # The reference computes these rows outside a jitted program,
        # the surfaces' ill-conditioned plane fits in their eager forms.
        eb = edge_residuals(edge_map, kf.edge_pts, kf.edge_valid,
                            result.pose, reg.n_neighbors)
        sb = surface_residuals_eager(surf_map, surf_ds, surf_ds_valid,
                                     result.pose, reg.n_neighbors)
        counts = []
        for (res, valid), dist_scale in (((eb.residual, eb.valid), 2.0),
                                         (sb, 1.0)):
            # |edge residual| = 2 x the point-line distance; numpy's
            # float32 norm: the squares rounded, summed in order.
            err = xf.sqrt(xf.sum_in_order(res * res, dim=-1)) / dist_scale
            counts += [torch.sum(valid.to(torch.int32)),
                       torch.sum((valid & (
                           err < self.loop_inlier_threshold)).to(
                               torch.int32))]
        n_edge, k_edge, n_surf, k_surf = torch.stack(counts).tolist()
        inl_edge = float(k_edge) / max(n_edge, 1)
        inl_surf = float(k_surf) / max(n_surf, 1)
        n_valid = n_edge + n_surf
        if n_valid < self.loop_min_matches:
            return None
        if n_edge < self.loop_min_edge_matches \
                or inl_edge < self.loop_min_inlier_frac:
            return None
        inlier_frac = (n_edge * inl_edge + n_surf * inl_surf) / n_valid
        if inlier_frac < self.loop_min_inlier_frac:
            return None
        info = constraint_info_from_hessian(result.hessian, result.pose.q)
        return result.pose, inlier_frac, info

    # ---- back end --------------------------------------------------

    @staticmethod
    def _bucket(n: int, minimum: int = 8) -> int:
        """Next power-of-two shape bucket >= n (the reference pads so its
        jitted programs are reused; here it keeps the same padding, so
        the same normal equations are solved)."""
        b = minimum
        while b < n:
            b *= 2
        return b

    @staticmethod
    def _pad_constraints(cons: Constraints, m_to: int) -> Constraints:
        """Grow a Constraints batch to ``m_to`` lanes with inert weight-0
        padding (i=0, j=1, identity measurements)."""
        m = cons.i.shape[0]
        pad = m_to - m
        if pad <= 0:
            return cons
        like = cons.z_t
        ident = torch.tensor([[1.0, 0, 0, 0]], dtype=like.dtype,
                             device=like.device).expand(pad, 4)
        return Constraints(
            i=torch.cat([cons.i, cons.i.new_zeros(pad)]),
            j=torch.cat([cons.j, cons.j.new_ones(pad)]),
            z_q=torch.cat([cons.z_q, ident]),
            z_t=torch.cat([cons.z_t, like.new_zeros((pad, 3))]),
            weight=torch.cat([cons.weight, like.new_zeros(pad)]),
            info=None if cons.info is None else torch.cat(
                [cons.info, torch.eye(6, dtype=like.dtype,
                                      device=like.device).expand(pad, 6, 6)]))

    @staticmethod
    def _gnc_schedule(robust_delta, n_iterations):
        """[(delta, n_iterations), ...] for graduated non-convexity."""
        if robust_delta is None:
            return [(None, n_iterations)]
        n = max(n_iterations // 3, 1)
        return [(16.0 * robust_delta, n), (4.0 * robust_delta, n),
                (robust_delta, max(n_iterations - 2 * n, 1))]

    def optimize(self, n_iterations: int = 10,
                 robust_delta: float | None = 0.5) -> None:
        """Pose-graph Gauss-Newton over the active keyframe window (chain
        + loop constraints, Geman-McClure kernel under a graduated
        non-convexity schedule 16x -> 4x -> 1x). Only the last
        ``mapping.max_keyframes`` poses optimize (older ones freeze;
        bridging constraints re-anchor on the window's first pose); the
        matrix-free CG solver takes over past
        ``dense_solver_max_keyframes``; with IMU factors the IMU-aware
        graph runs instead."""
        k = len(self.keyframes)
        if k < 2 or not self.constraints:
            return
        offset = max(0, k - self.cfg.mapping.max_keyframes)
        ka = k - offset
        if ka < 2:
            return
        dtype, dev = self.dtype, self.device
        active = self.keyframes[offset:]
        poses_q = torch.stack([kf.pose.q for kf in active])
        poses_t = torch.stack([kf.pose.t for kf in active])
        # Pad the poses (identity, touched by no factor) and both factor
        # batches (weight 0) to power-of-two buckets, as the reference.
        kpad = self._bucket(ka)
        if kpad > ka:
            poses_q = torch.cat([poses_q, torch.tensor(
                [[1.0, 0, 0, 0]], dtype=dtype, device=dev).expand(
                    kpad - ka, 4)])
            poses_t = torch.cat([poses_t, poses_t.new_zeros((kpad - ka, 3))])

        eye = np.eye(6, dtype=np.float32)
        ci, cj, czq, czt, cw, cinfo = [], [], [], [], [], []
        anchor_inv = active[0].pose.inverse()
        for (i, j, rel, w, info) in self.constraints:
            if j < offset:
                continue          # entirely frozen
            if i < offset:
                # Bridge into the frozen region: a measurement of pose j
                # relative to the window anchor, z' = T_anchor^-1 T_i z.
                z = anchor_inv.compose(self.keyframes[i].pose.compose(rel))
                i2, j2 = 0, j - offset
            else:
                z, i2, j2 = rel, i - offset, j - offset
            if i2 == j2:
                continue
            ci.append(i2)
            cj.append(j2)
            czq.append(z.q)
            czt.append(z.t)
            cw.append(w)
            cinfo.append(eye if info is None else info)
        if not ci:
            return
        cons = self._pad_constraints(
            Constraints(i=self._t(ci, torch.int32), j=self._t(cj, torch.int32),
                        z_q=torch.stack(czq), z_t=torch.stack(czt),
                        weight=self._t(cw), info=self._t(np.stack(cinfo))),
            self._bucket(len(ci)))

        imu_window = [(a - offset, b - offset, pre)
                      for a, b, pre in self.imu_factors if a >= offset]
        if imu_window:
            graph9 = self._optimize_imu(imu_window, active, poses_q, poses_t,
                                        ka, kpad, cons, n_iterations,
                                        robust_delta)
            out = PoseGraph(poses_q=graph9.poses_q[:ka],
                            poses_t=graph9.poses_t[:ka])
            self._vels = graph9.vels[:ka].cpu().numpy()
            if graph9.bg is not None:
                self.imu_bias = (
                    graph9.bg.cpu().numpy(),
                    None if graph9.ba is None else graph9.ba.cpu().numpy())
        else:
            solver = (optimize_pose_graph_cg
                      if ka > self.dense_solver_max_keyframes
                      else optimize_pose_graph)
            graph = PoseGraph(poses_q=poses_q, poses_t=poses_t)
            for delta, n_it in self._gnc_schedule(robust_delta,
                                                  n_iterations):
                graph = solver(graph, cons, n_iterations=n_it,
                               robust_delta=delta)
            out = PoseGraph(poses_q=graph.poses_q[:ka],
                            poses_t=graph.poses_t[:ka])
        self._optimized = out
        # Write back the active window's poses (frozen keyframes keep
        # those of the optimization they last took part in), refresh
        # the position mirror with one read, and re-anchor the
        # odometry -> map correction on the newest keyframe.
        self.keyframes = self.keyframes[:offset] + [
            kf._replace(pose=Pose(out.poses_q[n], out.poses_t[n]))
            for n, kf in enumerate(active)]
        self._kf_pos[offset:] = list(out.poses_t.cpu().numpy())
        self._corr = self.keyframes[-1].pose.compose(
            self._odom_poses[-1].inverse())

    def _optimize_imu(self, imu_window, active, poses_q, poses_t, ka, kpad,
                      cons, n_iterations, robust_delta):
        from lidar_feature_extraction_tpu_torch.parallel.imu_graph import (
            ImuFactors, ImuGraph, optimize_imu_graph,
            weights_from_covariance)

        dtype, dev = self.dtype, self.device
        pres = [f[2] for f in imu_window]
        w_rot, w_vel, w_pos = weights_from_covariance(
            torch.stack([p.cov for p in pres]))
        mi = len(pres)
        ipad = self._bucket(mi) - mi

        def pad(x, fill=0.0):
            if ipad == 0:
                return x
            return torch.cat([x, torch.full((ipad,) + tuple(x.shape[1:]),
                                            fill, dtype=x.dtype,
                                            device=x.device)])

        def stack(name):
            return pad(torch.stack([getattr(p, name) for p in pres]))

        imu = ImuFactors(
            i=pad(self._t([f[0] for f in imu_window], torch.int32)),
            j=pad(self._t([f[1] for f in imu_window], torch.int32), 1),
            dq=torch.cat([torch.stack([p.dq for p in pres]),
                          torch.tensor([[1.0, 0, 0, 0]], dtype=dtype,
                                       device=dev).expand(ipad, 4)]),
            dv=stack("dv"), dp=stack("dp"), dt=stack("dt"),
            w_rot=pad(w_rot), w_vel=pad(w_vel), w_pos=pad(w_pos),
            weight=pad(torch.ones(mi, dtype=dtype, device=dev)),
            dq_dbg=stack("dq_dbg"), dv_dbg=stack("dv_dbg"),
            dv_dba=stack("dv_dba"), dp_dbg=stack("dp_dbg"),
            dp_dba=stack("dp_dba"))
        # Initial velocities: central differences of the keyframe
        # positions over their stamps (tangent velocities; the forward
        # chord lacks the curvature term), from the host mirror.
        t_np = np.asarray(self._kf_pos[len(self._kf_pos) - ka:], np.float64)
        stamps = np.asarray([kf.stamp for kf in active], np.float64)
        stamps = np.maximum.accumulate(stamps + 1e-9 * np.arange(
            len(stamps)))   # strictly increasing for np.gradient
        v = np.gradient(t_np, stamps, axis=0)
        vels = self._t(np.concatenate([v, np.zeros((kpad - ka, 3))]))
        zero3 = torch.zeros(3, dtype=dtype, device=dev)
        # Gyro bias only: accel bias stays at the zero linearization
        # point (weakly observable on short planar segments).
        graph9 = ImuGraph(poses_q=poses_q, poses_t=poses_t, vels=vels,
                          bg=zero3 if self.estimate_imu_bias else None,
                          ba=None)
        for delta, n_it in self._gnc_schedule(robust_delta, n_iterations):
            graph9 = optimize_imu_graph(graph9, cons, imu,
                                        n_iterations=n_it,
                                        robust_delta=delta)
        return graph9

    # ---- checkpoint / resume ----------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Serialize the full pipeline state (odometry map and window,
        keyframes, constraints with their 6x6 information, IMU factors
        and buffer, frame correction) so a run can resume mid-sequence."""
        from lidar_feature_extraction_tpu_torch.utils import checkpoint as ckpt

        kf = self.keyframes
        last = self.odometry._last_pose
        states = dict(odometry_state=self.odometry.state,
                      odometry_velocity=self.odometry.velocity,
                      corr=(self._corr.q, self._corr.t))
        meta = dict(n_keyframes=len(kf), n_constraints=len(self.constraints),
                    n_imu_factors=len(self.imu_factors),
                    n_imu_buffer=len(self._imu_buffer),
                    has_last_pose=last is not None,
                    kf_since_opt=self._kf_since_opt,
                    # Python floats: they ride the JSON manifest.
                    stamps=[float(f.stamp) for f in kf])
        if last is not None:
            states["last_pose"] = (last.q, last.t)
        if kf:
            states["keyframes"] = dict(
                q=torch.stack([f.pose.q for f in kf]),
                t=torch.stack([f.pose.t for f in kf]),
                edge_pts=torch.stack([f.edge_pts for f in kf]),
                edge_valid=torch.stack([f.edge_valid for f in kf]),
                surf_pts=torch.stack([f.surf_pts for f in kf]),
                surf_valid=torch.stack([f.surf_valid for f in kf]),
                odom_q=torch.stack([p.q for p in self._odom_poses]),
                odom_t=torch.stack([p.t for p in self._odom_poses]))
        if self.constraints:
            eye = np.eye(6, dtype=np.float32)
            c = self.constraints
            states["constraints"] = dict(
                i=np.asarray([x[0] for x in c], np.int32),
                j=np.asarray([x[1] for x in c], np.int32),
                z_q=torch.stack([x[2].q for x in c]),
                z_t=torch.stack([x[2].t for x in c]),
                w=np.asarray([x[3] for x in c], np.float32),
                info=np.stack([eye if x[4] is None else x[4] for x in c]),
                has_info=np.asarray([x[4] is not None for x in c]))
        if self.imu_factors:
            pres = [f[2] for f in self.imu_factors]
            states["imu_factors"] = dict(
                i=np.asarray([f[0] for f in self.imu_factors], np.int32),
                j=np.asarray([f[1] for f in self.imu_factors], np.int32),
                pre=type(pres[0])(*[torch.stack(x) for x in zip(*pres)]))
        if self._imu_buffer:
            states["imu_buffer"] = dict(
                gyro=np.concatenate([b[0] for b in self._imu_buffer]),
                accel=np.concatenate([b[1] for b in self._imu_buffer]),
                dts=np.concatenate([b[2] for b in self._imu_buffer]))
        ckpt.save_checkpoint(path, _meta=meta, **states)

    @classmethod
    def restore(cls, path: str, cfg: PipelineConfig,
                **pipeline_kwargs) -> "MappingPipeline":
        """Rebuild a pipeline from ``save_checkpoint`` output; feeding
        the remaining scans reproduces the unbroken run."""
        from lidar_feature_extraction_tpu_torch.fusion.imu import (
            ImuPreintegration)
        from lidar_feature_extraction_tpu_torch.utils import checkpoint as ckpt

        meta = ckpt.load_meta(path)
        p = cls(cfg, **pipeline_kwargs)
        dev = p.device
        k, m = int(meta["n_keyframes"]), int(meta["n_constraints"])
        mi = int(meta["n_imu_factors"])
        ex = cfg.extraction

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        templates = dict(odometry_state=p.odometry.state,
                         odometry_velocity=p.odometry.velocity,
                         corr=(z(4), z(3)))
        if meta["has_last_pose"]:
            templates["last_pose"] = (z(4), z(3))
        if k:
            templates["keyframes"] = dict(
                q=z(k, 4), t=z(k, 3), edge_pts=z(k, ex.max_edges, 3),
                edge_valid=z(k, ex.max_edges, dtype=torch.bool),
                surf_pts=z(k, ex.max_surfaces, 3),
                surf_valid=z(k, ex.max_surfaces, dtype=torch.bool),
                odom_q=z(k, 4), odom_t=z(k, 3))
        if m:
            templates["constraints"] = dict(
                i=z(m, dtype=torch.int32), j=z(m, dtype=torch.int32),
                z_q=z(m, 4), z_t=z(m, 3), w=z(m), info=z(m, 6, 6),
                has_info=z(m, dtype=torch.bool))
        if mi:
            templates["imu_factors"] = dict(
                i=z(mi, dtype=torch.int32), j=z(mi, dtype=torch.int32),
                pre=ImuPreintegration(
                    dq=z(mi, 4), dv=z(mi, 3), dp=z(mi, 3), dt=z(mi),
                    dq_dbg=z(mi, 3, 3), dv_dbg=z(mi, 3, 3),
                    dv_dba=z(mi, 3, 3), dp_dbg=z(mi, 3, 3),
                    dp_dba=z(mi, 3, 3), cov=z(mi, 9, 9)))

        data = ckpt.load_checkpoint(path, **templates)
        p.odometry.state = data["odometry_state"]
        p.odometry.n_scans = int(p.odometry.state.n_scans)
        p.odometry.velocity = data["odometry_velocity"]
        p._corr = p._pose(Pose(*data["corr"]))
        if meta["has_last_pose"]:
            p.odometry._last_pose = p._pose(Pose(*data["last_pose"]))
        p._kf_since_opt = int(meta["kf_since_opt"])
        if k:
            kfd = data["keyframes"]
            p.keyframes = [
                Keyframe(pose=Pose(kfd["q"][n], kfd["t"][n]),
                         edge_pts=kfd["edge_pts"][n],
                         edge_valid=kfd["edge_valid"][n],
                         surf_pts=kfd["surf_pts"][n],
                         surf_valid=kfd["surf_valid"][n],
                         stamp=float(meta["stamps"][n]))
                for n in range(k)]
            p._odom_poses = [Pose(kfd["odom_q"][n], kfd["odom_t"][n])
                             for n in range(k)]
            p._kf_pos = list(kfd["t"].cpu().numpy())
        if m:
            cd = {n: (v.cpu().numpy() if n not in ("z_q", "z_t") else v)
                  for n, v in data["constraints"].items()}
            p.constraints = [
                (int(cd["i"][n]), int(cd["j"][n]),
                 Pose(cd["z_q"][n], cd["z_t"][n]), float(cd["w"][n]),
                 np.asarray(cd["info"][n], np.float32)
                 if bool(cd["has_info"][n]) else None)
                for n in range(m)]
        if mi:
            im = data["imu_factors"]
            i_np, j_np = im["i"].cpu().numpy(), im["j"].cpu().numpy()
            p.imu_factors = [
                (int(i_np[n]), int(j_np[n]),
                 ImuPreintegration(*[x[n] for x in im["pre"]]))
                for n in range(mi)]
        if int(meta["n_imu_buffer"]):
            # Leaves of a dict are numbered in sorted key order: accel,
            # dts, gyro.
            with np.load(path) as raw:
                p._imu_buffer = [(raw["imu_buffer/2"], raw["imu_buffer/0"],
                                  raw["imu_buffer/1"])]
        return p

    # ---- outputs ---------------------------------------------------

    @property
    def trajectory(self) -> np.ndarray:
        """Keyframe map positions [K, 3] (the host mirror: no read)."""
        return np.stack(self._kf_pos) if self._kf_pos else np.zeros((0, 3))

    def assemble_map(self):
        """(edge_points, surf_points) in the map frame from the
        optimized keyframe poses."""
        edges, surfs = [], []
        for kf in self.keyframes:
            edges.append(kf.pose.apply(kf.edge_pts)[kf.edge_valid])
            surfs.append(kf.pose.apply(kf.surf_pts)[kf.surf_valid])
        if not edges:
            return np.zeros((0, 3)), np.zeros((0, 3))
        return (torch.cat(edges).cpu().numpy(),
                torch.cat(surfs).cpu().numpy())

    def save_maps(self, edge_path: str, surf_path: str) -> None:
        from lidar_feature_extraction_tpu_torch.io import pcd

        e, s = self.assemble_map()
        pcd.save_pcd(edge_path, e)
        pcd.save_pcd(surf_path, s)
