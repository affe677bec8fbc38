"""Scan-to-map localization: extraction + Gauss-Newton registration.

Port of ``lidar_feature_extraction_tpu/pipeline/localization.py:45-439``:

- ``GeometryMaps`` / ``build_geometry_maps`` / ``register_scan_geometry``:
  precomputed per-voxel line and plane fits, looked up every GN
  iteration (the production path);
- ``FeatureMaps`` / ``build_feature_maps`` / ``register_scan``: map
  points in dense voxel grids and the k-nearest-neighbour fits of the
  reference (the faithful path), over ``n_search_rounds`` rounds that
  each gather the 27-voxel candidate sets once. The reference's
  ``lax.cond`` between rounds is one host read of the "run again?" flag
  per round (for a batch, "does any scan run again?");
- ``localize_scan``: extraction + registration, for both map types, of
  one scan or of a batch;
- ``localize_scans``: B scans at once, one extraction and one
  lock-step Gauss-Newton loop, on every branch;
- ``HostLocalizer``: the reference's host-stepped localizer. Its
  pieces are plain methods here (the reference jits each one), and its
  loop control is its own, not ``localize_scan``'s: Gauss-Newton through
  ``run_gauss_newton_host`` (an abort reports the aborting iteration's
  error and scale, and there are no block errors), and on ``FeatureMaps``
  search rounds that stop once a round converged, refresh after an abort
  only while the fits are frozen per round, and otherwise stop once the
  pose moved no more than half the smaller map voxel. So its results can
  differ from ``localize_scan``'s; on ``GeometryMaps`` with the fused
  record table the poses, statuses and iteration counts are the same
  (without it the host steps gather from each grid, as the reference's
  do).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.core.scan import RangeImage
from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
from lidar_feature_extraction_tpu_torch.ops import geometry_grid as gg
from lidar_feature_extraction_tpu_torch.ops import voxel_grid as vg
from lidar_feature_extraction_tpu_torch.ops.downsample import voxel_downsample
from lidar_feature_extraction_tpu_torch.ops.extraction import (
    extract_features, extract_features_compact)
from lidar_feature_extraction_tpu_torch.ops.residuals import (
    edge_residuals_from_candidates, edge_rows_from_geometry,
    fit_edge_geometry, fit_surface_geometry,
    surface_residuals_from_candidates, surface_rows_from_geometry)


class FeatureMaps(NamedTuple):
    """Map points in dense voxel grids (the kNN path)."""

    edge: vg.DenseVoxelGrid
    surface: vg.DenseVoxelGrid


class GeometryMaps(NamedTuple):
    """Precomputed-geometry feature maps: per-voxel line/plane fits,
    baked at build time. ``fused`` is the concatenated edge+surface
    record table (``gg.fuse_record_tables``) that registration gathers
    from once per iteration; None fuses it at registration."""

    edge: gg.GeometryGrid
    surface: gg.GeometryGrid
    fused: torch.Tensor = None


def _bounds(xyz: torch.Tensor, mask: torch.Tensor):
    pts = xyz.detach().cpu().numpy()[mask.detach().cpu().numpy()]
    if len(pts) == 0:
        return np.zeros(3, np.float32), np.ones(3, np.float32)
    return pts.min(axis=0), pts.max(axis=0)


def build_feature_maps(edge_xyz, edge_mask, surface_xyz, surface_mask,
                       cfg: PipelineConfig) -> FeatureMaps:
    """Insert the feature map clouds ([N, 3] points + [N] masks) into
    dense voxel grids. The grid bounds are computed on the host (one
    readback per map build)."""
    em = cfg.registration.edge_map
    sm = cfg.registration.surface_map
    e_origin, e_dims = vg.grid_for_bounds(*_bounds(edge_xyz, edge_mask),
                                          em.voxel_size)
    s_origin, s_dims = vg.grid_for_bounds(*_bounds(surface_xyz, surface_mask),
                                          sm.voxel_size)
    return FeatureMaps(
        edge=vg.build_voxel_grid(edge_xyz, edge_mask, em.voxel_size,
                                 e_origin, e_dims, em.points_per_voxel),
        surface=vg.build_voxel_grid(surface_xyz, surface_mask,
                                    sm.voxel_size, s_origin, s_dims,
                                    sm.points_per_voxel))


def build_geometry_maps(edge_xyz, edge_mask, surface_xyz, surface_mask,
                        cfg: PipelineConfig) -> GeometryMaps:
    """Bake per-voxel line/plane geometry from the feature map clouds
    ([N, 3] points + [N] masks). The grid bounds are computed on the
    host (one readback per map build)."""
    em = cfg.registration.edge_map
    sm = cfg.registration.surface_map
    e_origin, e_dims = vg.grid_for_bounds(*_bounds(edge_xyz, edge_mask),
                                          em.voxel_size)
    s_origin, s_dims = vg.grid_for_bounds(*_bounds(surface_xyz, surface_mask),
                                          sm.voxel_size)
    edge = gg.build_edge_geometry_grid(edge_xyz, edge_mask, em.voxel_size,
                                       e_origin, e_dims)
    surface = gg.build_surface_geometry_grid(surface_xyz, surface_mask,
                                             sm.voxel_size, s_origin, s_dims)
    return GeometryMaps(edge=edge, surface=surface,
                        fused=gg.fuse_record_tables(edge, surface))


def _gauss_newton(problem_fn, prior: Pose, cfg: PipelineConfig,
                  max_iterations: int) -> gn.GNResult:
    """One Gauss-Newton loop; a batch of priors (t [B, 3]) runs the
    lanes in lock-step."""
    reg = cfg.registration
    run = (gn.run_gauss_newton_batched if prior.t.dim() == 2
           else gn.run_gauss_newton)
    return run(
        problem_fn, prior,
        max_iterations=max_iterations,
        convergence_tol=reg.convergence_tol,
        huber_k=reg.huber_k,
        degeneracy_threshold=reg.degeneracy_threshold)


def register_scan_geometry(maps: GeometryMaps, edge_pts, edge_valid,
                           surf_pts, surf_valid, prior: Pose,
                           cfg: PipelineConfig,
                           pre_downsampled: bool = False) -> gn.GNResult:
    """Gauss-Newton registration against precomputed-geometry maps, the
    voxel lookup re-done every iteration. ``pre_downsampled`` skips the
    surface voxel downsample when the extraction already voxel-thinned
    the surfaces (``extract_features_compact``). With points [B, N, 3]
    and priors q [B, 4], t [B, 3] (pre-downsampled), B scans register in
    lock-step against the shared maps."""
    reg = cfg.registration
    if pre_downsampled:
        surf_ds, surf_ds_valid = surf_pts, surf_valid
    else:
        surf_ds, surf_ds_valid = voxel_downsample(
            surf_pts, surf_valid, reg.surface_downsample_leaf,
            reg.max_surface_points)
    fused = (maps.fused if maps.fused is not None
             else gg.fuse_record_tables(maps.edge, maps.surface))

    def problem_fn(p: Pose) -> gn.Problem:
        eb, sb = gg.fused_rows_from_grids(
            maps.edge, maps.surface, fused, edge_pts, edge_valid,
            surf_ds, surf_ds_valid, p, reg.min_fit_points)
        return gn.make_problem([eb, sb])

    return _gauss_newton(problem_fn, prior, cfg, reg.max_iterations)


def register_scan(maps: FeatureMaps, edge_pts, edge_valid, surf_pts,
                  surf_valid, prior: Pose, cfg: PipelineConfig) -> gn.GNResult:
    """Gauss-Newton registration of extracted features against point
    maps by kNN. The surface scan is voxel-downsampled once. Each of
    ``n_search_rounds`` rounds gathers the candidate sets at its start
    pose and runs up to ceil(max_iterations / rounds) iterations; with
    ``refit_per_iteration`` every iteration re-selects the neighbours and
    refits, otherwise the fits are made once per round."""
    reg = cfg.registration
    surf_ds, surf_ds_valid = voxel_downsample(
        surf_pts, surf_valid, reg.surface_downsample_leaf,
        reg.max_surface_points)

    rounds = max(reg.n_search_rounds, 1)
    iters = -(-reg.max_iterations // rounds)  # ceil split
    # Candidates stay valid while the pose moved less than ~half the
    # smaller map voxel since they were gathered.
    refresh_threshold = 0.5 * min(reg.edge_map.voxel_size,
                                  reg.surface_map.voxel_size)

    def one_round(pose: Pose) -> gn.GNResult:
        cand_e, ok_e = vg.neighborhood_candidates(
            maps.edge, pose.apply_each_fma(edge_pts))
        cand_s, ok_s = vg.neighborhood_candidates(
            maps.surface, pose.apply_each_fma(surf_ds))
        if reg.refit_per_iteration:
            def problem_fn(p: Pose) -> gn.Problem:
                eb = edge_residuals_from_candidates(
                    cand_e, ok_e, edge_pts, edge_valid, p, reg.n_neighbors)
                sb = surface_residuals_from_candidates(
                    cand_s, ok_s, surf_ds, surf_ds_valid, p,
                    reg.n_neighbors)
                return gn.make_problem([eb, sb])
        else:
            # Neighbour selection and fits depend only on the candidate
            # sets: made once per round, outside the GN loop.
            eg = fit_edge_geometry(cand_e, ok_e, edge_pts, edge_valid,
                                   pose, reg.n_neighbors)
            sg = fit_surface_geometry(cand_s, ok_s, surf_ds,
                                      surf_ds_valid, pose, reg.n_neighbors)

            def problem_fn(p: Pose) -> gn.Problem:
                return gn.make_problem([
                    edge_rows_from_geometry(eg, edge_pts, p),
                    surface_rows_from_geometry(sg, surf_ds, p)])

        return _gauss_newton(problem_fn, pose, cfg, iters)

    result = one_round(prior)
    prev_pose = prior
    for _ in range(rounds - 1):
        # Run again when the round moved the pose out of its candidate
        # neighbourhoods, or (fits frozen per round) ended at an error-
        # or scale-increase abort, which may be an artifact of the
        # frozen problem. Per scan of a batch.
        moved = quat._norm(result.pose.t - prev_pose.t) > refresh_threshold
        aborted = ((result.status == gn.ERROR_INCREASED)
                   | (result.status == gn.SCALE_INCREASED))
        rerun = moved | (aborted & (not reg.refit_per_iteration))
        prev_pose = result.pose
        if bool(rerun.any()):   # the one readback per round
            # Under the reference's vmap the cond is a select per scan:
            # every scan runs the round, and one that does not run again
            # keeps its whole result.
            result = _select_scans(rerun, one_round(result.pose), result)
    return result


def _select_scans(take: torch.Tensor, new: gn.GNResult,
                  old: gn.GNResult) -> gn.GNResult:
    """``new`` where ``take`` (0-d, or [B] for a batch), else ``old``,
    field by field."""
    def pick(n, o):
        return torch.where(take.reshape(take.shape + (1,) * (
            n.dim() - take.dim())), n, o)

    return gn.GNResult(Pose(pick(new.pose.q, old.pose.q),
                            pick(new.pose.t, old.pose.t)),
                       *(pick(n, o) for n, o in zip(new[1:], old[1:])))


def localize_scan(maps, image: RangeImage, prior: Pose,
                  cfg: PipelineConfig):
    """Per-scan hot path: extraction + registration. With
    ``cfg.compact_extraction`` and ``GeometryMaps``, the compact
    extraction feeds ``register_scan_geometry`` pre-downsampled;
    otherwise the full extraction feeds ``register_scan_geometry``
    (``GeometryMaps``) or ``register_scan`` (``FeatureMaps``).
    Returns (GNResult, features)."""
    ex = cfg.extraction
    if cfg.compact_extraction and isinstance(maps, GeometryMaps):
        feats = extract_features_compact(
            image, ex,
            surface_leaf=cfg.registration.surface_downsample_leaf,
            edges_per_ring=ex.edges_per_ring,
            surface_runs_per_ring=ex.surface_runs_per_ring,
            surface_centroid=ex.compact_surface_centroid)
        result = register_scan_geometry(
            maps, feats.edge_xyz, feats.edge_valid,
            feats.surface_xyz, feats.surface_valid, prior, cfg,
            pre_downsampled=True)
        return result, feats
    feats = extract_features(image, ex)
    register = (register_scan_geometry
                if isinstance(maps, GeometryMaps) else register_scan)
    result = register(maps, feats.edge_xyz, feats.edge_valid,
                      feats.surface_xyz, feats.surface_valid, prior, cfg)
    return result, feats


def localize_scans(maps, images: RangeImage, priors: Pose,
                   cfg: PipelineConfig):
    """B independent scans through one extraction and one lock-step
    Gauss-Newton loop: ``images`` a batch ([B, R, P, 3] xyz,
    ``core.scan.stack_range_images``), ``priors`` q [B, 4] and t [B, 3],
    ``maps`` shared by every scan. Each scan's result is the one
    ``localize_scan`` gives it alone (the reference's ``vmap`` of
    ``localize_scan``). Returns (GNResult with [B] fields, features with
    [B] fields).

    Every branch of ``localize_scan`` takes the batch: the compact or
    the full extraction (on CUDA tensors one K1 launch for the batch),
    then ``register_scan_geometry`` (``GeometryMaps``) or the kNN rounds
    of ``register_scan`` (``FeatureMaps``)."""
    if images.xyz.dim() != 4 or priors.t.shape != (images.xyz.shape[0], 3):
        raise ValueError(f"localize_scans: needs a batch of images and "
                         f"priors, got xyz {tuple(images.xyz.shape)} and "
                         f"t {tuple(priors.t.shape)}")
    return localize_scan(maps, images, priors, cfg)


class HostLocalizer:
    """Scan-to-map localizer over fixed maps, one scan at a time, with
    the reference's host-side loop control (see the module docstring):
    ``register`` for extracted features, ``localize`` for a range image.
    Everything stays on the maps' device."""

    def __init__(self, maps, cfg: PipelineConfig):
        self.maps = maps
        self.cfg = cfg
        self._compact = (cfg.compact_extraction
                         and isinstance(maps, GeometryMaps))

    def _extract(self, image: RangeImage):
        ex = self.cfg.extraction
        if self._compact:
            return extract_features_compact(
                image, ex,
                surface_leaf=self.cfg.registration.surface_downsample_leaf,
                edges_per_ring=ex.edges_per_ring,
                surface_runs_per_ring=ex.surface_runs_per_ring,
                surface_centroid=ex.compact_surface_centroid)
        return extract_features(image, ex)

    def _downsample(self, pts, valid):
        reg = self.cfg.registration
        return voxel_downsample(pts, valid, reg.surface_downsample_leaf,
                                reg.max_surface_points)

    def _gather(self, e_pts, s_pts, pose: Pose):
        """The 27-voxel candidate sets of both maps at ``pose``."""
        ce, oe = vg.neighborhood_candidates(self.maps.edge,
                                            pose.apply_each_fma(e_pts))
        cs, os_ = vg.neighborhood_candidates(self.maps.surface,
                                             pose.apply_each_fma(s_pts))
        return ce, oe, cs, os_

    def _fit(self, e_pts, e_valid, s_pts, s_valid, pose: Pose):
        """Candidates, neighbour selection and line/plane fits, once per
        search round."""
        ce, oe, cs, os_ = self._gather(e_pts, s_pts, pose)
        k = self.cfg.registration.n_neighbors
        return (fit_edge_geometry(ce, oe, e_pts, e_valid, pose, k),
                fit_surface_geometry(cs, os_, s_pts, s_valid, pose, k))

    def _iterate(self, blocks, pose: Pose) -> gn.GNStep:
        reg = self.cfg.registration
        return gn.gn_iteration(gn.make_problem(blocks), pose,
                               reg.huber_k, reg.degeneracy_threshold)

    def _light_step(self, eg, sg, e_pts, s_pts, pose: Pose) -> gn.GNStep:
        return self._iterate([edge_rows_from_geometry(eg, e_pts, pose),
                              surface_rows_from_geometry(sg, s_pts, pose)],
                             pose)

    def _step(self, cand, e_pts, e_valid, s_pts, s_valid,
              pose: Pose) -> gn.GNStep:
        ce, oe, cs, os_ = cand
        k = self.cfg.registration.n_neighbors
        return self._iterate([
            edge_residuals_from_candidates(ce, oe, e_pts, e_valid, pose, k),
            surface_residuals_from_candidates(cs, os_, s_pts, s_valid, pose,
                                              k)], pose)

    def _geometry_step(self, e_pts, e_valid, s_pts, s_valid,
                       pose: Pose) -> gn.GNStep:
        maps, k = self.maps, self.cfg.registration.min_fit_points
        if maps.fused is not None:
            blocks = gg.fused_rows_from_grids(
                maps.edge, maps.surface, maps.fused, e_pts, e_valid, s_pts,
                s_valid, pose, k)
        else:
            blocks = (gg.edge_rows_from_grid(maps.edge, e_pts, e_valid, pose,
                                             k),
                      gg.surface_rows_from_grid(maps.surface, s_pts, s_valid,
                                                pose, k))
        return self._iterate(blocks, pose)

    def register(self, edge_pts, edge_valid, surf_pts, surf_valid,
                 prior: Pose) -> gn.GNResult:
        """Register one scan's features ([N, 3] points + [N] masks)."""
        reg = self.cfg.registration
        if isinstance(self.maps, GeometryMaps):
            if self._compact:
                # The compact extraction already voxel-thinned the surfaces.
                surf_ds, surf_ds_valid = surf_pts, surf_valid
            else:
                surf_ds, surf_ds_valid = self._downsample(surf_pts,
                                                          surf_valid)
            return gn.run_gauss_newton_host(
                lambda p: self._geometry_step(edge_pts, edge_valid, surf_ds,
                                              surf_ds_valid, p),
                prior, reg.max_iterations, reg.convergence_tol)

        surf_ds, surf_ds_valid = self._downsample(surf_pts, surf_valid)
        rounds = max(reg.n_search_rounds, 1)
        iters = -(-reg.max_iterations // rounds)  # ceil split
        refresh_threshold = 0.5 * min(reg.edge_map.voxel_size,
                                      reg.surface_map.voxel_size)
        pose, result = prior, None
        for _ in range(rounds):
            if reg.refit_per_iteration:
                cand = self._gather(edge_pts, surf_ds, pose)

                def step_fn(p, cand=cand):
                    return self._step(cand, edge_pts, edge_valid, surf_ds,
                                      surf_ds_valid, p)
            else:
                eg, sg = self._fit(edge_pts, edge_valid, surf_ds,
                                   surf_ds_valid, pose)

                def step_fn(p, eg=eg, sg=sg):
                    return self._light_step(eg, sg, edge_pts, surf_ds, p)

            result, status = gn._run_host(step_fn, pose, iters,
                                          reg.convergence_tol)
            start, pose = pose, result.pose
            if status in (gn.CONVERGED, gn.EMPTY_INPUT):
                break
            if (status in (gn.ERROR_INCREASED, gn.SCALE_INCREASED)
                    and not reg.refit_per_iteration):
                continue  # refresh: the abort may come of the frozen fits
            # One read per round: did the pose leave the candidates'
            # neighbourhoods?
            if float(quat._norm(pose.t - start.t)) <= refresh_threshold:
                break
        return result

    def localize(self, image: RangeImage, prior: Pose):
        """Extraction (on CUDA tensors one K1 launch) + ``register``.
        Returns (GNResult, features)."""
        feats = self._extract(image)
        result = self.register(feats.edge_xyz, feats.edge_valid,
                               feats.surface_xyz, feats.surface_valid,
                               prior)
        return result, feats
