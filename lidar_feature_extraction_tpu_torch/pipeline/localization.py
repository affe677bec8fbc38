"""Scan-to-map localization: extraction + Gauss-Newton registration
against precomputed-geometry maps.

Port of the compact + ``GeometryMaps`` branch of
``lidar_feature_extraction_tpu/pipeline/localization.py`` (``GeometryMaps``,
``build_geometry_maps``, ``register_scan_geometry`` and ``localize_scan``,
lines 50-281). The other branches (the kNN ``FeatureMaps`` path, the
surface voxel downsample, ``HostLocalizer``) are not ported and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.core.scan import RangeImage
from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
from lidar_feature_extraction_tpu_torch.ops import geometry_grid as gg
from lidar_feature_extraction_tpu_torch.ops import voxel_grid as vg
from lidar_feature_extraction_tpu_torch.ops.extraction import (
    extract_features_compact)


class GeometryMaps(NamedTuple):
    """Precomputed-geometry feature maps: per-voxel line/plane fits,
    baked at build time. ``fused`` is the concatenated edge+surface
    record table (``gg.fuse_record_tables``) that registration gathers
    from once per iteration."""

    edge: gg.GeometryGrid
    surface: gg.GeometryGrid
    fused: torch.Tensor = None


def _bounds(xyz: torch.Tensor, mask: torch.Tensor):
    pts = xyz.detach().cpu().numpy()[mask.detach().cpu().numpy()]
    if len(pts) == 0:
        return np.zeros(3, np.float32), np.ones(3, np.float32)
    return pts.min(axis=0), pts.max(axis=0)


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


def register_scan_geometry(maps: GeometryMaps, edge_pts, edge_valid,
                           surf_pts, surf_valid, prior: Pose,
                           cfg: PipelineConfig,
                           pre_downsampled: bool = False) -> gn.GNResult:
    """Gauss-Newton registration against precomputed-geometry maps, the
    voxel lookup re-done every iteration. Only ``pre_downsampled=True``
    (surfaces already voxel-thinned by ``extract_features_compact``) is
    ported."""
    if not pre_downsampled:
        raise NotImplementedError(
            "the surface voxel downsample is not ported; pass features "
            "from extract_features_compact with pre_downsampled=True")
    if maps.fused is None:
        raise NotImplementedError("GeometryMaps without a fused table")
    reg = cfg.registration

    def problem_fn(p: Pose) -> gn.Problem:
        eb, sb = gg.fused_rows_from_grids(
            maps.edge, maps.surface, maps.fused, edge_pts, edge_valid,
            surf_pts, surf_valid, p, reg.min_fit_points)
        return gn.make_problem([eb, sb])

    return gn.run_gauss_newton(
        problem_fn, prior,
        max_iterations=reg.max_iterations,
        convergence_tol=reg.convergence_tol,
        huber_k=reg.huber_k,
        degeneracy_threshold=reg.degeneracy_threshold)


def localize_scan(maps: GeometryMaps, image: RangeImage, prior: Pose,
                  cfg: PipelineConfig):
    """Per-scan hot path: compact extraction + registration.
    Returns (GNResult, CompactFeatures)."""
    if not (cfg.compact_extraction and isinstance(maps, GeometryMaps)):
        raise NotImplementedError(
            "only the compact extraction + GeometryMaps branch is ported")
    ex = cfg.extraction
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
