"""State carried across from numpy arrays: maps, pose and scan.

The arrays are what ``np.asarray`` gives from the JAX package's
``GeometryMaps`` / ``FeatureMaps`` / ``Pose`` / ``RangeImage`` (or any
other source of the
same layout), so a caller can register with this port against the very
map another implementation built. Nothing here imports JAX. Like every
entry point of the port, each constructor puts its tensors on the CUDA
card unless the caller asks for another device (``device="cpu"``);
without a card the default raises.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.core.scan import RangeImage
from lidar_feature_extraction_tpu_torch.ops import geometry_grid as gg
from lidar_feature_extraction_tpu_torch.ops import voxel_grid as vg
from lidar_feature_extraction_tpu_torch.pipeline.localization import (
    FeatureMaps, GeometryMaps)


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def geometry_maps_from_numpy(edge_rec, edge_voxel, edge_origin, edge_dims,
                             surf_rec, surf_voxel, surf_origin, surf_dims,
                             device="cuda") -> GeometryMaps:
    """GeometryMaps from record tables [C + 1, 8], voxel sizes, origins
    [3] and dims (nx, ny, nz) of the edge and surface grids."""
    f32 = torch.float32
    edge = gg.GeometryGrid(rec=_t(edge_rec, f32, device),
                           voxel_size=_t(edge_voxel, f32, device),
                           origin=_t(edge_origin, f32, device),
                           dims=tuple(int(d) for d in edge_dims))
    surface = gg.GeometryGrid(rec=_t(surf_rec, f32, device),
                              voxel_size=_t(surf_voxel, f32, device),
                              origin=_t(surf_origin, f32, device),
                              dims=tuple(int(d) for d in surf_dims))
    return GeometryMaps(edge=edge, surface=surface,
                        fused=gg.fuse_record_tables(edge, surface))


def feature_maps_from_numpy(edge_points, edge_n_pts, edge_voxel,
                            edge_origin, edge_dims, surf_points,
                            surf_n_pts, surf_voxel, surf_origin, surf_dims,
                            device="cuda") -> FeatureMaps:
    """FeatureMaps from slot grids [C + 1, S, 3], occupancies [C + 1],
    voxel sizes, origins [3] and dims (nx, ny, nz) of the edge and
    surface grids."""
    f32 = torch.float32

    def grid(points, n_pts, voxel, origin, dims):
        return vg.DenseVoxelGrid(points=_t(points, f32, device),
                                 n_pts=_t(n_pts, torch.int32, device),
                                 voxel_size=_t(voxel, f32, device),
                                 origin=_t(origin, f32, device),
                                 dims=tuple(int(d) for d in dims))

    return FeatureMaps(
        edge=grid(edge_points, edge_n_pts, edge_voxel, edge_origin,
                  edge_dims),
        surface=grid(surf_points, surf_n_pts, surf_voxel, surf_origin,
                     surf_dims))


def pose_from_numpy(q, t, device="cuda") -> Pose:
    """Pose from a wxyz quaternion [4] and a translation [3]."""
    return Pose(_t(q, torch.float32, device), _t(t, torch.float32, device))


def range_image_from_numpy(xyz, mask, count, device="cuda") -> RangeImage:
    """RangeImage from xyz [R, P, 3], mask [R, P] and count [R]."""
    return RangeImage(xyz=_t(xyz, torch.float32, device),
                      mask=_t(mask, torch.bool, device),
                      count=_t(count, torch.int32, device))
