"""State carried across from numpy arrays: maps, pose, scan, odometry
state, the chunked front end's carry, pose and IMU graphs, their factors
and preintegrated windows.

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
from lidar_feature_extraction_tpu_torch.fusion.imu import ImuPreintegration
from lidar_feature_extraction_tpu_torch.ops import geometry_grid as gg
from lidar_feature_extraction_tpu_torch.ops import voxel_grid as vg
from lidar_feature_extraction_tpu_torch.parallel.imu_graph import (
    ImuFactors, ImuGraph)
from lidar_feature_extraction_tpu_torch.parallel.pose_graph import (
    Constraints, PoseGraph)
from lidar_feature_extraction_tpu_torch.pipeline.localization import (
    FeatureMaps, GeometryMaps)
from lidar_feature_extraction_tpu_torch.pipeline.mapping_chunk import (
    ChunkCarry)
from lidar_feature_extraction_tpu_torch.pipeline.odometry import (
    GeometryOdometryState, OdometryState)


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


def range_images_from_numpy(xyz, mask, count, device="cuda") -> RangeImage:
    """A batch of B range images from stacked xyz [B, R, P, 3], mask
    [B, R, P] and count [B, R] (``np.stack`` of B single images)."""
    xyz, mask, count = np.asarray(xyz), np.asarray(mask), np.asarray(count)
    if xyz.ndim != 4 or mask.shape != xyz.shape[:3] \
            or count.shape != xyz.shape[:2]:
        raise ValueError(f"range_images_from_numpy: needs [B, R, P, 3], "
                         f"[B, R, P] and [B, R], got {xyz.shape}, "
                         f"{mask.shape}, {count.shape}")
    return range_image_from_numpy(xyz, mask, count, device)


def poses_from_numpy(q, t, device="cuda") -> Pose:
    """A batch of B poses from wxyz quaternions [B, 4] and translations
    [B, 3]."""
    q, t = np.asarray(q), np.asarray(t)
    if q.ndim != 2 or q.shape[-1] != 4 or t.shape != q.shape[:1] + (3,):
        raise ValueError(f"poses_from_numpy: needs [B, 4] and [B, 3], got "
                         f"{q.shape} and {t.shape}")
    return pose_from_numpy(q, t, device)


def _auto(a, device) -> torch.Tensor | None:
    """An array as a tensor: booleans stay bool, integers become int32,
    floats float32. None stays None (an optional field)."""
    if a is None:
        return None
    a = np.asarray(a)
    dtype = (torch.bool if a.dtype.kind == "b" else
             torch.int32 if a.dtype.kind in "iu" else torch.float32)
    return _t(a, dtype, device)


def _tuple_from_numpy(cls, values, device):
    return cls(*[_auto(v, device) for v in values])


def pose_graph_from_numpy(poses_q, poses_t, device="cuda") -> PoseGraph:
    """PoseGraph from quaternions [K, 4] and translations [K, 3]."""
    return _tuple_from_numpy(PoseGraph, (poses_q, poses_t), device)


def constraints_from_numpy(i, j, z_q, z_t, weight, info=None,
                           device="cuda") -> Constraints:
    """Constraints from keyframe indices [M], measured relative poses
    ([M, 4], [M, 3]), weights [M] and optional information [M, 6, 6]."""
    return _tuple_from_numpy(Constraints, (i, j, z_q, z_t, weight, info),
                             device)


def imu_graph_from_numpy(poses_q, poses_t, vels, bg=None, ba=None,
                         device="cuda") -> ImuGraph:
    """ImuGraph from poses ([K, 4], [K, 3]), velocities [K, 3] and the
    optional shared biases [3]."""
    return _tuple_from_numpy(ImuGraph, (poses_q, poses_t, vels, bg, ba),
                             device)


def imu_factors_from_numpy(i, j, dq, dv, dp, dt, w_rot, w_vel, w_pos, weight,
                           dq_dbg=None, dv_dbg=None, dv_dba=None, dp_dbg=None,
                           dp_dba=None, device="cuda") -> ImuFactors:
    """ImuFactors from the stacked fields of ``ImuFactors``, in its
    order (the bias Jacobians [M, 3, 3] optional)."""
    return _tuple_from_numpy(
        ImuFactors, (i, j, dq, dv, dp, dt, w_rot, w_vel, w_pos, weight,
                     dq_dbg, dv_dbg, dv_dba, dp_dbg, dp_dba), device)


def imu_preintegration_from_numpy(dq, dv, dp, dt, dq_dbg, dv_dbg, dv_dba,
                                  dp_dbg, dp_dba, cov,
                                  device="cuda") -> ImuPreintegration:
    """ImuPreintegration from its fields, in its order."""
    return _tuple_from_numpy(
        ImuPreintegration, (dq, dv, dp, dt, dq_dbg, dv_dbg, dv_dba, dp_dbg,
                            dp_dba, cov), device)


def odometry_state_from_numpy(edge_window, edge_mask, surf_window, surf_mask,
                              slot, n_scans, pose_q, pose_t,
                              device="cuda") -> OdometryState:
    """OdometryState (the point-grid window) from its fields, in its
    order."""
    return _tuple_from_numpy(
        OdometryState, (edge_window, edge_mask, surf_window, surf_mask, slot,
                        n_scans, pose_q, pose_t), device)


def geometry_odometry_state_from_numpy(edge_m, surf_m, edge_origin,
                                       surf_origin, edge_window, edge_mask,
                                       surf_window, surf_mask, slot, n_scans,
                                       pose_q, pose_t, device="cuda"
                                       ) -> GeometryOdometryState:
    """GeometryOdometryState (moment grids + eviction window) from its
    fields, in its order."""
    return _tuple_from_numpy(
        GeometryOdometryState, (edge_m, surf_m, edge_origin, surf_origin,
                                edge_window, edge_mask, surf_window,
                                surf_mask, slot, n_scans, pose_q, pose_t),
        device)


def chunk_carry_from_numpy(odo, prev_q, prev_t, device="cuda") -> ChunkCarry:
    """ChunkCarry from a GeometryOdometryState's fields (``odo``, in its
    order) and the pose before the latest update ([4], [3])."""
    return ChunkCarry(odo=geometry_odometry_state_from_numpy(
        *odo, device=device), prev_q=_auto(prev_q, device),
        prev_t=_auto(prev_t, device))
