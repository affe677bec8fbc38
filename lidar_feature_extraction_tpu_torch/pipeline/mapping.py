"""Keyframe feature-map builder, the open-loop map of the reference's
``mapping`` package (``map.hpp:40-150``).

Port of ``lidar_feature_extraction_tpu/pipeline/mapping.py``: the map is
a fixed-capacity point tensor plus a write cursor on the device, and
each accepted scan is transformed and appended at the cursor.
``jnp.nonzero(size=...)`` becomes a stable sort of the validity flags
and the dropping scatter a write into a dump row, so nothing in
``add_scan`` reads the device; ``MapBuilder.add`` reads its accept flag
once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_feature_extraction_tpu_torch.config import MappingConfig
from lidar_feature_extraction_tpu_torch.core.pose import (
    Pose, pose_delta_magnitudes)


class PointMapState(NamedTuple):
    """Append-only device point buffer."""

    points: torch.Tensor   # [capacity, 3]
    n: torch.Tensor        # scalar int32 write cursor
    prev_pose_q: torch.Tensor
    prev_pose_t: torch.Tensor
    has_prev: torch.Tensor  # bool


def init_point_map(capacity: int, dtype=torch.float32,
                   device="cuda") -> PointMapState:
    return PointMapState(
        points=torch.zeros((capacity, 3), dtype=dtype, device=device),
        n=torch.zeros((), dtype=torch.int32, device=device),
        prev_pose_q=torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device),
        prev_pose_t=torch.zeros(3, dtype=dtype, device=device),
        has_prev=torch.zeros((), dtype=torch.bool, device=device))


def keyframe_gate(state: PointMapState, pose: Pose,
                  cfg: MappingConfig) -> torch.Tensor:
    """True when the scan should be added: the first scan, or a move past
    the translation or rotation threshold (``map.hpp:49-59, 123-129``)."""
    dt, dq = pose_delta_magnitudes(
        Pose(state.prev_pose_q, state.prev_pose_t), pose)
    small = (dt < cfg.keyframe_translation_threshold) \
        & (dq < cfg.keyframe_rotation_threshold)
    return ~state.has_prev | ~small


def add_scan(state: PointMapState, scan_xyz: torch.Tensor,
             scan_valid: torch.Tensor, pose: Pose,
             accept: torch.Tensor) -> PointMapState:
    """Transform the masked scan by ``pose`` and append its valid points,
    compacted, at the cursor (``Map::TransformAdd``, map.hpp:68-73);
    points past the capacity are dropped. With ``accept`` False the
    state comes back unchanged."""
    capacity = state.points.shape[0]
    n_scan = scan_xyz.shape[0]
    dev = scan_xyz.device
    transformed = pose.apply(scan_xyz)

    lane = torch.arange(n_scan, device=dev)
    order = torch.argsort((~scan_valid).to(torch.int8), stable=True)
    n_valid = torch.sum(scan_valid.to(torch.int32))
    ok = (lane < n_valid) & accept
    dst = state.n + lane
    ok = ok & (dst < capacity)
    dst = torch.where(ok, dst, capacity).long()
    buf = torch.cat([state.points, state.points.new_zeros((1, 3))])
    points = buf.index_put((dst,), transformed[order])[:capacity]
    n_new = torch.clamp_max(state.n + torch.sum(ok.to(torch.int32)), capacity)
    return PointMapState(
        points=torch.where(accept, points, state.points),
        n=torch.where(accept, n_new, state.n).to(torch.int32),
        prev_pose_q=torch.where(accept, pose.q, state.prev_pose_q),
        prev_pose_t=torch.where(accept, pose.t, state.prev_pose_t),
        has_prev=state.has_prev | accept)


def map_mask(state: PointMapState) -> torch.Tensor:
    return torch.arange(state.points.shape[0],
                        device=state.points.device) < state.n


class MapBuilder:
    """Host driver of ``MapBuilder`` (map.hpp:96-150): feed (scan, pose)
    pairs; the device state accumulates keyframes."""

    def __init__(self, cfg: MappingConfig, capacity: int | None = None,
                 dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.state = init_point_map(capacity or cfg.max_map_points, dtype,
                                    device)

    def add(self, scan_xyz, scan_valid, pose: Pose) -> bool:
        dev, dtype = self.state.points.device, self.state.points.dtype
        scan_xyz = torch.as_tensor(scan_xyz, dtype=dtype, device=dev)
        scan_valid = torch.as_tensor(scan_valid, dtype=torch.bool, device=dev)
        pose = Pose(torch.as_tensor(pose.q, dtype=dtype, device=dev),
                    torch.as_tensor(pose.t, dtype=dtype, device=dev))
        accept = keyframe_gate(self.state, pose, self.cfg)
        self.state = add_scan(self.state, scan_xyz, scan_valid, pose, accept)
        return bool(accept)

    @property
    def points(self):
        return self.state.points

    @property
    def valid(self):
        return map_mask(self.state)

    def save_pcd(self, path: str) -> None:
        """``SaveMap`` (map.hpp:135-148) through ``io/pcd.py``."""
        from lidar_feature_extraction_tpu_torch.io import pcd

        pts = self.points[self.valid].cpu().numpy()
        pcd.save_pcd(path, pts)
