"""Visualization exports: coloured point clouds and trajectories to PLY.

Port of ``lidar_feature_extraction_tpu/utils/visualize.py``: the
reference's rviz debug topics become PLY files that any viewer (MeshLab,
CloudCompare, Open3D) opens. The writers are numpy; the coloured-label
cloud (the reference's ``colored_scan`` topic) takes its colours from
``ops/color.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.ops.color import color_by_label


def save_ply(path: str, xyz: np.ndarray,
             rgb: np.ndarray | None = None) -> None:
    """Write points (+ optional uint8 colours) as binary little-endian
    PLY."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = len(xyz)
    has_color = rgb is not None
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = xyz
            rec["rgb"] = np.ascontiguousarray(rgb, np.uint8)
            f.write(rec.tobytes())
        else:
            f.write(xyz.tobytes())


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def export_labeled_scan(path: str, image_xyz, mask, labels) -> None:
    """The ``colored_scan`` debug cloud as PLY: the image's valid points
    ([R, P, 3] and [R, P], tensors or arrays) coloured by their labels."""
    m = _np(mask).reshape(-1)
    pts = _np(image_xyz).reshape(-1, 3)[m]
    rgb = _np(color_by_label(torch.as_tensor(labels))).reshape(-1, 3)[m]
    save_ply(path, pts, rgb)


def export_trajectory(path: str, positions: np.ndarray,
                      color=(255, 200, 0)) -> None:
    pts = np.asarray(positions, np.float32)
    rgb = np.tile(np.asarray(color, np.uint8), (len(pts), 1))
    save_ply(path, pts, rgb)
