"""Trajectory accumulation and the map frame's viewer transform.

Port of ``lidar_feature_extraction_tpu/pipeline/trajectory.py`` (numpy
over the port's ``Pose``): the reference's ``path_generator`` node
accumulates poses into a path, and its ``map_tf_generator`` broadcasts a
static map -> viewer translation at the map cloud's centroid.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.core.pose import Pose


def _np(a) -> np.ndarray:
    """A tensor (read back to the host) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class PathAccumulator:
    """Append poses; export as arrays (positions + wxyz quaternions) or
    as a TUM trajectory file."""

    def __init__(self):
        self._q = []
        self._t = []
        self._stamps = []

    def append(self, pose: Pose, stamp: float | None = None) -> None:
        """One pose (read back to the host) and its stamp, the pose's
        index when none is given."""
        self._q.append(np.asarray(_np(pose.q), np.float64))
        self._t.append(np.asarray(_np(pose.t), np.float64))
        self._stamps.append(stamp if stamp is not None else len(self._q) - 1)

    def __len__(self) -> int:
        return len(self._q)

    @property
    def positions(self) -> np.ndarray:
        return np.stack(self._t) if self._t else np.zeros((0, 3))

    @property
    def quaternions(self) -> np.ndarray:
        return np.stack(self._q) if self._q else np.zeros((0, 4))

    @property
    def stamps(self) -> np.ndarray:
        return np.asarray(self._stamps)

    def save_tum(self, path: str) -> None:
        """TUM trajectory format: stamp x y z qx qy qz qw."""
        with open(path, "w") as f:
            for s, t, q in zip(self._stamps, self._t, self._q):
                f.write(f"{s} {t[0]} {t[1]} {t[2]} "
                        f"{q[1]} {q[2]} {q[3]} {q[0]}\n")


def map_viewer_transform(map_points, valid=None) -> np.ndarray:
    """Centroid of the map cloud [N, 3] (of its ``valid`` points): the
    static map -> viewer translation."""
    pts = _np(map_points)
    if valid is not None:
        pts = pts[_np(valid)]
    if len(pts) == 0:
        return np.zeros(3)
    return pts.mean(axis=0)
