"""KITTI odometry dataset readers.

Numpy copy of ``lidar_feature_extraction_tpu/io/kitti.py`` (the port
imports nothing of the JAX package). KITTI velodyne ``.bin`` scans are
float32 (x, y, z, intensity) records; ring indices are not stored, so
they are recovered from the elevation angle (the HDL-64E beam model).
The reference reads the files through its native shim when it is built
and through ``np.fromfile`` otherwise, with identical arrays; the port
reads them with ``np.fromfile``.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

# HDL-64E vertical field of view (degrees).
_HDL64_UP = 2.0
_HDL64_DOWN = -24.8


def read_velodyne_bin(path: str) -> np.ndarray:
    """Load one KITTI scan: [N, 4] float32 (x, y, z, intensity)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def write_velodyne_bin(path: str, xyz: np.ndarray,
                       intensity: np.ndarray | None = None) -> None:
    """Write points [N, 3] (and intensities [N], zeros if absent) as one
    KITTI ``.bin`` scan."""
    xyz = np.asarray(xyz, np.float32)
    inten = (np.zeros(len(xyz), np.float32) if intensity is None
             else np.asarray(intensity, np.float32))
    np.concatenate([xyz, inten[:, None]], axis=-1).tofile(path)


def estimate_rings(xyz: np.ndarray, n_rings: int = 64,
                   fov_up: float = _HDL64_UP,
                   fov_down: float = _HDL64_DOWN) -> np.ndarray:
    """Ring index from elevation angle (uniform beam-angle model)."""
    d = np.linalg.norm(xyz[:, :2], axis=-1)
    elev = np.degrees(np.arctan2(xyz[:, 2], np.maximum(d, 1e-9)))
    frac = (fov_up - elev) / (fov_up - fov_down)
    ring = np.floor(frac * n_rings).astype(np.int32)
    return np.clip(ring, 0, n_rings - 1)


def scan_files(sequence_dir: str) -> list[str]:
    files = sorted(f for f in os.listdir(sequence_dir) if f.endswith(".bin"))
    return [os.path.join(sequence_dir, f) for f in files]


def iter_scans(sequence_dir: str, limit: int | None = None
               ) -> Iterator[np.ndarray]:
    for path in scan_files(sequence_dir)[:limit]:
        yield read_velodyne_bin(path)


def load_poses(path: str) -> np.ndarray:
    """KITTI odometry ground-truth poses: [N, 3, 4] row-major."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    return raw.astype(np.float64)
