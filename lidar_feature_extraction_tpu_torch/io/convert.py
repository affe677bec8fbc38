"""Generic point-cloud ingestion: arbitrary structured layouts -> the
engine's (xyz, intensity, ring, valid) arrays.

Numpy copy of ``lidar_feature_extraction_tpu/io/convert.py`` (the port
imports nothing of the JAX package): the reference's
``point_type_converter`` node repacks per-point records into the
canonical layout, dropping (0, 0, 0) points. Sources: structured numpy
arrays (any field naming) and raw interleaved float32 (KITTI style).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from lidar_feature_extraction_tpu_torch.io.kitti import estimate_rings

_XYZ_NAMES = ("x", "y", "z")
_INTENSITY_NAMES = ("intensity", "i", "reflectivity")
_RING_NAMES = ("ring", "laser_id", "channel")


class CanonicalScan(NamedTuple):
    xyz: np.ndarray        # [N, 3] float32
    intensity: np.ndarray  # [N] float32 (zeros if absent)
    ring: np.ndarray       # [N] int32 (estimated if absent)
    valid: np.ndarray      # [N] bool


def _find_field(names, fields) -> Optional[str]:
    for n in names:
        if n in fields:
            return n
    return None


def _valid(xyz: np.ndarray) -> np.ndarray:
    """Drop (0, 0, 0) points like the reference, and non-finite ones."""
    return ~np.all(xyz == 0.0, axis=-1) & np.isfinite(xyz).all(axis=-1)


def from_structured(arr: np.ndarray, n_rings: int = 64) -> CanonicalScan:
    """Convert a structured array with at least x/y/z fields."""
    fields = arr.dtype.names or ()
    for axis in _XYZ_NAMES:
        if axis not in fields:
            raise ValueError(f"missing coordinate field {axis!r}; "
                             f"have {fields}")
    xyz = np.stack([arr["x"], arr["y"], arr["z"]],
                   axis=-1).astype(np.float32)
    f_int = _find_field(_INTENSITY_NAMES, fields)
    intensity = (arr[f_int].astype(np.float32) if f_int
                 else np.zeros(len(arr), np.float32))
    f_ring = _find_field(_RING_NAMES, fields)
    ring = (arr[f_ring].astype(np.int32) if f_ring
            else estimate_rings(xyz, n_rings))
    return CanonicalScan(xyz=xyz, intensity=intensity, ring=ring,
                         valid=_valid(xyz))


def from_raw_f32(data: np.ndarray, point_step: int = 4,
                 n_rings: int = 64) -> CanonicalScan:
    """Interleaved float32 records [x, y, z, intensity, ...]."""
    pts = np.asarray(data, np.float32).reshape(-1, point_step)
    xyz = pts[:, :3]
    intensity = (pts[:, 3] if point_step > 3
                 else np.zeros(len(pts), np.float32))
    return CanonicalScan(xyz=xyz, intensity=intensity,
                         ring=estimate_rings(xyz, n_rings),
                         valid=_valid(xyz))

