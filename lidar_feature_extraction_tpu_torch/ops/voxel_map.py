"""Packed voxel keys of the voxel-hash point map.

Port of the key packing of ``lidar_feature_extraction_tpu/ops/
voxel_map.py:34-68``, which ``ops/downsample.py`` sorts by. Coordinates
are packed map-locally into one int32: x, y in [-1024, 1024) voxels,
z in [-256, 256) voxels relative to ``origin``; a point outside that
volume gets ``_EMPTY``. The hash map itself is not ported yet.
"""

from __future__ import annotations

import torch

_XY_BITS = 11  # +/- 1024 voxels
_Z_BITS = 9    # +/- 256 voxels
_XY_HALF = 1 << (_XY_BITS - 1)
_Z_HALF = 1 << (_Z_BITS - 1)
_EMPTY = 0x7FFFFFFF  # sorts last, never a valid packed key


def _pack_coords(xyz: torch.Tensor, voxel_size, origin) -> torch.Tensor:
    """Points [..., 3] -> int32 packed voxel key; _EMPTY if out of volume."""
    c = torch.floor((xyz - origin) / voxel_size).to(torch.int32)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    inside = ((x >= -_XY_HALF) & (x < _XY_HALF)
              & (y >= -_XY_HALF) & (y < _XY_HALF)
              & (z >= -_Z_HALF) & (z < _Z_HALF))
    key = (((x + _XY_HALF) << (_XY_BITS + _Z_BITS))
           | ((y + _XY_HALF) << _Z_BITS)
           | (z + _Z_HALF))
    return torch.where(inside, key, torch.full_like(key, _EMPTY))
