"""Dense direct-addressed voxel grid addressing.

Port of ``lidar_feature_extraction_tpu/ops/voxel_grid.py:42-108``: the
cell of a point, its raveled index (out-of-grid cells go to the dump
index ``nx*ny*nz``), and the grid that covers a bounding box.
"""

from __future__ import annotations

import numpy as np
import torch


def _cell_of(xyz: torch.Tensor, voxel_size, origin) -> torch.Tensor:
    return torch.floor((xyz - origin) / voxel_size).to(torch.int32)


def _ravel(c: torch.Tensor, dims) -> torch.Tensor:
    nx, ny, nz = dims
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    inside = ((x >= 0) & (x < nx) & (y >= 0) & (y < ny)
              & (z >= 0) & (z < nz))
    idx = (x * ny + y) * nz + z
    return torch.where(inside, idx, torch.full_like(idx, nx * ny * nz))


def grid_for_bounds(lo, hi, voxel_size, margin_voxels: int = 2):
    """(origin, dims) covering the AABB [lo, hi] plus a margin; the
    origin snaps to the global voxel lattice."""
    lo = (np.floor(np.asarray(lo, np.float64) / voxel_size)
          - margin_voxels) * voxel_size
    hi = np.asarray(hi, np.float64) + margin_voxels * voxel_size
    dims = tuple(int(d) for d in
                 np.maximum(np.ceil((hi - lo) / voxel_size), 1).astype(int))
    return lo.astype(np.float32), dims
