"""Voxel-grid centroid downsampling with fixed-capacity output.

Port of ``lidar_feature_extraction_tpu/ops/downsample.py:20-95``: points
are bucketed by voxel and each occupied voxel emits the centroid of its
points (``pcl::VoxelGrid``'s contract).

- ``voxel_downsample``: one stable argsort of the packed voxel keys, then
  a segmented sum. The reference's ``.at[].add(mode="drop")`` is a
  scatter-add into a ``capacity + 1``-row buffer whose last row takes
  every point past the capacity and every masked point. A batch of
  clouds [B, N, 3] (the reference's ``vmap``) sorts lane by lane and
  gives each lane its own rows, dump row included.
- ``voxel_downsample_dense``: the same without a sort, as a scatter-add
  over a dense scan-local grid.

The sums go through ``ops/scatter.py``: on the card each voxel's points
add in a fixed order, so a centroid has the same bits every run, and a
lane of a batch the bits of its lone call. Counts and validity are
exact.
"""

from __future__ import annotations

import torch

from lidar_feature_extraction_tpu_torch.ops.scatter import index_add_rows
from lidar_feature_extraction_tpu_torch.ops.voxel_map import (_EMPTY,
                                                              _pack_coords)


def voxel_downsample(xyz: torch.Tensor, mask: torch.Tensor, voxel_size,
                     capacity: int):
    """Centroid per occupied voxel of the masked points [N, 3], or of
    each cloud of a batch [B, N, 3] (masks [B, N]).

    Returns (points [capacity, 3], valid [capacity]) in packed-key
    order, with a leading [B] for a batch. Voxels beyond ``capacity``
    are dropped."""
    lone = xyz.dim() == 2
    if lone:
        xyz, mask = xyz[None], mask[None]
    dtype, dev = xyz.dtype, xyz.device
    B = xyz.shape[0]
    origin = torch.zeros(3, dtype=dtype, device=dev)
    key = torch.where(mask, _pack_coords(xyz, voxel_size, origin),
                      torch.full(mask.shape, _EMPTY, dtype=torch.int32,
                                 device=dev))
    order = torch.argsort(key, dim=-1, stable=True)
    skey = torch.gather(key, 1, order)
    sxyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    valid = skey != _EMPTY

    first = torch.ones_like(valid)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first = first & valid
    seg = torch.cumsum(first.to(torch.int32), 1, dtype=torch.int32) - 1
    seg = torch.where(valid & (seg >= 0), seg, torch.full_like(seg, capacity))
    # Lane b owns rows [b * (capacity + 1), (b + 1) * (capacity + 1)).
    lane = torch.arange(B, device=dev)[:, None] * (capacity + 1)
    rows = (torch.clamp_max(seg, capacity).to(torch.int64) + lane).reshape(-1)

    sums = torch.zeros((B * (capacity + 1), 3), dtype=dtype, device=dev)
    index_add_rows(sums, rows,
                   torch.where(valid[..., None], sxyz, 0.0).reshape(-1, 3))
    cnts = torch.zeros(B * (capacity + 1), dtype=dtype, device=dev)
    index_add_rows(cnts, rows, valid.to(dtype).reshape(-1))
    sums = sums.reshape(B, capacity + 1, 3)[:, :capacity]
    cnts = cnts.reshape(B, capacity + 1)[:, :capacity]

    n_voxels = torch.sum(first.to(torch.int32), dim=1)
    out_valid = (torch.arange(capacity, device=dev)
                 < torch.clamp_max(n_voxels, capacity)[:, None])
    pts = sums / torch.clamp_min(cnts[..., None], 1.0)
    pts = torch.where(out_valid[..., None], pts, 0.0)
    return (pts[0], out_valid[0]) if lone else (pts, out_valid)


def voxel_downsample_dense(xyz: torch.Tensor, mask: torch.Tensor,
                           voxel_size, capacity: int,
                           grid_dims: tuple[int, int, int]):
    """Sort-free centroid downsample over a dense scan-local grid
    anchored at the scan's voxel minimum. Same contract as
    ``voxel_downsample``; output in raveled-cell order, and points
    outside ``grid_dims`` voxels of the minimum are dropped."""
    dtype, dev = xyz.dtype, xyz.device
    nx, ny, nz = grid_dims
    cells_cap = nx * ny * nz

    c = torch.floor(xyz / torch.as_tensor(voxel_size, dtype=dtype,
                                          device=dev)).to(torch.int32)
    big = torch.iinfo(torch.int32).max
    cmin = torch.amin(torch.where(mask[:, None], c, torch.full_like(c, big)),
                      dim=0)
    c = c - cmin
    inside = (mask & (c[..., 0] >= 0) & (c[..., 0] < nx)
              & (c[..., 1] >= 0) & (c[..., 1] < ny)
              & (c[..., 2] >= 0) & (c[..., 2] < nz))
    cell = (c[..., 0] * ny + c[..., 1]) * nz + c[..., 2]
    cell = torch.where(inside, cell, torch.full_like(cell, cells_cap))
    cell = cell.to(torch.int64)

    sums = torch.zeros((cells_cap + 1, 3), dtype=dtype, device=dev)
    index_add_rows(sums, cell, torch.where(inside[:, None], xyz, 0.0))
    cnts = torch.zeros(cells_cap + 1, dtype=dtype, device=dev)
    index_add_rows(cnts, cell, inside.to(dtype))

    # jnp.nonzero(size=capacity, fill_value=cells_cap) without a host
    # read: the rank of each occupied cell, scattered into ``capacity``
    # slots prefilled with the fill value.
    occupied = cnts[:cells_cap] > 0
    rank = torch.cumsum(occupied.to(torch.int64), 0) - 1
    dest = torch.where(occupied & (rank < capacity), rank,
                       torch.full_like(rank, capacity))
    sel = torch.full((capacity + 1,), cells_cap, dtype=torch.int64,
                     device=dev)
    sel.scatter_(0, dest, torch.arange(cells_cap, device=dev))
    sel = sel[:capacity]
    out_valid = sel < cells_cap
    sel_c = torch.clamp_max(sel, cells_cap - 1)
    pts = sums[sel_c] / torch.clamp_min(cnts[sel_c, None], 1.0)
    return torch.where(out_valid[:, None], pts, 0.0), out_valid
