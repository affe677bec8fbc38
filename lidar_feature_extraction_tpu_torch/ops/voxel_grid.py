"""Dense direct-addressed voxel grid: the correspondence structure of the
kNN registration path for bounded maps.

Port of ``lidar_feature_extraction_tpu/ops/voxel_grid.py:27-147``: the
cell of a point, its raveled index (out-of-grid cells go to the dump
index ``nx*ny*nz``), the grid that covers a bounding box, the slot grid
of map points, the 27-voxel candidate gather and the top-k selection.

Two differences from JAX's primitives are handled here:

- ``jnp.argsort`` is stable; ``torch.argsort`` only with ``stable=True``.
- ``lax.top_k`` breaks ties by the lower index, and every masked
  candidate is a tie at +inf; ``torch.topk`` promises no order among
  ties. The selection is a stable ascending sort of the squared
  distances, first k taken: the same neighbours in the same order, which
  matters because the order feeds the float sums of the line and plane
  fits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf


class DenseVoxelGrid(NamedTuple):
    """points: [C + 1, S, 3] slot storage with C = nx*ny*nz (row C is the
    dump row, never read as valid), n_pts: [C + 1] occupancy,
    voxel_size: scalar tensor, origin: [3] world position of cell
    (0, 0, 0), dims: (nx, ny, nz)."""

    points: torch.Tensor
    n_pts: torch.Tensor
    voxel_size: torch.Tensor
    origin: torch.Tensor
    dims: tuple[int, int, int]

    @property
    def capacity(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]


def _cell_of(xyz: torch.Tensor, voxel_size, origin) -> torch.Tensor:
    return torch.floor((xyz - origin) / voxel_size).to(torch.int32)


def _ravel(c: torch.Tensor, dims) -> torch.Tensor:
    nx, ny, nz = dims
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    inside = ((x >= 0) & (x < nx) & (y >= 0) & (y < ny)
              & (z >= 0) & (z < nz))
    idx = (x * ny + y) * nz + z
    return torch.where(inside, idx, torch.full_like(idx, nx * ny * nz))


def build_voxel_grid(xyz: torch.Tensor, mask: torch.Tensor, voxel_size,
                     origin, dims: tuple[int, int, int],
                     slots: int) -> DenseVoxelGrid:
    """Insert the masked points [N, 3]: the first ``slots`` points of each
    cell in key-sorted (stable) order are kept."""
    n = xyz.shape[0]
    dtype, dev = xyz.dtype, xyz.device
    origin = torch.as_tensor(origin, dtype=dtype, device=dev)
    capacity = dims[0] * dims[1] * dims[2]

    cell = _ravel(_cell_of(xyz, voxel_size, origin), dims)
    cell = torch.where(mask, cell, torch.full_like(cell, capacity))

    order = torch.argsort(cell, stable=True)
    scell = cell[order]
    sxyz = xyz[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = scell[1:] != scell[:-1]
    idx = torch.arange(n, device=dev)
    # lax.associative_scan(max) over the segment starts.
    seg_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rank = idx - seg_start

    ok = (scell < capacity) & (rank < slots)
    rows = torch.where(ok, scell, torch.full_like(scell, capacity)).long()
    cols = torch.where(ok, torch.clamp_max(rank, slots - 1), 0)
    points = torch.zeros((capacity + 1, slots, 3), dtype=dtype, device=dev)
    # Every point that is not kept writes (capacity, 0): the dump row,
    # which cand_ok never reads as valid.
    points[rows, cols] = torch.where(ok[:, None], sxyz, 0.0)
    n_pts = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    n_pts.index_add_(0, rows, ok.to(torch.int32))

    return DenseVoxelGrid(points=points,
                          n_pts=torch.clamp_max(n_pts, slots),
                          voxel_size=torch.as_tensor(voxel_size, dtype=dtype,
                                                     device=dev),
                          origin=origin, dims=tuple(dims))


def grid_for_bounds(lo, hi, voxel_size, margin_voxels: int = 2):
    """(origin, dims) covering the AABB [lo, hi] plus a margin; the
    origin snaps to the global voxel lattice."""
    lo = (np.floor(np.asarray(lo, np.float64) / voxel_size)
          - margin_voxels) * voxel_size
    hi = np.asarray(hi, np.float64) + margin_voxels * voxel_size
    dims = tuple(int(d) for d in
                 np.maximum(np.ceil((hi - lo) / voxel_size), 1).astype(int))
    return lo.astype(np.float32), dims


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def neighborhood_candidates(grid: DenseVoxelGrid, queries: torch.Tensor):
    """The 27-voxel candidate sets around each query [..., Q, 3] (a batch
    of scans shares the one grid): (cand [..., Q, 27*S, 3], cand_ok
    [..., Q, 27*S])."""
    slots = grid.points.shape[1]
    dev = queries.device
    qc = _cell_of(queries, grid.voxel_size, grid.origin)     # [..., Q, 3]
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)
    cells = _ravel(qc[..., None, :] + offs, grid.dims).long()
    cand = grid.points[cells]                           # [..., Q, 27, S, 3]
    cnt = grid.n_pts[cells]                             # [..., Q, 27]
    slot_idx = torch.arange(slots, device=dev)
    ok = (cells[..., None] < grid.capacity) & (slot_idx < cnt[..., None])
    lead = queries.shape[:-1]
    return (cand.reshape(lead + (27 * slots, 3)),
            ok.reshape(lead + (27 * slots,)))


def topk_from_candidates(cand, cand_ok, queries, k: int):
    """The k nearest candidates of each query [..., Q, 3], nearest first,
    ties to the lower candidate index: (nbrs [..., Q, k, 3], sq_dists
    [..., Q, k], valid [..., Q, k]); invalid neighbours are zero at
    +inf. Every step works query by query, so a batch's lane gets the
    bits of its lone call. The squared distances are the reference's
    jitted ``fma(dz, dz, fma(dy, dy, dx*dx))`` in float32 (ROADMAP §C19):
    a near-tie orders the neighbours as there."""
    sq = xf.sum_squares(cand - queries[..., None, :])
    sq = torch.where(cand_ok, sq, torch.full_like(sq, float("inf")))
    sq_sorted, order = torch.sort(sq, dim=-1, stable=True)
    sq_k, top_idx = sq_sorted[..., :k], order[..., :k]
    nbrs = torch.gather(cand, -2, top_idx[..., None].expand(
        top_idx.shape + (3,)))
    valid = torch.isfinite(sq_k)
    nbrs = torch.where(valid[..., None], nbrs, 0.0)
    return nbrs, sq_k, valid


def knn(grid: DenseVoxelGrid, queries: torch.Tensor, k: int):
    cand, ok = neighborhood_candidates(grid, queries)
    return topk_from_candidates(cand, ok, queries, k)
