"""Precomputed per-voxel correspondence geometry: line/plane fits over
3x3x3 voxel neighbourhoods, baked once at map build time.

Port of ``lidar_feature_extraction_tpu/ops/geometry_grid.py``:

1. scatter point moments (count, sum, second moment, local to the
   voxel centre) into the dense grid — a scatter-add into a
   ``capacity + 1`` table whose last row takes masked points; a weight
   of -1 removes points, and ``recenter_moments`` rolls the grid after
   the vehicle (the incremental odometry map);
2. sum 3x3x3 neighbourhoods as a separable box filter, translating
   moments between voxel frames with the parallel-axis rule;
3. fit every voxel's line (principal axis) or plane (smallest axis) with
   the closed-form ``eigh3x3``.

Registration then needs one 8-float record gather per scan point per
Gauss-Newton iteration (``fused_rows_from_grids``, or one grid at a
time: ``edge_rows_from_grid`` / ``surface_rows_from_grid``). On the card
the scatter-add sums each voxel's points in a fixed order
(``ops/scatter.py``): the same bits every run, though not necessarily
the CPU's. In float32 the records and the rows take the fused forms of
the reference's jitted map build and residual rows
(``core/_xla_f32.py``; ROADMAP §C20), so on the CPU they equal its
bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.ops.eig3 import eigh3x3
from lidar_feature_extraction_tpu_torch.ops.residuals import ResidualBlock
from lidar_feature_extraction_tpu_torch.ops.scatter import index_add_rows
from lidar_feature_extraction_tpu_torch.ops.voxel_grid import (
    _cell_of, _ravel)


class GeometryGrid(NamedTuple):
    """Dense per-voxel geometry records.

    rec: [C + 1, 8] with C = nx*ny*nz (+1 zero dump row for
    out-of-bounds queries). Edge grids store (m(3), v(3), count, 0):
    line through m with unit direction v. Surface grids store
    (u(3), b, count, 0, 0, 0): plane u . x = b with unit normal u.
    """

    rec: torch.Tensor
    voxel_size: torch.Tensor
    origin: torch.Tensor
    dims: tuple[int, int, int]

    @property
    def capacity(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]


def _point_moments(y: torch.Tensor) -> torch.Tensor:
    """[..., 3] local coords -> [..., 10] moment rows
    (1, y, y y^T upper triangle: xx xy xz yy yz zz)."""
    x0, x1, x2 = y[..., 0], y[..., 1], y[..., 2]
    return torch.stack([torch.ones_like(x0), x0, x1, x2,
                        x0 * x0, x0 * x1, x0 * x2,
                        x1 * x1, x1 * x2, x2 * x2], dim=-1)


# The second moments' columns in a [..., 10] moment row, by (i, j).
_SECOND = {(0, 0): 4, (0, 1): 5, (0, 2): 6, (1, 1): 7, (1, 2): 8, (2, 2): 9}


def _translate_moments(m: torch.Tensor, axis: int,
                       o: torch.Tensor) -> torch.Tensor:
    """Parallel-axis translation along one axis: moments of
    (y + o e_axis) from moments of y, ``o`` a scalar tensor. The sum
    moves by n o; a second moment S_ij by s_i o_j + s_j o_i + n o_i o_j,
    which leaves the entries off the axis unchanged. In float32 each
    product is fused into the sum it feeds, as in the reference's jitted
    map build: ``fma(n, o, s_a)``, ``fma(n, o^2, fma(2 o, s_a, S_aa))``
    and ``fma(o, s_i, S_ai)`` (ROADMAP §C20)."""
    n = m[..., 0]
    s = list(m[..., 1:4].unbind(-1))
    cols = list(m.unbind(-1))
    cols[1 + axis] = xf.fma(o, n, s[axis])
    for (i, j), c in _SECOND.items():
        if i == j == axis:
            cols[c] = xf.fma(o * o, n, xf.fma(2.0 * o, s[axis], cols[c]))
        elif axis in (i, j):
            cols[c] = xf.fma(o, s[j if i == axis else i], cols[c])
    return torch.stack(cols, dim=-1)


def voxel_moments(xyz: torch.Tensor, mask: torch.Tensor, voxel_size,
                  origin, dims: tuple[int, int, int],
                  weight: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter masked points into per-voxel moments [C, 10], local to
    each voxel's centre so second moments stay O(voxel_size^2).
    ``weight`` [N] scales each point's row; -1 removes a point inserted
    before (moments are additive: the incremental odometry map)."""
    dtype, dev = xyz.dtype, xyz.device
    origin = torch.as_tensor(origin, dtype=dtype, device=dev)
    voxel_size = torch.as_tensor(voxel_size, dtype=dtype, device=dev)
    capacity = dims[0] * dims[1] * dims[2]

    c = _cell_of(xyz, voxel_size, origin)
    cell = _ravel(c, dims)
    cell = torch.where(mask, cell, torch.full_like(cell, capacity))
    center = xf.fma(voxel_size, c.to(dtype) + 0.5, origin)
    feats = _point_moments(xyz - center)
    feats = torch.where(mask[:, None], feats, 0.0)
    if weight is not None:
        feats = feats * weight[:, None].to(dtype)

    m = torch.zeros((capacity + 1, 10), dtype=dtype, device=dev)
    index_add_rows(m, cell.to(torch.int64), feats)
    return m[:capacity]


def recenter_moments(m: torch.Tensor, dims: tuple[int, int, int],
                     voxel_size, origin, target_center):
    """Roll a dense moment grid by whole voxels so its centre follows
    ``target_center``, zeroing the bands that wrapped around (space the
    grid newly covers). Local moment frames ride along unchanged: the
    origin moves by exactly the roll. Returns (m, new_origin).

    ``jnp.roll`` takes the traced shift in the reference; ``torch.roll``
    takes Python ints only, so each axis is a gather with on-device
    modular indices instead, and the shift is never read by the host."""
    dtype, dev = m.dtype, m.device
    nx, ny, nz = dims
    h = torch.as_tensor(voxel_size, dtype=dtype, device=dev)
    origin = torch.as_tensor(origin, dtype=dtype, device=dev)
    half = torch.tensor(dims, dtype=dtype, device=dev) * h / 2.0
    desired = torch.as_tensor(target_center, dtype=dtype, device=dev) - half
    shift = torch.round((desired - origin) / h).to(torch.int32)   # [3]

    g = m.reshape(nx, ny, nz, 10)
    for axis, n_a in enumerate((nx, ny, nz)):
        s = shift[axis]
        idx = torch.arange(n_a, device=dev)
        # roll by -s: out[i] = g[(i + s) mod n]; then keep only what did
        # not wrap (i < n - s for s >= 0, i >= -s otherwise).
        g = torch.index_select(g, axis, torch.remainder(idx + s, n_a))
        keep = torch.where(s >= 0, idx < n_a - s, idx >= -s)
        shape = [1, 1, 1, 1]
        shape[axis] = n_a
        g = torch.where(keep.reshape(shape), g, 0.0)
    return g.reshape(-1, 10), origin + shift.to(dtype) * h


def _shift(a: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """Zero-padded shift pulling the neighbour at index+direction."""
    zeros = torch.zeros_like(a.narrow(axis, 0, 1))
    if direction > 0:
        return torch.cat([a.narrow(axis, 1, a.shape[axis] - 1), zeros], axis)
    return torch.cat([zeros, a.narrow(axis, 0, a.shape[axis] - 1)], axis)


def neighborhood_moments(m: torch.Tensor, dims: tuple[int, int, int],
                         voxel_size) -> torch.Tensor:
    """3x3x3 box-sum of per-voxel local moments, [C, 10] -> [C, 10]:
    one shifted-add pass per axis, the i+1 neighbour translated by
    +h e_a and the i-1 neighbour by -h e_a."""
    nx, ny, nz = dims
    g = m.reshape(nx, ny, nz, 10)
    h = torch.as_tensor(voxel_size, dtype=m.dtype, device=m.device)
    for axis in range(3):
        g = (g
             + _translate_moments(_shift(g, axis, +1), axis, h)
             + _translate_moments(_shift(g, axis, -1), axis, -h))
    return g.reshape(-1, 10)


def _voxel_centers(dims: tuple[int, int, int], voxel_size, origin,
                   dtype, device) -> torch.Tensor:
    nx, ny, nz = dims
    idx = torch.arange(nx * ny * nz, device=device)
    cx = idx // (ny * nz)
    cy = (idx // nz) % ny
    cz = idx % nz
    c = torch.stack([cx, cy, cz], dim=-1).to(dtype)
    return xf.fma(torch.as_tensor(voxel_size, dtype=dtype, device=device),
                  c + 0.5, torch.as_tensor(origin, dtype=dtype,
                                           device=device))


def _mean_cov(m: torch.Tensor):
    """Neighbourhood count, mean and count-normalized covariance from
    local moments [..., 10]."""
    n = torch.clamp_min(m[..., 0], 1.0)
    mu = m[..., 1:4] / n[..., None]
    s2 = torch.stack([
        torch.stack([m[..., 4], m[..., 5], m[..., 6]], dim=-1),
        torch.stack([m[..., 5], m[..., 7], m[..., 8]], dim=-1),
        torch.stack([m[..., 6], m[..., 8], m[..., 9]], dim=-1),
    ], dim=-2)
    cov = xf.fma(-mu[..., :, None], mu[..., None, :], s2 / n[..., None, None])
    return m[..., 0], mu, cov


def edge_records_from_moments(m: torch.Tensor, dims, voxel_size,
                              origin) -> torch.Tensor:
    """Raw per-voxel moments [C, 10] -> edge records [C + 1, 8]: line
    point (neighbourhood mean, world frame) and unit principal axis."""
    nb = neighborhood_moments(m, dims, voxel_size)
    n, mu, cov = _mean_cov(nb)
    _, evecs = eigh3x3(cov)
    v = evecs[..., :, 2]                        # largest eigenvalue axis
    centers = _voxel_centers(dims, voxel_size, origin, m.dtype, m.device)
    rec = torch.cat([centers + mu, v, n[:, None],
                     torch.zeros_like(n[:, None])], dim=-1)
    return torch.cat([rec, torch.zeros((1, 8), dtype=m.dtype,
                                       device=m.device)], dim=0)


def surface_records_from_moments(m: torch.Tensor, dims, voxel_size,
                                 origin) -> torch.Tensor:
    """Raw per-voxel moments [C, 10] -> surface records [C + 1, 8]: unit
    normal u (smallest axis) and offset b = u . p0 through the centroid."""
    nb = neighborhood_moments(m, dims, voxel_size)
    n, mu, cov = _mean_cov(nb)
    _, evecs = eigh3x3(cov)
    u = evecs[..., :, 0]                        # smallest eigenvalue axis
    centers = _voxel_centers(dims, voxel_size, origin, m.dtype, m.device)
    p0 = centers + mu
    b = xf.dot(u, p0, keepdim=True)
    rec = torch.cat([u, b, n[:, None],
                     torch.zeros((u.shape[0], 3), dtype=m.dtype,
                                 device=m.device)], dim=-1)
    return torch.cat([rec, torch.zeros((1, 8), dtype=m.dtype,
                                       device=m.device)], dim=0)


def _grid(rec, voxel_size, origin, dims) -> GeometryGrid:
    return GeometryGrid(
        rec=rec,
        voxel_size=torch.as_tensor(voxel_size, dtype=rec.dtype,
                                   device=rec.device),
        origin=torch.as_tensor(origin, dtype=rec.dtype, device=rec.device),
        dims=tuple(dims))


def build_edge_geometry_grid(xyz, mask, voxel_size, origin,
                             dims: tuple[int, int, int]) -> GeometryGrid:
    """Fit the neighbourhood PCA line of every voxel."""
    m = voxel_moments(xyz, mask, voxel_size, origin, dims)
    return _grid(edge_records_from_moments(m, dims, voxel_size, origin),
                 voxel_size, origin, dims)


def build_surface_geometry_grid(xyz, mask, voxel_size, origin,
                                dims: tuple[int, int, int]) -> GeometryGrid:
    """Fit the neighbourhood plane of every voxel."""
    m = voxel_moments(xyz, mask, voxel_size, origin, dims)
    return _grid(surface_records_from_moments(m, dims, voxel_size, origin),
                 voxel_size, origin, dims)


def gather_records(grid: GeometryGrid, queries: torch.Tensor):
    """[Q, 3] world points -> ([Q, 8] records, [Q] in-grid mask)."""
    cells = _ravel(_cell_of(queries, grid.voxel_size, grid.origin),
                   grid.dims)
    return grid.rec[cells.to(torch.int64)], cells < grid.capacity


def fuse_record_tables(edge: GeometryGrid,
                       surface: GeometryGrid) -> torch.Tensor:
    """One [Ce + Cs + 1, 8] table (edge rows, surface rows, shared zero
    dump row), so each iteration gathers both record kinds at once."""
    return torch.cat([edge.rec[:-1], surface.rec], dim=0)


def fused_rows_from_grids(edge_grid: GeometryGrid,
                          surf_grid: GeometryGrid,
                          fused_rec: torch.Tensor,
                          edge_pts, edge_valid, surf_pts, surf_valid,
                          pose: Pose, min_points: int):
    """Edge (point-to-line) and surface (point-to-plane) residual blocks
    at ``pose`` with ONE record gather from ``fuse_record_tables``.

    Batched: points [B, N, 3] and poses q [B, 4], t [B, 3] give blocks
    with a leading [B], all lanes gathering from the one shared table
    (the reference's ``vmap`` with the maps unbatched)."""
    ce_cap = edge_grid.capacity
    cs_cap = surf_grid.capacity
    dump = ce_cap + cs_cap

    # One pose per lane, broadcast over that lane's points.
    pose = Pose(pose.q[..., None, :], pose.t[..., None, :])
    pe = pose.apply_fma(edge_pts)
    ps = pose.apply_fma(surf_pts)
    cells_e = _ravel(_cell_of(pe, edge_grid.voxel_size, edge_grid.origin),
                     edge_grid.dims)
    cells_s = _ravel(_cell_of(ps, surf_grid.voxel_size, surf_grid.origin),
                     surf_grid.dims)
    in_e = cells_e < ce_cap
    in_s = cells_s < cs_cap
    idx = torch.cat([torch.where(in_e, cells_e, torch.full_like(cells_e,
                                                                 dump)),
                     ce_cap + cells_s], dim=-1)
    rec = fused_rec[idx.to(torch.int64)]
    qe = edge_pts.shape[-2]
    rec_e, rec_s = rec[..., :qe, :], rec[..., qe:, :]

    # Edge rows: residual (p - p1) x (p - p2), Jacobian
    # [Hat(p2 - p1) DRpDq | Hat(p2 - p1)].
    m, v, cnt_e = rec_e[..., 0:3], rec_e[..., 3:6], rec_e[..., 6]
    p1, p2 = m - v, m + v
    khat = quat.hat(p2 - p1)
    dr_e = quat.drpdq(pose.q.expand(edge_pts.shape[:-1] + (4,)), edge_pts)
    jac_e = torch.cat([xf.matmul(khat, dr_e), khat], dim=-1)
    res_e = xf.cross(pe - p1, pe - p2)
    ok_e = edge_valid & in_e & (cnt_e >= min_points)
    oef = ok_e[..., None]
    eb = ResidualBlock(jacobian=torch.where(oef[..., None], jac_e, 0.0),
                       residual=torch.where(oef, res_e, 0.0), valid=ok_e)

    # Surface rows: residual u . p - b, Jacobian [u^T DRpDq | u^T].
    u, b, cnt_s = rec_s[..., 0:3], rec_s[..., 3], rec_s[..., 4]
    dr_s = quat.drpdq(pose.q.expand(surf_pts.shape[:-1] + (4,)), surf_pts)
    ju = xf.vecmat(u, dr_s)
    jac_s = torch.cat([ju, u], dim=-1)[..., None, :]
    res_s = (xf.dot(u, ps) - b)[..., None]
    ok_s = surf_valid & in_s & (cnt_s >= min_points)
    osf = ok_s[..., None]
    sb = ResidualBlock(jacobian=torch.where(osf[..., None], jac_s, 0.0),
                       residual=torch.where(osf, res_s, 0.0), valid=ok_s)
    return eb, sb


def _block(jac, res, ok) -> ResidualBlock:
    okf = ok[..., None]
    return ResidualBlock(jacobian=torch.where(okf[..., None], jac, 0.0),
                         residual=torch.where(okf, res, 0.0), valid=ok)


def edge_rows_from_grid(grid: GeometryGrid, scan_pts, scan_valid,
                        pose: Pose, min_points: int) -> ResidualBlock:
    """Point-to-line rows with one record gather from one grid: residual
    (p - p1) x (p - p2), Jacobian [Hat(p2 - p1) DRpDq | Hat(p2 - p1)]."""
    p_map = pose.apply_fma(scan_pts)
    rec, in_grid = gather_records(grid, p_map)
    m, v, cnt = rec[..., 0:3], rec[..., 3:6], rec[..., 6]
    p1, p2 = m - v, m + v
    khat = quat.hat(p2 - p1)
    dr = quat.drpdq(pose.q.expand(scan_pts.shape[:-1] + (4,)), scan_pts)
    jac = torch.cat([xf.matmul(khat, dr), khat], dim=-1)
    res = xf.cross(p_map - p1, p_map - p2)
    return _block(jac, res, scan_valid & in_grid & (cnt >= min_points))


def surface_rows_from_grid(grid: GeometryGrid, scan_pts, scan_valid,
                           pose: Pose, min_points: int) -> ResidualBlock:
    """Point-to-plane rows with one record gather from one grid: residual
    u . p - b, Jacobian [u^T DRpDq | u^T]."""
    p_map = pose.apply_fma(scan_pts)
    rec, in_grid = gather_records(grid, p_map)
    u, b, cnt = rec[..., 0:3], rec[..., 3], rec[..., 4]
    dr = quat.drpdq(pose.q.expand(scan_pts.shape[:-1] + (4,)), scan_pts)
    ju = xf.vecmat(u, dr)
    jac = torch.cat([ju, u], dim=-1)[..., None, :]
    res = (xf.dot(u, p_map) - b)[..., None]
    return _block(jac, res, scan_valid & in_grid & (cnt >= min_points))
