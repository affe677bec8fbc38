"""Batched edge / surface correspondence residuals and Jacobians.

Port of ``lidar_feature_extraction_tpu/ops/residuals.py:44-261``:

- edge (point-to-line): PCA of the k map neighbours, the principal axis
  spans p1 = mean - principal and p2 = mean + principal; residual
  (p - p1) x (p - p2) in R^3, Jacobian [Hat(p2 - p1) DRpDq | Hat(p2 - p1)];
- surface (point-to-plane): least-squares plane X w = -1 over the k
  neighbours; residual (w.x + 1)/|w|, Jacobian [u^T DRpDq | u^T] with
  u = w/|w|.

Invalid lanes (masked scan points, starved neighbourhoods) carry zero
Jacobians and residuals, so they drop out of the normal equations.

The kNN fits compute the reference's jitted float32 arithmetic (ROADMAP
§C19): the query points (``Pose.apply_each_fma``), the squared
distances, the neighbourhood sums in neighbour order, the normal
equations and the covariance as fused multiply-add chains, the plane
solve and the principal axis with XLA:CPU's contractions
(``core/_xla_f32.py``), so a near-tie selects and orders the neighbours
as the reference does. The residual rows at each iteration's pose keep
one rounding per operation. float64 is unchanged.

Every function takes a batch of scans too (points [B, N, 3], one pose
per scan: q [B, 4], t [B, 3]; candidates and neighbours with the same
leading [B]) against one shared map. Each float reduction runs point by
point over that point's K neighbours, so a lane gets the bits of its
lone call.

Retrieval paths: ``*_residuals`` run the full kNN against a map
structure; ``*_residuals_from_candidates`` select the top k from a
candidate set gathered once per search round; ``fit_*_geometry`` +
``*_rows_from_geometry`` split the pose-independent fit from the
per-iteration rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.ops import voxel_grid as vg
from lidar_feature_extraction_tpu_torch.ops import voxel_map as vm
from lidar_feature_extraction_tpu_torch.ops.eig3 import principal_axis3x3
from lidar_feature_extraction_tpu_torch.ops.smallalg import solve3x3_sym


class ResidualBlock(NamedTuple):
    """Fixed-shape correspondence set.

    jacobian: [N, D, 7], residual: [N, D], valid: [N] — D=3 for edge,
    D=1 for surface rows.
    """

    jacobian: torch.Tensor
    residual: torch.Tensor
    valid: torch.Tensor


def lookup_knn(map_struct, queries: torch.Tensor, k: int):
    """kNN against a map structure: the dense voxel grid
    (``ops/voxel_grid.py``) or the voxel-hash map (``ops/voxel_map.py``)."""
    if isinstance(map_struct, vg.DenseVoxelGrid):
        return vg.knn(map_struct, queries, k)
    if isinstance(map_struct, vm.VoxelHashMap):
        return vm.knn(map_struct, queries, k)
    raise NotImplementedError(
        f"kNN against {type(map_struct).__name__}: the map structures are "
        f"DenseVoxelGrid and VoxelHashMap")


def masked_mean_and_cov(pts: torch.Tensor, valid: torch.Tensor):
    """Mean and covariance over the valid neighbours, batched [..., K, 3];
    the covariance is normalized by the valid count, not count - 1. In
    float32 the sums run in neighbour order, the covariance's as an
    ``fma`` chain (``xf.sum_in_order``, ``xf.gram``)."""
    w = valid.to(pts.dtype)[..., None]
    cnt = torch.clamp_min(torch.sum(w, dim=-2), 1.0)
    mean = xf.sum_in_order(pts * w, dim=-2) / cnt
    d = (pts - mean[..., None, :]) * w
    cov = xf.gram(d, d) / cnt[..., None]
    return mean, cov


def _principal_line(nbrs, nvalid):
    mean, cov = masked_mean_and_cov(nbrs, nvalid)
    principal = principal_axis3x3(cov)                 # largest eigenvalue
    return mean - principal, mean + principal


def _drpdq_rows(pose: Pose, scan_pts):
    return quat.drpdq(pose.q[..., None, :].expand(scan_pts.shape[:-1]
                                                  + (4,)), scan_pts)


def _masked_block(jac, res, ok) -> ResidualBlock:
    okf = ok[..., None]
    return ResidualBlock(jacobian=torch.where(okf[..., None], jac, 0.0),
                         residual=torch.where(okf, res, 0.0), valid=ok)


def _enough(scan_valid, nvalid, min_neighbors: int):
    return scan_valid & (torch.sum(nvalid, dim=-1) >= min_neighbors)


def edge_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                             pose: Pose, min_neighbors: int
                             ) -> ResidualBlock:
    """Linearize point-to-line residuals given the k neighbourhoods."""
    p1, p2 = _principal_line(nbrs, nvalid)
    return _edge_block(p1, p2, quat.hat(p2 - p1), scan_pts, pose,
                       _enough(scan_valid, nvalid, min_neighbors))


def fit_plane(nbrs: torch.Tensor, valid: torch.Tensor,
              eps: float = 1e-9) -> torch.Tensor:
    """Least-squares plane X w = -1 over the valid neighbours, batched,
    from the normal equations (X^T X + eps I) w = -X^T 1; in float32
    summed in neighbour order as ``masked_mean_and_cov``."""
    w = valid.to(nbrs.dtype)[..., None]
    xw = nbrs * w
    ata = xf.gram(xw, nbrs)                               # [..., 3, 3]
    atb = -xf.sum_in_order(xw, dim=-2)                    # [..., 3]
    ata = ata + eps * torch.eye(3, dtype=nbrs.dtype, device=nbrs.device)
    return solve3x3_sym(ata, atb)


def _unit_normal(w):
    wnorm = xf.sqrt(xf.sum_squares(w, keepdim=True))
    return w / torch.clamp_min(wnorm, 1e-12), wnorm


def _edge_block(p1, p2, khat, scan_pts, pose: Pose, ok) -> ResidualBlock:
    """Point-to-line rows at ``pose``: residual (p - p1) x (p - p2),
    Jacobian [Hat(p2 - p1) DRpDq | Hat(p2 - p1)], in the float32 forms
    of the reference's jitted rows (ROADMAP §C20)."""
    p_map = pose.apply_each_fma(scan_pts)
    jac = torch.cat([xf.matmul(khat, _drpdq_rows(pose, scan_pts)), khat],
                    dim=-1)                            # [N, 3, 7]
    res = xf.cross(p_map - p1, p_map - p2)             # [N, 3]
    return _masked_block(jac, res, ok)


def _surface_block(w, u, wnorm, scan_pts, pose: Pose, ok) -> ResidualBlock:
    """Point-to-plane rows at ``pose``: residual (w . p + 1) / |w|,
    Jacobian [u^T DRpDq | u^T], in the float32 forms of the reference's
    jitted rows (ROADMAP §C20)."""
    p_map = pose.apply_each_fma(scan_pts)
    ju = xf.vecmat(u, _drpdq_rows(pose, scan_pts))
    jac = torch.cat([ju, u], dim=-1)[..., None, :]     # [N, 1, 7]
    res = ((xf.dot(w, p_map, keepdim=True) + 1.0)
           / torch.clamp_min(wnorm, 1e-12))            # [N, 1]
    return _masked_block(jac, res, ok)


def surface_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                pose: Pose, min_neighbors: int
                                ) -> ResidualBlock:
    """Linearize point-to-plane residuals given the k neighbourhoods."""
    w = fit_plane(nbrs, nvalid)                        # [N, 3]
    u, wnorm = _unit_normal(w)
    return _surface_block(w, u, wnorm, scan_pts, pose,
                          _enough(scan_valid, nvalid, min_neighbors))


# --- fitted-geometry paths (fit once per search round) ---

class EdgeGeometry(NamedTuple):
    """Pose-independent per-correspondence line geometry."""

    p1: torch.Tensor     # [N, 3] virtual line point mean - principal
    p2: torch.Tensor     # [N, 3] virtual line point mean + principal
    khat: torch.Tensor   # [N, 3, 3] Hat(p2 - p1)
    valid: torch.Tensor  # [N]


class SurfaceGeometry(NamedTuple):
    """Pose-independent per-correspondence plane geometry (w: X w = -1)."""

    w: torch.Tensor      # [N, 3] plane coefficients
    u: torch.Tensor      # [N, 3] unit normal w/|w|
    wnorm: torch.Tensor  # [N, 1]
    valid: torch.Tensor  # [N]


def fit_edge_geometry(cand, cand_ok, scan_pts, scan_valid, pose: Pose,
                      k: int, min_neighbors: int = 5) -> EdgeGeometry:
    """Select the k nearest candidates at the round pose and fit lines."""
    nbrs, _, nvalid = vg.topk_from_candidates(cand, cand_ok,
                                              pose.apply_each_fma(scan_pts), k)
    p1, p2 = _principal_line(nbrs, nvalid)
    return EdgeGeometry(p1=p1, p2=p2, khat=quat.hat(p2 - p1),
                        valid=_enough(scan_valid, nvalid, min_neighbors))


def fit_surface_geometry(cand, cand_ok, scan_pts, scan_valid, pose: Pose,
                         k: int, min_neighbors: int = 5) -> SurfaceGeometry:
    """Select the k nearest candidates at the round pose and fit planes."""
    nbrs, _, nvalid = vg.topk_from_candidates(cand, cand_ok,
                                              pose.apply_each_fma(scan_pts), k)
    w = fit_plane(nbrs, nvalid)
    u, wnorm = _unit_normal(w)
    return SurfaceGeometry(w=w, u=u, wnorm=wnorm,
                           valid=_enough(scan_valid, nvalid, min_neighbors))


def edge_rows_from_geometry(geom: EdgeGeometry, scan_pts,
                            pose: Pose) -> ResidualBlock:
    """Pose-dependent half of the edge linearization (inner GN loop)."""
    return _edge_block(geom.p1, geom.p2, geom.khat, scan_pts, pose,
                       geom.valid)


def surface_rows_from_geometry(geom: SurfaceGeometry, scan_pts,
                               pose: Pose) -> ResidualBlock:
    """Pose-dependent half of the surface linearization (inner GN loop)."""
    return _surface_block(geom.w, geom.u, geom.wnorm, scan_pts, pose,
                          geom.valid)


# --- full-search paths ---

def edge_residuals(edge_map, scan_pts, scan_valid, pose: Pose, k: int,
                   min_neighbors: int = 5) -> ResidualBlock:
    nbrs, _, nvalid = lookup_knn(edge_map, pose.apply_each_fma(scan_pts), k)
    return edge_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                    pose, min_neighbors)


def surface_residuals(surface_map, scan_pts, scan_valid, pose: Pose,
                      k: int, min_neighbors: int = 5) -> ResidualBlock:
    nbrs, _, nvalid = lookup_knn(surface_map, pose.apply_each_fma(scan_pts), k)
    return surface_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                       pose, min_neighbors)


def surface_residuals_eager(surface_map, scan_pts, scan_valid, pose: Pose,
                            k: int, min_neighbors: int = 5):
    """``surface_residuals``'s residuals [N, 1] and valid mask as the
    reference computes them outside a jitted program (its loop-closure
    gate): in float32 the points through ``Pose.apply``, the map's kNN,
    the plane fit's X^T X as the jitted ``jnp.einsum`` chains it, X^T 1
    and w . p summed in order, the 3x3 solve and the residual with each
    operation rounded, |w| as the jitted ``jnp.linalg.norm``."""
    p_map = pose.apply(scan_pts)
    nbrs, _, nvalid = lookup_knn(surface_map, p_map, k)
    xw = nbrs * nvalid.to(nbrs.dtype)[..., None]
    ata = xf.gram(xw, nbrs) + 1e-9 * torch.eye(3, dtype=nbrs.dtype,
                                               device=nbrs.device)
    w = solve3x3_sym(ata, -xf.sum_in_order(xw, dim=-2), rounded=True)
    _, wnorm = _unit_normal(w)
    res = (xf.sum_in_order(w * p_map, dim=-1)[..., None] + 1.0) \
        / torch.clamp_min(wnorm, 1e-12)
    ok = _enough(scan_valid, nvalid, min_neighbors)
    return torch.where(ok[..., None], res, 0.0), ok


# --- cached-candidate paths ---

def edge_residuals_from_candidates(cand, cand_ok, scan_pts, scan_valid,
                                   pose: Pose, k: int,
                                   min_neighbors: int = 5) -> ResidualBlock:
    nbrs, _, nvalid = vg.topk_from_candidates(cand, cand_ok,
                                              pose.apply_each_fma(scan_pts), k)
    return edge_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                    pose, min_neighbors)


def surface_residuals_from_candidates(cand, cand_ok, scan_pts, scan_valid,
                                      pose: Pose, k: int,
                                      min_neighbors: int = 5
                                      ) -> ResidualBlock:
    nbrs, _, nvalid = vg.topk_from_candidates(cand, cand_ok,
                                              pose.apply_each_fma(scan_pts), k)
    return surface_rows_from_neighbors(nbrs, nvalid, scan_pts, scan_valid,
                                       pose, min_neighbors)
