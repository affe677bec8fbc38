"""Closed-form eigendecomposition of symmetric 3x3 matrices, batched.

Port of ``lidar_feature_extraction_tpu/ops/eig3.py``: trigonometric
eigenvalues and cross-product eigenvectors with a branch-free pivot
(Eberly, "A Robust Eigensolver for 3x3 Symmetric Matrices"), as
straight-line tensor code rather than ``torch.linalg``, so that the
results follow the reference's conventions.
"""

from __future__ import annotations

import torch

from lidar_feature_extraction_tpu_torch.core.quaternion import _cross


def eigh3x3(a: torch.Tensor, eps: float = 1e-30):
    """Eigenvalues (ascending) and eigenvectors of symmetric [..., 3, 3].

    Returns ``(w [..., 3], v [..., 3, 3])`` with ``v[..., :, k]`` the unit
    eigenvector of ``w[..., k]``.
    """
    dtype, dev = a.dtype, a.device
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]) / 3.0
    a00 = a[..., 0, 0] - q
    a11 = a[..., 1, 1] - q
    a22 = a[..., 2, 2] - q
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]

    p2 = (a00 * a00 + a11 * a11 + a22 * a22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, eps))

    # det(B) where B = (A - q I) / p
    b00, b11, b22 = a00 / p, a11 / p, a22 / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0

    two_pi_3 = 2.0943951023931953
    w2 = q + 2.0 * p * torch.cos(phi)                  # largest
    w0 = q + 2.0 * p * torch.cos(phi + two_pi_3)       # smallest
    w1 = 3.0 * q - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)

    # Near-isotropic matrices: all eigenvalues q, identity basis.
    iso = p2 < (1e-12 * q * q + 1e-30)

    def eigenvector(lam):
        """Unit eigenvector for eigenvalue lam via the largest cross
        product of rows of (A - lam I)."""
        r0 = torch.stack([a[..., 0, 0] - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a[..., 1, 1] - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a[..., 2, 2] - lam], dim=-1)
        c01 = _cross(r0, r1)
        c02 = _cross(r0, r2)
        c12 = _cross(r1, r2)
        n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
        n02 = torch.sum(c02 * c02, dim=-1, keepdim=True)
        n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
        best = torch.where(n01 >= torch.maximum(n02, n12), c01,
                           torch.where(n02 >= n12, c02, c12))
        norm = torch.sqrt(torch.clamp_min(
            torch.sum(best * best, dim=-1, keepdim=True), eps))
        return best / norm

    v2 = eigenvector(w2)
    v0 = eigenvector(w0)
    # Orthogonalize v0 against v2; when the two smallest eigenvalues
    # coincide, fall back to a unit vector orthogonal to v2.
    v0 = v0 - torch.sum(v0 * v2, dim=-1, keepdim=True) * v2
    v0sq = torch.sum(v0 * v0, dim=-1, keepdim=True)
    pick_x = torch.abs(v2[..., 0:1]) < 0.9
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    fallback = _cross(torch.where(pick_x, ex, ey), v2)
    fallback = fallback / torch.sqrt(torch.clamp_min(
        torch.sum(fallback * fallback, dim=-1, keepdim=True), eps))
    v0 = torch.where(v0sq < 1e-12, fallback,
                     v0 / torch.sqrt(torch.clamp_min(v0sq, eps)))
    v1 = _cross(v2, v0)

    iso_b = iso[..., None]
    v0 = torch.where(iso_b, ex, v0)
    v1 = torch.where(iso_b, ey, v1)
    v2 = torch.where(iso_b, ez, v2)
    w = torch.where(iso_b, torch.stack([q, q, q], dim=-1), w)

    v = torch.stack([v0, v1, v2], dim=-1)  # columns are eigenvectors
    return w, v
