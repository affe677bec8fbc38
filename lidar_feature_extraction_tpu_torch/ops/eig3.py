"""Closed-form eigendecomposition of symmetric 3x3 matrices, batched.

Port of ``lidar_feature_extraction_tpu/ops/eig3.py``: trigonometric
eigenvalues and cross-product eigenvectors with a branch-free pivot
(Eberly, "A Robust Eigensolver for 3x3 Symmetric Matrices"), as
straight-line tensor code rather than ``torch.linalg``, so that the
results follow the reference's conventions.
"""

from __future__ import annotations

import torch

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf


def eigh3x3(a: torch.Tensor, eps: float = 1e-30):
    """Eigenvalues (ascending) and eigenvectors of symmetric [..., 3, 3].

    Returns ``(w [..., 3], v [..., 3, 3])`` with ``v[..., :, k]`` the unit
    eigenvector of ``w[..., k]``.

    In float32 the steps take the forms of the reference's jitted map
    build (ROADMAP §C20), those of ``principal_axis3x3`` and: the
    smallest eigenvalue ``trace/3 + 2 p cos(phi + 2 pi/3)`` with
    ``arccos(r)/3 + 2 pi/3`` fused; ``v0 - (v0 . v2) v2`` and the dot
    products as ``fma`` chains; ``v2 x v0`` as ``xf.cross``. The
    returned eigenvalues, which no map record holds, take the forms of
    the jitted function alone: ``fma(2p, cos, q)``, the middle one
    ``trace - w0 - w2``. The near-isotropic test stays unfused. Other
    dtypes round each operation."""
    dtype, dev = a.dtype, a.device
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]

    def last(*v):
        return torch.stack(v, dim=-1)

    tr = (a00 + a11) + a22
    q = xf.div_const(tr, 3.0)
    s00, s11, s22 = xf.div_add(-tr[..., None], 3.0,
                               last(a00, a11, a22)).unbind(-1)
    x0, x1, x2 = last(s00, a01), last(s11, a02), last(s22, a12)
    diag, off = xf.fma(x2, x2, xf.fma(x0, x0, x1 * x1)).unbind(-1)
    p2 = xf.fma(2.0, off, diag)
    p = xf.sqrt(torch.clamp_min(xf.div_const(p2, 6.0), eps))

    # det(B) / 2 where B = (A - q I) / p
    b00, b11, b22, b01, b02, b12 = (
        last(s00, s11, s22, a01, a02, a12) / p[..., None]).unbind(-1)
    m0, m1, m2 = xf.fms(last(b22, b22, b12), last(b11, b01, b01),
                        last(b12, b12, b11), last(b12, b02, b02)).unbind(-1)
    detb = xf.fma(b02, m2, xf.fms(b00, m0, b01, m1))
    acos = xf.acos(torch.clamp(detb * 0.5, -1.0, 1.0))

    # The largest and smallest eigenvalues: q + 2 p cos(phi) and
    # q + 2 p cos(phi + 2 pi/3), phi = arccos(r) / 3. The eigenvectors are
    # found from them as the map build fuses them (lam), the returned
    # eigenvalues as a lone jit of this function does (w).
    two_pi_3 = 2.0943951023931953
    phi = xf.div_const(acos, 3.0)
    cos2 = xf.cos(phi)
    cos0 = xf.cos(xf.div_add(acos, 3.0, torch.full_like(acos, two_pi_3)))
    lam = xf.div_add(tr[..., None], 3.0,
                     (2.0 * p)[..., None] * last(cos2, cos0))
    w2 = xf.fma(2.0 * p, cos2, q)
    w0 = xf.fma(2.0 * p, xf.cos(phi + two_pi_3), q)
    w1 = ((tr if xf._float32(tr) else 3.0 * q) - w0) - w2
    w = torch.stack([w0, w1, w2], dim=-1)

    # Near-isotropic matrices: all eigenvalues q, identity basis.
    iso = p2 < (1e-12 * q * q + 1e-30)

    # Unit eigenvectors of w2 and w0 (stacked), each the largest cross
    # product of two rows of (A - lam I).
    e01, e02, e12 = (v[..., None].expand_as(lam) for v in (a01, a02, a12))
    r0 = last(a00[..., None] - lam, e01, e02)
    r1 = last(e01, a11[..., None] - lam, e12)
    r2 = last(e02, e12, a22[..., None] - lam)
    c = xf.cross(torch.stack([r0, r0, r1], dim=-2),
                 torch.stack([r1, r2, r2], dim=-2))
    n01, n02, n12 = xf.sum_squares(c, keepdim=True).unbind(-2)
    c01, c02, c12 = c.unbind(-2)
    best = torch.where(n01 >= torch.maximum(n02, n12), c01,
                       torch.where(n02 >= n12, c02, c12))
    best = best / xf.sqrt(torch.clamp_min(
        xf.sum_squares(best, keepdim=True), eps))
    v2, v0 = best.unbind(-2)

    # Orthogonalize v0 against v2; when the two smallest eigenvalues
    # coincide, fall back to a unit vector orthogonal to v2.
    v0 = xf.fma(-xf.dot(v0, v2, keepdim=True), v2, v0)
    v0sq = xf.dot(v0, v0, keepdim=True)
    pick_x = torch.abs(v2[..., 0:1]) < 0.9
    ex = torch.zeros_like(v2)     # made on the device: no copy from the host
    ex[..., 0] = 1.0
    ey = torch.roll(ex, 1, -1)
    ez = torch.roll(ex, 2, -1)
    fallback = xf.cross(torch.where(pick_x, ex, ey), v2)
    fallback = fallback / xf.sqrt(torch.clamp_min(
        xf.sum_squares(fallback, keepdim=True), eps))
    v0 = torch.where(v0sq < 1e-12, fallback,
                     v0 / xf.sqrt(torch.clamp_min(v0sq, eps)))
    v1 = xf.cross(v2, v0)

    iso_b = iso[..., None]
    v0 = torch.where(iso_b, ex, v0)
    v1 = torch.where(iso_b, ey, v1)
    v2 = torch.where(iso_b, ez, v2)
    w = torch.where(iso_b, torch.stack([q, q, q], dim=-1), w)

    v = torch.stack([v0, v1, v2], dim=-1)  # columns are eigenvectors
    return w, v


def principal_axis3x3(a: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """``eigh3x3(a)[1][..., :, 2]``, the unit eigenvector of the largest
    eigenvalue of symmetric [..., 3, 3], computed as the reference's
    jitted kNN edge fits compute it (ROADMAP §C19), where XLA keeps only
    this column. In float32: the trace in index order; ``/ 3`` and ``/ 6``
    as products with float32 reciprocals, fused into the shift
    ``a_ii - trace/3`` and into the eigenvalue ``trace/3 + 2 p cos(phi)``;
    the sums of squares and every cross product and 2x2 minor as
    ``fma``s; ``arccos`` and ``cos`` as XLA:CPU computes them
    (``xf.acos``, ``xf.cos``: glibc's ``atan2f`` and ``cosf``). Other
    dtypes: ``eigh3x3``'s arithmetic, bit for bit.
    The near-isotropic test keeps its unfused threshold."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]

    def last(*v):
        return torch.stack(v, dim=-1)

    # Each step on the stacked operands of its kind: one call of the
    # float32 forms instead of one per operand.
    tr = (a00 + a11) + a22
    s00, s11, s22 = xf.div_add(-tr[..., None], 3.0,
                               last(a00, a11, a22)).unbind(-1)
    # sums of squares of the shifted diagonal and of the off-diagonal
    x0, x1, x2 = last(s00, a01), last(s11, a02), last(s22, a12)
    diag, off = xf.fma(x2, x2, xf.fma(x0, x0, x1 * x1)).unbind(-1)
    p2 = xf.fma(2.0, off, diag)
    p = xf.sqrt(torch.clamp_min(xf.div_const(p2, 6.0), eps))

    # det(B) / 2 for B = (A - q I) / p
    b00, b11, b22, b01, b02, b12 = (
        last(s00, s11, s22, a01, a02, a12) / p[..., None]).unbind(-1)
    m0, m1, m2 = xf.fms(last(b22, b22, b12), last(b11, b01, b01),
                        last(b12, b12, b11), last(b12, b02, b02)).unbind(-1)
    detb = xf.fma(b02, m2, xf.fms(b00, m0, b01, m1))
    phi = xf.div_const(xf.acos(torch.clamp(detb * 0.5, -1.0, 1.0)), 3.0)
    lam = xf.div_add(tr, 3.0, (2.0 * p) * xf.cos(phi))     # largest

    r0 = last(a00 - lam, a01, a02)
    r1 = last(a01, a11 - lam, a12)
    r2 = last(a02, a12, a22 - lam)
    # [..., 3 (r0 x r1, r0 x r2, r1 x r2), 3]
    c = xf.cross(torch.stack([r0, r0, r1], dim=-2),
                 torch.stack([r1, r2, r2], dim=-2))
    n01, n02, n12 = xf.sum_squares(c, keepdim=True).unbind(-2)
    c01, c02, c12 = c.unbind(-2)
    best = torch.where(n01 >= torch.maximum(n02, n12), c01,
                       torch.where(n02 >= n12, c02, c12))
    v = best / xf.sqrt(torch.clamp_min(
        xf.sum_squares(best, keepdim=True), eps))

    q = xf.div_const(tr, 3.0)
    iso = p2 < (1e-12 * q * q + 1e-30)
    ez = torch.zeros_like(v)     # made on the device: no copy from the host
    ez[..., 2] = 1.0
    return torch.where(iso[..., None], ez, v)
