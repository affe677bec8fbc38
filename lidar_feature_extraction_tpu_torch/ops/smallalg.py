"""Small-matrix linear algebra as straight-line tensor code.

Port of ``lidar_feature_extraction_tpu/ops/smallalg.py``: the batched
closed-form symmetric 3x3 solve of the plane fits, the unrolled Cholesky
solve of the 6x6 GN system, the degeneracy test on the 7x7 unweighted
Hessian, and fixed-sweep Jacobi eigenvalues. Unrolled as in the
reference (no ``torch.linalg``), so the results follow its arithmetic
and nothing is read back to the host.
"""

from __future__ import annotations

import torch

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf


def solve3x3_sym(a: torch.Tensor, b: torch.Tensor,
                 eps: float = 1e-30, rounded: bool = False) -> torch.Tensor:
    """Solve ``a x = b`` for symmetric ``a`` [..., 3, 3], b [..., 3] by
    the adjugate (Cramer) form. A singular system gives large-magnitude
    garbage that the caller gates.

    In float32 it computes what the reference's jitted plane fits do
    (ROADMAP §C19): every cofactor ``fma(x, y, -(u*v))``; the determinant
    ``fma(a02, c02, fma(a00, c00, a01*c01))`` for x0 and x2 but
    ``fma(a02, c02, fma(a01, c01, a00*c00))`` for x1 (XLA computes each
    component in its own loop, and LLVM fused the two products of the
    first add the other way round in x1's); each numerator row . b as
    ``fma(r2, b2, fma(r1, b1, r0*b0))``. Other dtypes, and float32 with
    ``rounded`` (the reference's plane fits outside a jitted program),
    round each operation, in the order (a00 c00 + a01 c01) + a02 c02."""
    a00, a01, a02 = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
    a11, a12, a22 = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
    if rounded or not xf._float32(a, b):
        c00, c01, c02 = a11 * a22 - a12 * a12, a02 * a12 - a01 * a22, \
            a01 * a12 - a02 * a11
        c11, c12, c22 = a00 * a22 - a02 * a02, a01 * a02 - a00 * a12, \
            a00 * a11 - a01 * a01
        det = a00 * c00 + a01 * c01 + a02 * c02
        inv_det = 1.0 / torch.where(torch.abs(det) < eps, torch.where(
            det < 0, -eps, eps).to(det.dtype), det)
        b0, b1, b2 = b.unbind(-1)
        return torch.stack([(c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
                            (c01 * b0 + c11 * b1 + c12 * b2) * inv_det,
                            (c02 * b0 + c12 * b1 + c22 * b2) * inv_det],
                           dim=-1)

    def last(*v):
        return torch.stack(v, dim=-1)

    # Each step on the stacked operands of its kind: one call of the
    # float32 forms instead of one per operand.
    c00, c01, c02, c11, c12, c22 = xf.fms(
        last(a11, a02, a01, a00, a01, a00), last(a22, a12, a12, a22, a02, a11),
        last(a12, a01, a02, a02, a00, a01), last(a12, a22, a11, a02, a12, a01)
    ).unbind(-1)
    # [det of x0 and x2, det of x1]
    det = xf.fma(a02[..., None], c02[..., None], xf.fma(
        last(a00, a01), last(c00, c01), last(a01 * c01, a00 * c00)))
    tiny = torch.where(det < 0, -eps, eps).to(det.dtype)
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, tiny, det)
    # x_i's numerator: row i of the cofactors . b
    num = xf.fma(last(c02, c12, c22), b[..., 2:], xf.fma(
        last(c01, c11, c12), b[..., 1:2], last(c00, c01, c02) * b[..., :1]))
    return num * torch.cat([inv_det, inv_det[..., :1]], dim=-1)


def cholesky_solve(a: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-30) -> torch.Tensor:
    """Solve SPD ``a x = b`` (a [..., n, n], b [..., n]) by an unrolled
    Cholesky factorization, leading dimensions a batch. Non-SPD input
    gives inf/nan, which the caller's degeneracy guard turns into a zero
    update."""
    n = a.shape[-1]
    rows = [a[..., i, :] for i in range(n)]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = rows[i][..., j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                l[i][i] = torch.sqrt(s)
            else:
                ljj = l[j][j]
                l[i][j] = s / torch.where(torch.abs(ljj) < eps,
                                          torch.full_like(ljj, eps), ljj)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def min_eigval_below(a: torch.Tensor, tau: float) -> torch.Tensor:
    """True iff the minimum eigenvalue of symmetric PSD ``a`` [..., n, n]
    is below ``tau`` ([...]): (a - tau I) fails an unrolled Cholesky
    exactly when a pivot is not positive."""
    n = a.shape[-1]
    a = a - tau * torch.eye(n, dtype=a.dtype, device=a.device)
    rows = [a[..., i, :] for i in range(n)]
    l = [[None] * n for _ in range(n)]
    ok = torch.ones(a.shape[:-2], dtype=torch.bool, device=a.device)
    for i in range(n):
        for j in range(i + 1):
            s = rows[i][..., j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            if i == j:
                ok = ok & (s > 0)
                l[i][i] = torch.sqrt(torch.clamp_min(s, 1e-30))
            else:
                l[i][j] = s / l[j][j]
    return ~ok


def jacobi_eigvalsh(a: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """Eigenvalues of a symmetric [n, n] by ``sweeps`` unconditional
    cyclic Jacobi sweeps, in unspecified order."""
    n = a.shape[-1]
    eps = 1e-30

    def rotate(a, p, q):
        app, aqq, apq = a[p, p], a[q, q], a[p, q]
        small = torch.abs(apq) < eps
        theta = (aqq - app) / (2.0 * torch.where(
            small, torch.full_like(apq, eps), apq))
        sign = torch.where(theta >= 0, 1.0, -1.0)
        t = sign / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
        t = torch.where(small, torch.zeros_like(t), t)
        c = 1.0 / torch.sqrt(t * t + 1.0)
        s = t * c
        rp = c * a[p, :] - s * a[q, :]
        rq = s * a[p, :] + c * a[q, :]
        a = a.clone()
        a[p, :] = rp
        a[q, :] = rq
        cp = c * a[:, p] - s * a[:, q]
        cq = s * a[:, p] + c * a[:, q]
        a[:, p] = cp
        a[:, q] = cq
        return a

    for _ in range(sweeps):
        for p in range(n):
            for q in range(p + 1, n):
                a = rotate(a, p, q)
    return torch.diagonal(a)
