"""Small-matrix linear algebra as straight-line tensor code.

Port of ``lidar_feature_extraction_tpu/ops/smallalg.py:57-162``: the
unrolled Cholesky solve of the 6x6 GN system, the degeneracy test on the
7x7 unweighted Hessian, and fixed-sweep Jacobi eigenvalues. Unrolled as
in the reference (no ``torch.linalg``), so the results follow its
arithmetic and nothing is read back to the host.
"""

from __future__ import annotations

import torch


def cholesky_solve(a: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-30) -> torch.Tensor:
    """Solve SPD ``a x = b`` (a [n, n], b [n]) by an unrolled Cholesky
    factorization. Non-SPD input gives inf/nan, which the caller's
    degeneracy guard turns into a zero update."""
    n = a.shape[-1]
    rows = [a[i] for i in range(n)]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = rows[i][j]
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
        s = b[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x)


def min_eigval_below(a: torch.Tensor, tau: float) -> torch.Tensor:
    """True iff the minimum eigenvalue of symmetric PSD ``a`` [n, n] is
    below ``tau``: (a - tau I) fails an unrolled Cholesky exactly when a
    pivot is not positive."""
    n = a.shape[-1]
    a = a - tau * torch.eye(n, dtype=a.dtype, device=a.device)
    rows = [a[i] for i in range(n)]
    l = [[None] * n for _ in range(n)]
    ok = torch.ones((), dtype=torch.bool, device=a.device)
    for i in range(n):
        for j in range(i + 1):
            s = rows[i][j]
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
