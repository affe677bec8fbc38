"""Quaternion calculus over batched torch tensors.

Port of ``lidar_feature_extraction_tpu/core/quaternion.py``, the
functions the localization step and the closed loop use. Conventions are the
reference's: quaternions are ``[..., 4]`` in **wxyz** order, rotations
act as ``R(q) p``, and ``drpdq`` is Sola eq. 174. Every function takes
arbitrary leading batch dimensions, broadcast between its arguments.
In float32 the transcendental functions are glibc's (``sinf``, ``cosf``,
``atan2f``), which XLA:CPU calls (``core/_xla_f32.py``, ROADMAP §C20).
"""

from __future__ import annotations

import torch

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` over the last axis, broadcasting like ``jnp.cross``."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``v``: ``hat(v) @ u = v x u``.
    ``[..., 3] -> [..., 3, 3]``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def quat_identity(dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a * b`` in wxyz, batched."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


# The Hamilton product's terms: component k of a * b is the sum over
# (x, y, sign) of sign * a[x] * b[y], in the reference's order.
_HAMILTON = (((0, 0, 1), (1, 1, -1), (2, 2, -1), (3, 3, -1)),
             ((0, 1, 1), (1, 0, 1), (2, 3, 1), (3, 2, -1)),
             ((0, 2, 1), (1, 3, -1), (2, 0, 1), (3, 1, 1)),
             ((0, 3, 1), (1, 2, 1), (2, 1, -1), (3, 0, 1)))


def _hamilton_fma(a, b, k: int, fuse_second: bool = False) -> torch.Tensor:
    """Component ``k`` of ``a * b`` in ``quat_multiply_fma``'s float32
    form; ``a`` and ``b`` are sequences of the four component tensors."""
    (x0, y0, s0), (x1, y1, s1), *rest = _HAMILTON[k]
    p0, p1 = (-a[x0] if s0 < 0 else a[x0], b[y0]), \
        (-a[x1] if s1 < 0 else a[x1], b[y1])
    first, second = (p1, p0) if fuse_second else (p0, p1)
    acc = xf.fma(first[0], first[1], second[0] * second[1])
    for x, y, s in rest:
        acc = xf.fma(-a[x] if s < 0 else a[x], b[y], acc)
    return acc


def quat_multiply_fma(a: torch.Tensor, b: torch.Tensor,
                      fuse_second: bool = False) -> torch.Tensor:
    """``quat_multiply`` as a jitted program of the reference computes
    it: in float32 each component's first two products as ``fma`` of
    one into the other, rounded (the first product fused into the
    second's rounded value, or with ``fuse_second`` the second into the
    first's, as the program's fusion orders them), then each further
    product fused into the running sum; other dtypes as
    ``quat_multiply``. ``fuse_second`` may also be the set of components
    that take the second order."""
    if not xf._float32(a, b):
        return quat_multiply(a, b)
    a, b = a.unbind(-1), b.unbind(-1)
    second = set(range(4)) if fuse_second is True else \
        set(fuse_second or ())
    return torch.stack([_hamilton_fma(a, b, k, k in second)
                        for k in range(4)], dim=-1)


def quat_multiply_nested(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                         second=()) -> torch.Tensor:
    """``a * (b * c)`` as one loop of the reference's jitted program
    computes it: in float32 both products in ``quat_multiply_fma``'s
    form, where the loop recomputes the inner product for each outer
    component and the backend contracts each copy on its own: the inner
    component m that outer component k reads fuses its second product
    first when ``(k, m)`` is in ``second``. Other dtypes as
    ``quat_multiply``."""
    if not xf._float32(a, b, c):
        return quat_multiply(a, quat_multiply(b, c))
    b, c = b.unbind(-1), c.unbind(-1)
    first = [_hamilton_fma(b, c, m) for m in range(4)]
    flipped = {m: _hamilton_fma(b, c, m, True) for _, m in second}
    a = a.unbind(-1)
    return torch.stack([_hamilton_fma(a, [
        flipped[m] if (k, m) in second else first[m] for m in range(4)], k)
        for k in range(4)], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def _norm(v: torch.Tensor, keepdim: bool = False,
          plain: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis as the reference's jitted code
    reduces it: in float32 the in-order fused chain of squares
    (``xf.sum_squares``), the square root correctly rounded (``xf.sqrt``:
    the CPU build of torch is an ulp off on some float32 inputs);
    ``plain``: ``torch.sqrt`` of ``torch.sum``."""
    if plain:
        return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))
    return xf.sqrt(xf.sum_squares(v, keepdim))


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp_min(_norm(q, keepdim=True), eps)


def quat_rotate(q: torch.Tensor, p: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
    """Rotate point(s) ``p`` [..., 3] by quaternion(s) ``q`` [..., 4]
    (expanded Rodrigues form, two cross products), as the reference
    computes it outside a jitted program: ``jnp.cross`` is a jitted
    function of its own, so in float32 each cross product is
    ``xf.cross``'s fused form, and the rest rounds each operation.
    ``plain``: torch's cross products, for callers that batch or
    differentiate it with ``torch.func``."""
    w = q[..., :1]
    v = q[..., 1:]
    cross = _cross if plain else xf.cross
    uv = cross(v, p)
    uuv = cross(v, uv)
    return p + 2.0 * (w * uv + uuv)


def quat_rotate_fma(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``quat_rotate`` as the reference's jitted kNN fits compute it: in
    float32 each cross-product component ``fma(a_i, b_j, -(a_j*b_i))``,
    then ``p + 2 fma(w, uv, uuv)`` (ROADMAP §C19); other dtypes as
    ``quat_rotate``."""
    uv = xf.cross(q[..., 1:], p)
    uuv = xf.cross(q[..., 1:], uv)
    return p + 2.0 * xf.fma(q[..., :1], uv, uuv)


def _cross_jvp(a, da, b, db):
    """Tangent of ``xf.cross(a, b)``: per component ``(da_1 b_2 + a_1
    db_2) - (da_2 b_1 + a_2 db_1)``, in float32 each pair with its first
    product fused into the second's."""
    def r1(x):
        return torch.roll(x, -1, -1)

    def r2(x):
        return torch.roll(x, 1, -1)
    return xf.fma(r1(da), r2(b), r1(a) * r2(db)) \
        - xf.fma(r2(da), r1(b), r2(a) * r1(db))


def quat_rotate_jvp(q: torch.Tensor, p: torch.Tensor, dq: torch.Tensor,
                    dp: torch.Tensor) -> torch.Tensor:
    """Tangent of ``quat_rotate_fma(q, p)`` along ``(dq, dp)``, as the
    reference's jitted forward mode computes it: the product rule's two
    terms of each product in JAX's order, in float32 the first fused into
    the second, ``dp + 2 ((dw uv + w duv) + d(v x uv))``."""
    v, dv = q[..., 1:], dq[..., 1:]
    uv = xf.cross(v, p)
    duv = _cross_jvp(v, dv, p, dp)
    duuv = _cross_jvp(v, dv, uv, duv)
    return dp + (xf.fma(dq[..., :1], uv, q[..., :1] * duv) + duuv) * 2.0


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return torch.stack([
        torch.stack([1.0 - (tyy + tzz), txy - twz, txz + twy], dim=-1),
        torch.stack([txy + twz, 1.0 - (txx + tzz), tyz - twx], dim=-1),
        torch.stack([txz - twy, tyz + twx, 1.0 - (txx + tyy)], dim=-1),
    ], dim=-2)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] wxyz: all four
    Shepperd candidates, the one with the largest pivot selected, then
    normalized with the sign canonicalized to w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                          1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                         dim=-1)
    # argmax picks the first of equal pivots, as jnp.argmax does.
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)           # [..., 4, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :])
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def left_multiplication_matrix(q: torch.Tensor) -> torch.Tensor:
    """4x4 matrix L(q) with ``L(q) vec(r) = vec(q*r)``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([w, -x, -y, -z], dim=-1),
        torch.stack([x, w, -z, y], dim=-1),
        torch.stack([y, z, w, -x], dim=-1),
        torch.stack([z, -y, x, w], dim=-1),
    ], dim=-2)


def right_multiplication_matrix(q: torch.Tensor) -> torch.Tensor:
    """4x4 matrix R(q) with ``R(q) vec(l) = vec(l*q)``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([w, -x, -y, -z], dim=-1),
        torch.stack([x, w, z, -y], dim=-1),
        torch.stack([y, -z, w, x], dim=-1),
        torch.stack([z, y, -x, w], dim=-1),
    ], dim=-2)


def rpy_to_quat(roll, pitch, yaw) -> torch.Tensor:
    """ZYX-composed roll/pitch/yaw tensors -> quaternion (qz * qy * qx)."""
    sines, cosines = xf.sincos(torch.stack([roll * 0.5, pitch * 0.5,
                                            yaw * 0.5]))
    sr, sp, sy = sines.unbind(0)
    cr, cp, cy = cosines.unbind(0)
    return torch.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], dim=-1)


def quat_yaw(q: torch.Tensor) -> torch.Tensor:
    """Yaw (rotation about +z) of a quaternion, batched."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return xf.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def exp_so3(theta: torch.Tensor, eps: float = 1e-8,
            plain: bool = False, norm: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Angle-axis vector [..., 3] -> unit quaternion (exponential map),
    with the reference's small-angle branch as a ``where``. ``plain``:
    torch's ``sqrt``, ``sin`` and ``cos`` in place of the float32 forms,
    for callers that batch or differentiate it with ``torch.func``.
    ``norm``: ``|theta|`` [..., 1], where the caller's program reduces it
    in another form."""
    k = _norm(theta, keepdim=True, plain=plain) if norm is None else norm
    small = k < eps
    ksafe = torch.where(small, torch.ones_like(k), k)
    half = ksafe * 0.5
    sin, cos = (torch.sin(half), torch.cos(half)) if plain else \
        xf.sincos(half)
    sinc = torch.where(small, torch.full_like(k, 0.5), sin / ksafe)
    w = torch.where(small[..., 0], torch.ones_like(k[..., 0]), cos[..., 0])
    return torch.cat([w[..., None], theta * sinc], dim=-1)


def log_so3(q: torch.Tensor, eps: float = 1e-8,
            plain: bool = False) -> torch.Tensor:
    """Unit quaternion -> angle-axis vector (logarithmic map), taking
    the w >= 0 branch. ``plain``: torch's ``sqrt`` and ``atan2``, as in
    ``exp_so3``."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    vn = _norm(q[..., 1:], plain=plain)
    angle = 2.0 * (torch.atan2 if plain else xf.atan2)(vn, w)
    scale = torch.where(vn < eps, torch.full_like(vn, 2.0),
                        angle / torch.clamp_min(vn, eps))
    return q[..., 1:] * scale[..., None]


def _tie(x: torch.Tensor, y: torch.Tensor, bound: float) -> torch.Tensor:
    """JAX's derivative of ``max(x, bound)`` (or of ``min``) with
    respect to ``x`` at its value ``y``: 1 where ``x`` is taken, 0 where
    the bound is, halved on a tie."""
    one = torch.ones_like(y)
    return torch.where(x == y, one, 0.0 * one) / torch.where(
        y == bound, 2.0 * one, one)


def log_so3_jvp(q: torch.Tensor, dq: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Tangents of ``log_so3(q)`` [..., 4] along each of ``dq`` [..., T,
    4] -> [..., T, 3], as the reference's jitted forward mode computes
    them: JAX's rules for the sign flip, the clamp (``_tie``), the norm,
    ``atan2`` and the quotient, in float32 in the program's forms (its
    ``|v|^2 + w^2`` as ``fma``, each pair of product-rule terms with the
    first fused, the reduction of ``d|v|^2`` from +0)."""
    sgn = torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)
    v = q[..., 1:] * sgn
    w = q[..., :1] * sgn
    vn = _norm(v, keepdim=True)
    wc = torch.clamp(w, -1.0, 1.0)
    s = sgn[..., None, :]
    dv = dq[..., 1:] * s                                  # [..., T, 3]
    two = dv * v[..., None, :]
    two = two + two
    dsq = ((torch.zeros_like(two[..., 0]) + two[..., 0]) + two[..., 1]) \
        + two[..., 2]                                    # d|v|^2 [..., T]
    den = xf.fma(vn, vn, wc * wc)
    dvn = dsq * (0.5 / vn)
    dw = ((dq[..., 0] * s[..., 0]) * _tie(w, torch.clamp_min(w, -1.0), -1.0)
          ) * _tie(torch.clamp_min(w, -1.0), wc, 1.0)
    mx = torch.clamp_min(vn, eps)
    angle2 = xf.atan2(vn, wc) * 2.0
    # d(angle / max(|v|, eps)): the angle's term, then the divisor's
    dangle = (xf.fma(dvn, wc / den, dw * (-vn / den)) * 2.0) / mx
    small = vn < eps
    dscale = torch.where(small, torch.zeros_like(vn), xf.fma(
        (-(dvn * _tie(vn, mx, eps))) * angle2, 1.0 / (mx * mx), dangle))
    scale = torch.where(small, torch.full_like(vn, 2.0), angle2 / mx)
    return xf.fma(dv, scale[..., None], v[..., None, :] * dscale[..., None])


def drpdq(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Jacobian d(R(q) p)/dq, [..., 3, 4] (Sola eq. 174), as the
    reference's jitted residual rows compute it in float32 (ROADMAP
    §C20): ``col0 = fma(w, p, v x p)`` with the cross product of
    ``xf.cross``, ``v . p`` an in-order chain, and the right block
    ``(v.p) I + v p^T`` (the diagonal added exactly), then
    ``- p v^T`` and ``- w Hat(p)`` each fused into the running value.
    Other dtypes round each operation."""
    w = q[..., :1]
    v = q[..., 1:]
    col0 = xf.fma(w, p, xf.cross(v, p))                  # [..., 3]
    vdotp = xf.dot(v, p, keepdim=True)                   # [..., 1]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    right = vdotp[..., None] * eye + v[..., :, None] * p[..., None, :]
    right = xf.fma(-p[..., :, None], v[..., None, :], right)
    right = xf.fma(-w[..., None], hat(p), right)
    return 2.0 * torch.cat([col0[..., :, None], right], dim=-1)
