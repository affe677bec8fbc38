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


def quat_rotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate point(s) ``p`` [..., 3] by quaternion(s) ``q`` [..., 4]
    (expanded Rodrigues form, two cross products)."""
    w = q[..., :1]
    v = q[..., 1:]
    uv = _cross(v, p)
    uuv = _cross(v, uv)
    return p + 2.0 * (w * uv + uuv)


def quat_rotate_fma(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``quat_rotate`` as the reference's jitted kNN fits compute it: in
    float32 each cross-product component ``fma(a_i, b_j, -(a_j*b_i))``,
    then ``p + 2 fma(w, uv, uuv)`` (ROADMAP §C19); other dtypes as
    ``quat_rotate``."""
    uv = xf.cross(q[..., 1:], p)
    uuv = xf.cross(q[..., 1:], uv)
    return p + 2.0 * xf.fma(q[..., :1], uv, uuv)


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
            plain: bool = False) -> torch.Tensor:
    """Angle-axis vector [..., 3] -> unit quaternion (exponential map),
    with the reference's small-angle branch as a ``where``. ``plain``:
    torch's ``sqrt``, ``sin`` and ``cos`` in place of the float32 forms,
    for callers that batch or differentiate it with ``torch.func``."""
    k = _norm(theta, keepdim=True, plain=plain)
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
