"""Float32 arithmetic as the JAX package's jitted code computes it on the
CPU, for the sites where the port's results must equal the reference's
bit for bit (ROADMAP §C18-§C20).

XLA:CPU compiles each fusion of a jitted program through LLVM with
fp-contract=fast and FMA hardware, so:

- a float32 product whose one use is an add or a subtract is fused into
  it (``fma``): ``a*b - c*d`` becomes ``fma(a, b, -(c*d))`` (``fms``);
  where both operands of an add are products, LLVM fuses the one it
  meets first, which depends on the program, so each call site names its
  order and is checked against the program the reference runs;
- a reduction accumulates in index order from the first element, each
  product fused into the running sum (``dot``, ``sum_squares``,
  ``matmul``, ``gram``;
  ``sum_in_order`` where the terms are not products);
- a division by a constant becomes a multiplication by the constant's
  float32 reciprocal (XLA's algebraic simplifier), which fuses like any
  product (``div_const``, ``div_add``);
- ``cos``, ``sin`` and ``atan2`` call glibc's ``cosf``, ``sinf`` and
  ``atan2f``, ``arccos(x)`` is ``atan2f(sqrt((1 - x)(1 + x)), x)`` and
  ``arcsin(x)`` is ``2 atan2f(x, 1 + sqrt((1 - x)(1 + x)))``: ``cos``,
  ``sin``, ``atan2``, ``acos`` and ``asin`` here compute those bit for
  bit (from the library's own algorithms and constants).

In every other dtype each helper computes the plain expression, one
rounding per operation, in the order the port always used, so float64
results do not change. The float32 forms read float bits through
integer views and a kernel, which ``torch.func`` transforms cannot batch
or differentiate: code that transforms its arithmetic (the IMU graph's
linearization) calls plain torch functions instead
(``quaternion.exp_so3(..., plain=True)``); the pose graph writes its
forward mode out (``parallel/pose_graph.py::_linearize``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _float32(*operands) -> bool:
    """Whether the float32 forms apply: every tensor operand is float32
    (Python floats aside). Otherwise the plain expression runs, in the
    dtype torch promotes the operands to."""
    return all(t.dtype == torch.float32
               for t in operands if isinstance(t, torch.Tensor))


def fma(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` as the reference's jitted code computes it: in
    float32 rounded once, as a fused multiply-add (on CUDA tensors the
    ``fma_f32`` kernel, ``ops/fma_cuda.py``; on the CPU its plain
    version ``_fma_plain``, which rounds the same); other dtypes round
    each operation. ``a`` may be a Python float that float32 holds
    exactly."""
    if b.is_cuda and _float32(a, b, c):
        return _fma_cuda()(a, b, c)
    return _fma_plain(a, b, c)


@functools.cache
def _fma_cuda():
    """``ops/fma_cuda.fma_f32_cuda``, imported at the first call on a card
    (that module imports torch's CUDA build helpers) and then reused."""
    from lidar_feature_extraction_tpu_torch.ops.fma_cuda import fma_f32_cuda
    return fma_f32_cuda


def _fma_plain(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fma`` in plain tensor operations on any device. In float32 the
    float64 product of two float32 values is exact, TwoSum gives the
    float64 sum and its exact error, and rounding that sum to odd (the
    neighbour with an odd last bit when the error is not 0) makes the
    final rounding to float32 correct; other dtypes ``a * b + c``."""
    if not _float32(a, b, c):
        return a * b + c
    p = b.double() * (a.double() if isinstance(a, torch.Tensor) else a)
    c = c.double()
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0) \
        & (torch.abs(s) < math.inf)
    away = torch.nextafter(s, err * math.inf)
    return torch.where(inexact_even, away, s).float()


def sqrt(v: torch.Tensor) -> torch.Tensor:
    """Square root, in float32 correctly rounded (from float64, where the
    double rounding is exact)."""
    if not _float32(v):
        return torch.sqrt(v)
    return torch.sqrt(v.double()).float()


def _f32(bits: int) -> float:
    """The float32 value of an IEEE bit pattern."""
    return float(np.array(bits, np.uint32).view(np.float32))


# glibc's float ``atanf`` (fdlibm): atan(0.5), atan(1), atan(1.5),
# atan(inf) split in a high and a low part, and the polynomial's
# coefficients (the even ones from aT[10] down to aT[0], then aT[9] and
# the magnitudes of the negative aT[7] .. aT[1]).
_ATAN_HI = tuple(map(_f32, (0x3eed6338, 0x3f490fda, 0x3f7b985e, 0x3fc90fda)))
_ATAN_LO = tuple(map(_f32, (0x31ac3769, 0x33222168, 0x33140fb4, 0x33a22168)))
_AT_EVEN = tuple(map(_f32, (0x3c8569d7, 0x3d4bda59, 0x3d886b35, 0x3dba2e6e,
                            0x3e124925, 0x3eaaaaab)))
_AT_ODD = tuple(map(_f32, (0xbd15a221, 0x3d6ef16b, 0x3d9d8795, 0x3de38e38,
                           0x3e4ccccd)))
_PI, _PI_2 = _f32(0x40490fdb), _f32(0x3fc90fdb)
_PI_LO = _f32(0x33bbbd2e)          # -pi_lo: pi - float32(pi)


def _pick(index: torch.Tensor, values) -> torch.Tensor:
    """``values[index]`` for a short tuple of Python floats, as a chain of
    ``where`` (indexing with a tensor made from the tuple would copy it
    from the host)."""
    out = torch.full(index.shape, values[-1], dtype=torch.float32,
                     device=index.device)
    for k in range(len(values) - 2, -1, -1):
        out = torch.where(index == k, values[k], out)
    return out


def _atanf(x: torch.Tensor) -> torch.Tensor:
    """glibc's ``atanf`` (fdlibm's, float32 arithmetic): the argument
    reduced to one of four intervals, an odd and an even polynomial."""
    ix = x.view(torch.int32) & 0x7fffffff
    xa = torch.abs(x)
    part = torch.where(ix < 0x3f300000, 0, torch.where(
        ix < 0x3f980000, 1, torch.where(ix < 0x401c0000, 2, 3)))
    reduced = torch.where(part == 0, (xa + xa - 1.0) / (xa + 2.0),
                          torch.where(part == 1, (xa - 1.0) / (xa + 1.0),
                                      torch.where(part == 2,
                                                  (xa - 1.5) / (xa * 1.5 + 1.0),
                                                  -1.0 / xa)))
    small = ix < 0x3ee00000
    xr = torch.where(small, x, reduced)
    z = xr * xr
    w = z * z
    s1 = w * _AT_EVEN[0]
    for c in _AT_EVEN[1:5]:
        s1 = (s1 + c) * w
    s1 = (s1 + _AT_EVEN[5]) * z
    s2 = w * _AT_ODD[0]
    for c in _AT_ODD[1:]:
        s2 = (s2 - c) * w
    t = (s1 + s2) * xr
    big = _pick(part, _ATAN_HI) - ((t - _pick(part, _ATAN_LO)) - xr)
    out = torch.where(small, xr - t, torch.where(x < 0, -big, big))
    out = torch.where(ix < 0x31000000, x, out)
    limit = torch.full_like(x, _ATAN_HI[3]) + _ATAN_LO[3]
    return torch.where(ix >= 0x4c000000, torch.copysign(limit, x), out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``atan2(y, x)`` of finite float32 values as XLA:CPU computes it:
    glibc's ``atan2f`` (fdlibm's, over ``_atanf``). Other dtypes:
    ``torch.atan2``."""
    if not _float32(y, x):
        return torch.atan2(y, x)
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7fffffff, hy & 0x7fffffff
    k = (iy - ix) >> 23
    one = hx == 0x3f800000
    # One _atanf call serves both branches: atanf(y) where x is 1.
    a = _atanf(torch.where(one, y, torch.abs(y / x)))
    z = torch.where(k > 60, torch.full_like(y, _PI_2) - _f32(0x333bbd2e),
                    torch.where((hx < 0) & (k < -60), torch.zeros_like(y), a))
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)
    out = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(
        m == 2, _PI - (z + _PI_LO), (z + _PI_LO) - _PI)))
    out = torch.where(iy == 0, torch.where(m <= 1, y, torch.where(
        m == 2, _PI, -_PI)), out)
    out = torch.where((ix == 0) & (iy != 0),
                      torch.where(hy < 0, -_PI_2, _PI_2), out)
    return torch.where(one, a, out)


def acos(v: torch.Tensor) -> torch.Tensor:
    """``arccos`` as XLA:CPU lowers it for float32: ``atan2(sqrt((1 - v)
    (1 + v)), v)``, with glibc's ``atan2f``. Other dtypes:
    ``torch.acos``."""
    if not _float32(v):
        return torch.acos(v)
    return atan2(sqrt((1.0 - v) * (1.0 + v)), v)


def rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)`` of positive normal float32 values as XLA:CPU
    computes its ``rsqrt`` (which its simplifier makes of ``k / sqrt``):
    the x86 ``vrsqrtps`` estimate, then two Newton steps
    ``y + (-y / 2) (v y y - 1)`` with the products fused as the IR does.
    The estimate is a function of the exponent's parity and the top ten
    bits of the mantissa: 12 bits, ``round(8192 / sqrt(m) - 4096)`` at the
    midpoint m of that input interval scaled to [1, 4) (held against the
    instruction on every input in [1, 4) and 800,000 random normals).
    Other dtypes: ``1 / torch.sqrt``."""
    if not _float32(v):
        return 1.0 / torch.sqrt(v)
    bits = v.view(torch.int32)
    exponent = (bits >> 23) & 0xFF
    odd = (exponent & 1) == 1
    m12 = _rsqrt_m12(v)
    scale = (126 - (exponent - torch.where(odd, 127, 128)) // 2).to(
        torch.int32)
    y = ((scale << 23) | (m12 << 11)).view(torch.float32)
    for _ in range(2):
        y = fma(y * -0.5, fma(v * y, y, torch.full_like(y, -1.0)), y)
    return y


def _rsqrt_m12(v: torch.Tensor) -> torch.Tensor:
    """The 12-bit mantissa of ``rsqrt``'s estimate of float32 ``v``
    (int32): ``round(8192 / sqrt(mid) - 4096)`` in float64 at the midpoint
    ``mid`` of the input's class (the exponent's parity and the top ten
    mantissa bits) scaled to [1, 4)."""
    bits = v.view(torch.int32)
    odd = ((bits >> 23) & 1) == 1
    mid = (1.0 + (((bits >> 13) & 0x3FF).double() + 0.5) / 1024.0) \
        * torch.where(odd, 1.0, 2.0)
    return torch.round(8192.0 / torch.sqrt(mid) - 4096.0).to(torch.int32)


def asin(v: torch.Tensor) -> torch.Tensor:
    """``arcsin`` as XLA:CPU lowers it for float32:
    ``2 atan2(v, 1 + sqrt((1 - v)(1 + v)))``, each step rounded, with
    glibc's ``atan2f``. Other dtypes: ``torch.asin``."""
    if not _float32(v):
        return torch.asin(v)
    a = atan2(v, sqrt((1.0 - v) * (1.0 + v)) + 1.0)
    return a + a


# glibc's ``cosf`` (the FMA build of ``sysdeps/ieee754/flt-32``): float64
# polynomials for cos and sin on |x| <= pi/4 after a reduction by
# multiples of pi/2; ``_COS_TAB`` holds hpi_inv = 2^24 * 2/pi, hpi = pi/2
# and the coefficients c0..c4 and s1..s3.
_COS_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_COS_HPI = float.fromhex("0x1.921fb54442d18p+0")
_COS_C = tuple(map(float.fromhex, ("0x1p0", "-0x1.ffffffd0c621cp-2",
                                   "0x1.55553e1068f19p-5",
                                   "-0x1.6c087e89a359dp-10",
                                   "0x1.99343027bf8c3p-16")))
_COS_S = tuple(map(float.fromhex, ("-0x1.555545995a603p-3",
                                   "0x1.1107605230bc4p-7",
                                   "-0x1.994eb3774cf24p-13")))


def _cos_poly(x2: torch.Tensor) -> torch.Tensor:
    c = _COS_C
    x4 = x2 * x2
    c1 = x2 * c[1] + c[0]
    c2 = x2 * c[4] + c[3]
    return c2 * (x2 * x4) + (x4 * c[2] + c1)


def _sin_poly(x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    s = _COS_S
    x3 = x2 * x
    return (x2 * s[2] + s[1]) * (x2 * x3) + (x3 * s[0] + x)


def _sincos(v: torch.Tensor, odd_shift) -> torch.Tensor:
    """glibc's ``cosf`` (``odd_shift`` 1) or ``sinf`` (0) for |v| < 120,
    or elementwise either (``odd_shift`` an integer tensor of 0s and 1s
    broadcasting against ``v``): reduce by n multiples of pi/2, then the
    sine polynomial of the remainder where n + odd_shift is even, else
    the cosine one; the sign flips where (n + odd_shift) mod 4 is 2 or 3.
    Its float64 steps round once each (the library fuses some; the
    float32 result agreed with it on every input tried, 10^6 in
    [-3.3, 3.3])."""
    x = v.double()
    top = (v.view(torch.int32) >> 20) & 0x7ff
    n = ((x * _COS_HPI_INV).to(torch.int32) + 0x800000) >> 24
    xr = x - n.double() * _COS_HPI
    x2 = xr * xr
    m = n + odd_shift
    red = torch.where((m & 1) == 0, _sin_poly(xr, x2), _cos_poly(x2))
    red = torch.where((m & 2) != 0, -red, red)
    if isinstance(odd_shift, int):
        near = _cos_poly(x * x) if odd_shift else _sin_poly(x, x * x)
        tiny = 1.0 if odd_shift else v
    else:
        odd = odd_shift == 1
        near = torch.where(odd, _cos_poly(x * x), _sin_poly(x, x * x))
        tiny = torch.where(odd, torch.ones_like(v), v)
    out = torch.where(top <= 0x3f3, near, red).float()
    return torch.where(top <= 0x397, tiny, out)


def cos(v: torch.Tensor) -> torch.Tensor:
    """``cos`` as XLA:CPU computes it for float32 (|v| < 120): glibc's
    ``cosf``. Other dtypes: ``torch.cos``."""
    if not _float32(v):
        return torch.cos(v)
    return _sincos(v, 1)


def sincos(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sin(v), cos(v))`` as ``sin`` and ``cos`` compute them, in one
    pass over the stacked arguments. Other dtypes: torch's."""
    if not _float32(v):
        return torch.sin(v), torch.cos(v)
    shift = torch.arange(2, device=v.device).view((2,) + (1,) * v.dim())
    both = _sincos(torch.stack([v, v]), shift)
    return both[0], both[1]


def sin(v: torch.Tensor) -> torch.Tensor:
    """``sin`` as XLA:CPU computes it for float32 (|v| < 120): glibc's
    ``sinf``. Other dtypes: ``torch.sin``."""
    if not _float32(v):
        return torch.sin(v)
    return _sincos(v, 0)


def fms(a, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor
        ) -> torch.Tensor:
    """``a*b - c*d``: in float32 ``fma(a, b, -(c*d))``."""
    if not _float32(a, b, c, d):
        return a * b - c * d
    return fma(a, b, -(c * d))


def cross(a: torch.Tensor, b: torch.Tensor,
          fuse_second: bool = False) -> torch.Tensor:
    """``a x b`` over the last axis (broadcasting like ``jnp.cross``),
    each component ``fms``: the three components in one call;
    ``fuse_second``: each component ``fma(-a[k+2], b[k+1], a[k+1]
    b[k+2])``, the second product fused. The components are rotated
    with ``torch.roll``: indexing a card's tensor with a Python list
    copies the index from the host, which waits for the card."""
    a, b = torch.broadcast_tensors(a, b)
    # component k: a[k+1] b[k+2] - a[k+2] b[k+1]
    a1, b2 = torch.roll(a, -1, -1), torch.roll(b, 1, -1)
    a2, b1 = torch.roll(a, 1, -1), torch.roll(b, -1, -1)
    if fuse_second and _float32(a, b):
        return fma(-a2, b1, a1 * b2)
    return fms(a1, b2, a2, b1)


def _reciprocal(c: float, dtype: torch.dtype) -> float:
    return float(np.float32(1.0 / c)) if dtype == torch.float32 else None


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``: in float32 ``x * float32(1/c)``."""
    r = _reciprocal(c, x.dtype) if _float32(x) else None
    return x / c if r is None else x * r


def div_add(x: torch.Tensor, c: float, y: torch.Tensor) -> torch.Tensor:
    """``x / c + y`` for a constant ``c``: in float32
    ``fma(x, float32(1/c), y)``."""
    r = _reciprocal(c, x.dtype) if _float32(x, y) else None
    return x / c + y if r is None else fma(r, x, y)


def dot(a: torch.Tensor, b: torch.Tensor,
        keepdim: bool = False) -> torch.Tensor:
    """``sum(a * b)`` over the last axis (broadcasting): in float32 the
    first product, then one ``fma`` per element in order, e.g.
    ``fma(a2, b2, fma(a1, b1, a0*b0))``."""
    if not _float32(a, b):
        return torch.sum(a * b, dim=-1, keepdim=keepdim)
    a, b = torch.broadcast_tensors(a, b)
    out = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        out = fma(a[..., k], b[..., k], out)
    return out[..., None] if keepdim else out


def sum_squares(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum of squares over the last axis: ``dot(x, x)``; in float32
    ``fma(x2, x2, fma(x1, x1, x0*x0))`` for three elements."""
    return dot(x, x, keepdim)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` ([..., I, K] x [..., K, J]) as XLA:CPU's elemental dot
    computes it: in float32 each entry the k = 0 product, then one
    ``fma`` per k in order."""
    if not _float32(a, b):
        return a @ b
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = fma(a[..., :, k:k + 1], b[..., k:k + 1, :], out)
    return out


def vecmat(u: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``u^T m`` ([..., K] and [..., K, J] -> [..., J]): in float32
    ``matmul``'s chain over K; other dtypes ``einsum``."""
    if not _float32(u, m):
        return torch.einsum("...i,...ij->...j", u, m)
    return matmul(u[..., None, :], m)[..., 0, :]


def sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim``: in float32 added in index order."""
    if not _float32(x):
        return torch.sum(x, dim=dim)
    terms = x.unbind(dim)
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_k a[..., k, i] * b[..., k, j]`` ([..., K, 3] each -> [..., 3,
    3]): in float32 the k = 0 product, then one ``fma`` per k in order."""
    if not _float32(a, b):
        return torch.einsum("...ki,...kj->...ij", a, b)
    rows_a, rows_b = a.unbind(-2), b.unbind(-2)
    acc = rows_a[0][..., :, None] * rows_b[0][..., None, :]
    for x, y in zip(rows_a[1:], rows_b[1:]):
        acc = fma(x[..., :, None], y[..., None, :], acc)
    return acc
