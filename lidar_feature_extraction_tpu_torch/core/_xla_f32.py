"""Float32 arithmetic as the JAX package's jitted code computes it on the
CPU, for the sites where the port's results must equal the reference's
bit for bit (ROADMAP §C18, §C19).

XLA:CPU compiles each fusion of a jitted program through LLVM with
fp-contract=fast and FMA hardware, so:

- a float32 product whose one use is an add or a subtract is fused into
  it (``fma``): ``a*b - c*d`` becomes ``fma(a, b, -(c*d))`` (``fms``);
  where both operands of an add are products, LLVM fuses the one it
  meets first, which depends on the program, so each call site names its
  order and is checked against the program the reference runs;
- a reduction accumulates in index order from the first element, each
  product fused into the running sum (``sum_squares``, ``gram``;
  ``sum_in_order`` where the terms are not products);
- a division by a constant becomes a multiplication by the constant's
  float32 reciprocal (XLA's algebraic simplifier), which fuses like any
  product (``div_const``, ``div_add``).

In every other dtype each helper computes the plain expression, one
rounding per operation, in the order the port always used, so float64
results do not change.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def fma(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` as the reference's jitted code computes it. In
    float32 rounded once, as a fused multiply-add: the float64 product of
    two float32 values is exact, TwoSum gives the float64 sum and its
    exact error, and rounding that sum to odd (the neighbour with an odd
    last bit when the error is not 0) makes the final rounding to float32
    correct. Other dtypes round each operation. ``a`` may be a Python
    float that float32 holds exactly."""
    if b.dtype != torch.float32:
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
    if v.dtype != torch.float32:
        return torch.sqrt(v)
    return torch.sqrt(v.double()).float()


def acos(v: torch.Tensor) -> torch.Tensor:
    """``arccos``, in float32 computed in float64 and rounded: XLA's own
    float32 approximation is an ulp off on some inputs and is not
    emulated; this gives the CPU and the card the same bits."""
    if v.dtype != torch.float32:
        return torch.acos(v)
    return torch.acos(v.double()).float()


def cos(v: torch.Tensor) -> torch.Tensor:
    """``cos``, in float32 computed in float64 and rounded (as ``acos``)."""
    if v.dtype != torch.float32:
        return torch.cos(v)
    return torch.cos(v.double()).float()


def fms(a, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor
        ) -> torch.Tensor:
    """``a*b - c*d``: in float32 ``fma(a, b, -(c*d))``."""
    if b.dtype != torch.float32:
        return a * b - c * d
    return fma(a, b, -(c * d))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` over the last axis (broadcasting like ``jnp.cross``),
    each component ``fms``: the three components in one call. The
    components are rotated with ``torch.roll``: indexing a card's tensor
    with a Python list copies the index from the host, which waits for
    the card."""
    a, b = torch.broadcast_tensors(a, b)
    # component k: a[k+1] b[k+2] - a[k+2] b[k+1]
    return fms(torch.roll(a, -1, -1), torch.roll(b, 1, -1),
               torch.roll(a, 1, -1), torch.roll(b, -1, -1))


def _reciprocal(c: float, dtype: torch.dtype) -> float:
    return float(np.float32(1.0 / c)) if dtype == torch.float32 else None


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c``: in float32 ``x * float32(1/c)``."""
    r = _reciprocal(c, x.dtype)
    return x / c if r is None else x * r


def div_add(x: torch.Tensor, c: float, y: torch.Tensor) -> torch.Tensor:
    """``x / c + y`` for a constant ``c``: in float32
    ``fma(x, float32(1/c), y)``."""
    r = _reciprocal(c, x.dtype)
    return x / c + y if r is None else fma(r, x, y)


def sum_squares(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum of squares over the last axis (size 3): in float32
    ``fma(x2, x2, fma(x1, x1, x0*x0))``."""
    if x.dtype != torch.float32:
        return torch.sum(x * x, dim=-1, keepdim=keepdim)
    x0, x1, x2 = x[..., 0], x[..., 1], x[..., 2]
    out = fma(x2, x2, fma(x1, x1, x0 * x0))
    return out[..., None] if keepdim else out


def sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim``: in float32 added in index order."""
    if x.dtype != torch.float32:
        return torch.sum(x, dim=dim)
    terms = x.unbind(dim)
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_k a[..., k, i] * b[..., k, j]`` ([..., K, 3] each -> [..., 3,
    3]): in float32 the k = 0 product, then one ``fma`` per k in order."""
    if a.dtype != torch.float32:
        return torch.einsum("...ki,...kj->...ij", a, b)
    rows_a, rows_b = a.unbind(-2), b.unbind(-2)
    acc = rows_a[0][..., :, None] * rows_b[0][..., None, :]
    for x, y in zip(rows_a[1:], rows_b[1:]):
        acc = fma(x[..., :, None], y[..., None, :], acc)
    return acc
