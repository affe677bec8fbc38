"""The port's float32 extraction arithmetic against the JAX package's
jitted code, which XLA:CPU contracts into fused multiply-adds (ROADMAP
§C6, §C18):

- ``_fma`` (a correctly rounded float32 ``a * b + c`` built in
  float64) equals an exact rational computation rounded to float32,
  on hypothesis-drawn triples and on hand-made ties: products that land
  exactly halfway between two float32 values, where a float64 sum
  rounded twice would go the wrong way;
- ``neighbor_flags_xy`` equals ``jax.jit(neighbor_flags_xy)`` bit for
  bit at thresholds placed between the fused and the unfused cosine of
  chosen pairs (where the unfused form gives the other flag);
- ``curvature_kernel`` equals the jitted JAX ``curvature_kernel`` bit
  for bit at paddings 2 and 5 (at 5 the first step's
  ``fma(-2p, r[i], r[i-1])`` decides bits that the unfused form
  misses).
"""

import math
from fractions import Fraction

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lidar_feature_extraction_tpu.ops import extraction as jex  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import (  # noqa: E402
    extraction as tex)


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest to ``q``, ties to even (finite range)."""
    f = np.float32(float(q))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.array(v).view(np.int32)) & 1))


def _exact_fma(a, b, c) -> np.float32:
    q = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    if q == 0:
        # IEEE: an exact zero is -0 only as the sum of two -0s.
        neg = (a == 0 or b == 0) and c == 0 \
            and bool(np.signbit(a) ^ np.signbit(b)) and bool(np.signbit(c))
        return np.float32(-0.0 if neg else 0.0)
    return _round_f32(q)


def _port_fma(a, b, c) -> np.ndarray:
    t = lambda v: torch.as_tensor(np.float32(v))  # noqa: E731
    out = tex._fma(t(a), t(b), t(c))
    assert out.dtype == torch.float32
    return out.numpy()


def _bits(v) -> np.ndarray:
    return np.asarray(v, np.float32).view(np.int32)


_F32 = st.floats(min_value=-2.0 ** 50, max_value=2.0 ** 50, width=32,
                 allow_nan=False, allow_infinity=False)


@settings(max_examples=400, deadline=None)
@given(_F32, _F32, _F32)
def test_fma_equals_exact_rounding_on_drawn_triples(a, b, c):
    assert _bits(_port_fma(a, b, c)) == _bits(_exact_fma(a, b, c))


def _halfway_cases():
    """(a, b, c) whose exact product lies halfway between two float32
    values, with c 0 (a tie: to even) or a tiny c that breaks the tie
    below the float64 sum's rounding."""
    out = []
    for k in (12, 11, 7):
        for sgn in (1.0, -1.0):
            a = np.float32(1.0 + 2.0 ** -k)
            b = np.float32(sgn * (1.0 + 2.0 ** -(24 - k)))
            # a * b = sgn * (1 + 2^-k + 2^-(24-k) + 2^-24): halfway.
            for c in (0.0, 2.0 ** -70, -2.0 ** -70, 2.0 ** -40,
                      -2.0 ** -40, 3.0, -1.0):
                out.append((a, b, np.float32(c)))
    # Exact cancellation, a subnormal result and a product of subnormal
    # scale against a normal addend.
    x = np.float32(1.0 + 2.0 ** -23)
    out += [(x, x, -np.float32(x * x)), (np.float32(2.0 ** -75),
                                        np.float32(2.0 ** -70),
                                        np.float32(2.0 ** -140)),
            (np.float32(3e-30), np.float32(7e-20), np.float32(-1e-45))]
    return out


@pytest.mark.parametrize("a, b, c", _halfway_cases())
def test_fma_equals_exact_rounding_at_ties(a, b, c):
    want = _exact_fma(a, b, c)
    assert _bits(_port_fma(a, b, c)) == _bits(want)


def test_fma_ties_defeat_the_float64_sum_rounded_twice():
    """The hand-made ties are decisive: rounding the float64 sum straight
    to float32 (without rounding to odd) gets some of them wrong."""
    wrong = [(a, b, c) for a, b, c in _halfway_cases()
             if _bits(np.float32(np.float64(a) * np.float64(b)
                                 + np.float64(c))) != _bits(
                 _exact_fma(a, b, c))]
    assert len(wrong) >= 6


def test_fma_takes_a_python_float_factor_and_broadcasts():
    rng = np.random.default_rng(0)
    r = np.float32(rng.uniform(1.0, 80.0, size=(4, 64)))
    prev = np.roll(r, 1, axis=-1)
    got = tex._fma(-10.0, torch.as_tensor(r), torch.as_tensor(prev))
    want = [_exact_fma(-10.0, a, b) for a, b in zip(r.ravel(), prev.ravel())]
    np.testing.assert_array_equal(_bits(got.numpy()).ravel(), _bits(want))


def test_sqrt_is_correctly_rounded():
    rng = np.random.default_rng(1)
    v = np.float32(rng.uniform(0.0, 1e4, size=4096))
    got = tex._sqrt(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.sqrt(v)))


# --- the jitted reference -------------------------------------------

def _ring_planes(seed, R=32, P=48):
    """float32 x, y planes of R rings of P points at small azimuth
    steps, ranges 2-60 m with jumps, as a scan's."""
    rng = np.random.default_rng(seed)
    az = np.cumsum(rng.uniform(1e-3, 0.05, size=(R, P)), axis=1)
    az += rng.uniform(-np.pi, np.pi, size=(R, 1))
    r = rng.uniform(2.0, 60.0, size=(R, 1)) * np.exp(
        np.cumsum(rng.normal(scale=0.02, size=(R, P)), axis=1))
    return np.float32(r * np.cos(az)), np.float32(r * np.sin(az))


def _unfused_cos(x, y):
    """The cosine of each lane and the next, one rounding per operation
    (float32 numpy)."""
    xn, yn = np.roll(x, -1, -1), np.roll(y, -1, -1)
    with np.errstate(all="ignore"):
        dot = x * xn + y * yn
        norm = np.sqrt(x * x + y * y) * np.sqrt(xn * xn + yn * yn)
        return np.clip(dot / np.maximum(norm, np.float32(1e-30)), -1, 1)


def _fused_cos(x, y):
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    xn, yn = torch.roll(xt, -1, -1), torch.roll(yt, -1, -1)
    dot = tex._fma(xt, xn, yt * yn)
    norm = tex._xy_norm(xt, yt) * tex._xy_norm(xn, yn)
    return torch.clamp(dot / torch.clamp_min(norm, 1e-30), -1, 1).numpy()


def _knife_edge_thresholds(x, y, count, n=6):
    """Angles whose float32 cosine is the smaller of a lane's fused and
    unfused cosines, where the two differ: there the flag depends on
    the form."""
    cf, cu = _fused_cos(x, y), _unfused_cos(x, y)
    lane = np.arange(x.shape[1])[None, :]
    cand = np.argwhere((cf != cu) & (lane < count[:, None] - 1))
    out = []
    for r, i in cand:
        t = min(cf[r, i], cu[r, i])
        thr = math.acos(float(t))
        if np.float32(math.cos(thr)) == t:
            out.append(thr)
        if len(out) == n:
            break
    return out


def test_neighbor_flags_equal_the_jitted_reference_at_knife_edges():
    x, y = _ring_planes(3)
    count = np.full(x.shape[0], x.shape[1], np.int32)
    count[::5] = 20
    thresholds = _knife_edge_thresholds(x, y, count)
    assert len(thresholds) == 6
    ref = jax.jit(jex.neighbor_flags_xy, static_argnums=3)
    unfused_differs = 0
    for thr in thresholds:
        want = np.asarray(ref(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(count), thr))
        got = tex.neighbor_flags_xy(torch.as_tensor(x), torch.as_tensor(y),
                                    torch.as_tensor(count), thr).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"threshold {thr}")
        has_next = np.arange(x.shape[1])[None, :] < count[:, None] - 1
        unfused = (_unfused_cos(x, y) > np.float32(math.cos(thr))) & has_next
        unfused_differs += int((unfused != want).any())
    assert unfused_differs == len(thresholds)


@pytest.mark.parametrize("padding", [2, 5])
def test_curvature_equals_the_jitted_reference(padding):
    x, y = _ring_planes(4, R=64, P=256)
    rng = np.float32(np.hypot(np.float64(x), np.float64(y)))
    count = np.full(rng.shape[0], rng.shape[1], np.int32)
    count[1::7] = 200
    want = np.asarray(jax.jit(jex.curvature_kernel, static_argnums=2)(
        jnp.asarray(rng), jnp.asarray(count), padding))
    assert want.dtype == np.float32
    got = tex.curvature_kernel(torch.as_tensor(rng), torch.as_tensor(count),
                               padding).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # The unfused form (one rounding per operation) misses bits here.
    acc = np.float32(-2.0 * padding) * rng
    for k in range(1, padding + 1):
        acc = acc + np.roll(rng, k, -1) + np.roll(rng, -k, -1)
    lane = np.arange(rng.shape[1])[None, :]
    interior = (lane >= padding) & (lane < count[:, None] - padding)
    unfused = np.where(interior, acc * acc, np.float32(0))
    if padding == 5:
        assert (_bits(unfused) != _bits(want)).sum() > 0
