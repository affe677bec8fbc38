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
  misses);
- the kNN fits (ROADMAP §C19, ``core/_xla_f32.py``): the squared
  distance at pairs that tie only unfused, the query points, the
  neighbourhood sums, ``solve3x3_sym`` inside the plane fit and the
  principal axis, each against the jitted JAX function bit for bit;
  ``HostLocalizer._fit`` against the JAX one on vlp16/street's first
  round, and a stepping harness that drives both ``HostLocalizer``s over
  the 10 vlp16 priors of the full-width record, round by round and step
  by step. Float32 ``arccos`` / ``cos`` are glibc's, as XLA:CPU calls
  them, since ROADMAP §C20 (``tests/test_torch_drive.py`` pins them).
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


def _point_ulps(got, want) -> np.ndarray:
    """|got - want| of points [..., 3] in ulps of each point's largest
    coordinate of ``want`` (a unit vector's ulp-sized change moves a
    small coordinate of mean -/+ axis by many of its own ulps)."""
    want = np.asarray(want, np.float32)
    scale = np.spacing(np.abs(want).max(axis=-1, keepdims=True))
    return np.abs(np.float64(got) - want) / scale


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


# --- the kNN fits (ROADMAP §C19) -------------------------------------
#
# The port's float32 kNN fits compute XLA:CPU's contracted forms
# (``core/_xla_f32.py``). Each form below is pinned against a jitted JAX
# function whose program computes it as the localizer's ``_fit`` does
# (a standalone ``jax.jit(solve3x3_sym)`` contracts the determinant
# otherwise: the solve is pinned through ``jax.jit(fit_plane)``), on
# inputs where the unfused form gives other bits.

def _neighbourhoods(seed, q=4096, k=15, spread=0.3):
    """float32 neighbourhoods [q, k, 3] of sigma ``spread`` around centres
    within +-60 m, and a valid mask with some lanes off."""
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-60.0, 60.0, size=(q, 1, 3))
    pts = np.float32(centre + rng.normal(0.0, spread, size=(q, k, 3)))
    valid = rng.uniform(size=(q, k)) < 0.9
    return np.where(valid[..., None], pts, 0).astype(np.float32), valid


def _swapped_pairs(seed, q=512, pairs=8):
    """Queries on integer points within +-60 m, each with ``pairs``
    candidate pairs at offsets (x, y, z) and (y, x, z), x and y on a
    2^-17 grid so that every offset is exact: each pair ties under the
    unfused ``(dx*dx + dy*dy) + dz*dz`` and may not under the reference's
    ``fma(dz, dz, fma(dy, dy, dx*dx))``. Returns (queries [q, 3],
    candidates [q, 2 * pairs, 3])."""
    rng = np.random.default_rng(seed)
    qs = np.float32(rng.integers(-60, 61, size=(q, 3)))
    d = rng.integers(-2 ** 17, 2 ** 17, size=(q, pairs, 3)) * 2.0 ** -17
    swapped = d[..., [1, 0, 2]]
    off = np.stack([d, swapped], axis=2).reshape(q, 2 * pairs, 3)
    cand = np.float32(qs[:, None, :] + off)
    assert (np.float64(cand) - qs[:, None, :] == off).all()
    return qs, cand


def test_knn_order_equals_the_jitted_reference_at_swapped_ties():
    """The squared distance is ``fma(dz, dz, fma(dy, dy, dx*dx))``: the
    neighbours come back in the reference's order where the unfused sum
    ties a pair and the fused one does not."""
    from lidar_feature_extraction_tpu.ops import voxel_grid as jvg
    from lidar_feature_extraction_tpu_torch.ops import voxel_grid as tvg

    qs, cand = _swapped_pairs(5)
    ok = np.ones(cand.shape[:2], bool)
    ok[::7, 3] = False
    k = 15
    want = jax.jit(jvg.topk_from_candidates, static_argnums=3)(
        jnp.asarray(cand), jnp.asarray(ok), jnp.asarray(qs), k)
    got = tvg.topk_from_candidates(torch.as_tensor(cand),
                                   torch.as_tensor(ok),
                                   torch.as_tensor(qs), k)
    for name, w, g in zip(("nbrs", "sq", "valid"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    # The unfused distances order some pairs the other way.
    d = torch.as_tensor(cand) - torch.as_tensor(qs)[:, None, :]
    sq = torch.where(torch.as_tensor(ok), torch.sum(d * d, dim=-1),
                     float("inf"))
    order = torch.sort(sq, dim=-1, stable=True).indices[:, :k]
    unfused = np.take_along_axis(cand, order.numpy()[..., None], axis=1)
    reordered = (unfused != np.asarray(want[0])).any(axis=(1, 2))
    assert reordered.sum() >= 50


def test_query_points_equal_the_jitted_reference():
    """``Pose.apply_each_fma`` equals ``jax.jit(Pose.apply)`` bit for bit
    (both cross products ``fma(a_i, b_j, -(a_j*b_i))``, then
    ``p + 2 fma(w, uv, uuv)``); ``apply_each`` rounds each operation and
    differs on many coordinates."""
    from lidar_feature_extraction_tpu.core.pose import Pose as JPose
    from lidar_feature_extraction_tpu_torch.core.pose import Pose

    rng = np.random.default_rng(6)
    pts = np.float32(rng.uniform(-60.0, 60.0, size=(50000, 3)))
    q = rng.normal(size=4)
    q = np.float32(q / np.linalg.norm(q))
    t = np.float32([0.3, -0.2, 0.05])
    want = np.asarray(jax.jit(lambda q, t, p: JPose(q, t).apply(p))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(pts)))
    pose = Pose(torch.as_tensor(q), torch.as_tensor(t))
    got = pose.apply_each_fma(torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    plain = pose.apply_each(torch.as_tensor(pts)).numpy()
    assert (_bits(plain) != _bits(want)).sum() > 1000


def test_fit_reductions_equal_the_jitted_reference():
    """``masked_mean_and_cov`` and ``fit_plane`` (sums in neighbour order,
    the normal equations and the covariance as ``fma`` chains, and
    ``solve3x3_sym``) equal the jitted JAX functions bit for bit; torch's
    own reductions differ in most fits."""
    from lidar_feature_extraction_tpu.ops import residuals as jres
    from lidar_feature_extraction_tpu_torch.ops import residuals as tres

    for k in (5, 15):
        pts, valid = _neighbourhoods(7 + k, k=k)
        jp, jv = jnp.asarray(pts), jnp.asarray(valid)
        tp, tv = torch.as_tensor(pts), torch.as_tensor(valid)
        want_mean, want_cov = jax.jit(jres.masked_mean_and_cov)(jp, jv)
        mean, cov = tres.masked_mean_and_cov(tp, tv)
        np.testing.assert_array_equal(_bits(mean.numpy()),
                                      _bits(want_mean))
        np.testing.assert_array_equal(_bits(cov.numpy()), _bits(want_cov))
        want_w = np.asarray(jax.jit(jres.fit_plane)(jp, jv))
        np.testing.assert_array_equal(
            _bits(tres.fit_plane(tp, tv).numpy()), _bits(want_w))
        w = tv.to(tp.dtype)[..., None]
        unfused = torch.einsum("...ki,...kj->...ij", tp * w, tp)
        fused = torch.as_tensor(np.asarray(jax.jit(
            lambda p, v: jnp.einsum("...ki,...kj->...ij",
                                    p * v[..., None], p))(jp, jv)))
        assert (unfused != fused).any(dim=(-2, -1)).float().mean() > 0.2


def test_solve3x3_determinant_order_is_decisive():
    """In the plane fit's program XLA computes each component of the
    solution in its own loop, and LLVM fuses x1's determinant as
    ``fma(a02, c02, fma(a01, c01, a00*c00))``, x0's and x2's as
    ``fma(a02, c02, fma(a00, c00, a01*c01))``: with x0's order x1 misses
    bits of the jitted ``fit_plane``, with its own it has none."""
    from lidar_feature_extraction_tpu.ops import residuals as jres
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
    from lidar_feature_extraction_tpu_torch.ops import smallalg

    pts, valid = _neighbourhoods(8)
    want = np.asarray(jax.jit(jres.fit_plane)(jnp.asarray(pts),
                                              jnp.asarray(valid)))
    tp, tv = torch.as_tensor(pts), torch.as_tensor(valid)
    xw = tp * tv.to(tp.dtype)[..., None]
    a = xf.gram(xw, tp) + 1e-9 * torch.eye(3)
    b = -xf.sum_in_order(xw, dim=-2)
    got = smallalg.solve3x3_sym(a, b).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    a00, a01, a02 = a[:, 0, 0], a[:, 0, 1], a[:, 0, 2]
    a11, a12, a22 = a[:, 1, 1], a[:, 1, 2], a[:, 2, 2]
    c00, c01 = xf.fms(a11, a22, a12, a12), xf.fms(a02, a12, a01, a22)
    c02, c11 = xf.fms(a01, a12, a02, a11), xf.fms(a00, a22, a02, a02)
    c12 = xf.fms(a01, a02, a00, a12)
    det0 = xf.fma(a02, c02, xf.fma(a00, c00, a01 * c01))
    num1 = xf.fma(c12, b[:, 2], xf.fma(c11, b[:, 1], c01 * b[:, 0]))
    x1_with_x0_det = (num1 * (1.0 / det0)).numpy()
    assert (_bits(x1_with_x0_det) != _bits(want[:, 1])).sum() > 100


def test_principal_axis_equals_the_jitted_reference():
    """``principal_axis3x3`` equals the largest eigenvector of the jitted
    JAX ``eigh3x3`` bit for bit, with its own float32 ``arccos`` and
    ``cos`` (glibc's ``atan2f`` and ``cosf``, as XLA:CPU calls them,
    ROADMAP §C20; rounded from float64 before, 1.55% of these 20,000
    axes differed); so does ``eigh3x3``'s, which computes the
    reference's float32 forms since §C20 (before, over 20% of its axes
    differed)."""
    from lidar_feature_extraction_tpu.ops import eig3 as jeig
    from lidar_feature_extraction_tpu.ops import residuals as jres
    from lidar_feature_extraction_tpu_torch.ops import eig3 as teig

    pts, valid = _neighbourhoods(9, q=20000)
    _, cov = jax.jit(jres.masked_mean_and_cov)(jnp.asarray(pts),
                                               jnp.asarray(valid))
    want = np.asarray(jax.jit(lambda c: jeig.eigh3x3(c)[1][..., :, 2])(cov))
    cov = torch.as_tensor(np.asarray(cov))
    own = teig.principal_axis3x3(cov).numpy()
    np.testing.assert_array_equal(_bits(own), _bits(want))
    full = teig.eigh3x3(cov)[1][..., :, 2].numpy()
    np.testing.assert_array_equal(_bits(full), _bits(want))


VLP16 = ("vlp16/bench", "vlp16/street")


@pytest.fixture(scope="module")
def vlp16_hosts():
    """Per vlp16 case of the full-width record: the JAX and the port's
    ``HostLocalizer`` over their own maps of the record's map clouds, and
    the record's features for each (the port's equal them bit for bit),
    surfaces downsampled by each side."""
    import reference_cases as rc
    import torch_reference_record as trr
    from lidar_feature_extraction_tpu.pipeline import localization as jloc
    from lidar_feature_extraction_tpu_torch.pipeline import (
        launch, localization as tloc)

    arrays = rc.load()[0]
    jcfg, tcfg = trr.ref_config("vlp16"), launch.load_config("vlp16")
    ex = jcfg.extraction
    names = ("edge_xyz", "edge_valid", "surface_xyz", "surface_valid")
    out = {}
    for case in VLP16:
        rec = rc.case_arrays(arrays, case)
        xyz, rng = rc.scene_scan(rc.split(case)[1], ex.n_rings,
                                 ex.max_points_per_ring)
        edge, surf = rc.map_clouds(xyz, rec["labels"], rng, jcfg)
        jh = jloc.HostLocalizer(trr.ref_maps(edge, surf, jcfg), jcfg)
        th = tloc.HostLocalizer(
            rc.port_maps(case, rec["labels"], tcfg, "cpu"), tcfg)
        jf = tuple(jnp.asarray(rec[n]) for n in names)
        tf = rc.ref_features_tensors(rec, "cpu")
        out[case] = (jh, th, jf, tf, rec)
    return out


def _pose_pair(i):
    import reference_cases as rc
    from lidar_feature_extraction_tpu.core.pose import Pose as JPose
    from lidar_feature_extraction_tpu_torch.core.pose import Pose

    qs, ts = rc.priors()
    return (JPose(jnp.asarray(qs[i]), jnp.asarray(ts[i])),
            Pose(torch.as_tensor(qs[i]), torch.as_tensor(ts[i])))


def test_host_fit_equals_the_reference_on_vlp16_street(vlp16_hosts):
    """The port's ``HostLocalizer._fit`` against the JAX one on the first
    round of vlp16/street from the record's prior 2 (numpy seed 8, where
    the port once ended CONVERGED after 4 iterations against the
    record's SCALE_INCREASED after 2; 12,288 coordinates each side): the
    downsampled surfaces, the surface fits (w, u, |w|), both valid masks
    and the edge lines (p1, p2, Hat(p2 - p1)) bit for bit. (Before
    ROADMAP §C20 the port's float32 ``arccos`` and ``cos`` were rounded
    from float64, and the edge lines were within 4 ulps on at most 0.5%
    of the coordinates.)"""
    jh, th, (je, jev, js, jsv), (te, tev, ts, tsv), _ = \
        vlp16_hosts["vlp16/street"]
    jpose, pose = _pose_pair(2)
    jds, tds = jh._downsample(js, jsv), th._downsample(ts, tsv)
    for w, g in zip(jds, tds):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jeg, jsg = jh._fit(jh.maps, je, jev, *jds, jpose)
    teg, tsg = th._fit(te, tev, *tds, pose)
    for name in ("w", "u", "wnorm", "valid"):
        np.testing.assert_array_equal(getattr(tsg, name).numpy(),
                                      np.asarray(getattr(jsg, name)),
                                      err_msg=f"surface {name}")
    np.testing.assert_array_equal(teg.valid.numpy(), np.asarray(jeg.valid))
    for name in ("p1", "p2", "khat"):
        np.testing.assert_array_equal(
            _bits(getattr(teg, name).numpy()),
            _bits(np.asarray(getattr(jeg, name))), err_msg=f"edge {name}")


def _recorded(fn, log):
    def wrapped(*args):
        out = fn(*args)
        log.append(out)
        return out
    return wrapped


@pytest.mark.parametrize("prior", range(5))
@pytest.mark.parametrize("case", VLP16)
def test_host_localizers_step_alike(vlp16_hosts, case, prior,
                                    monkeypatch):
    """The stepping harness: both packages' ``HostLocalizer.register``
    from one of the record's priors, every search round's fits and every
    Gauss-Newton step recorded on both sides. The rounds and steps come
    in equal numbers; in every round the surface fits and the valid
    masks are bit-equal (a fit depends on the pose only through the kNN
    selection, so a near-tie that picked other neighbours would show
    here first), the edge lines within 4 ulps of each point's largest
    coordinate (the port's ``arccos`` and ``cos``); every step counts the same correspondences and
    its error and MAD scale, which decide the aborts, agree to 1e-5; both
    end with the record's status and iterations, the pose within
    ``T_ATOL``."""
    import reference_cases as rc

    jh, th, jf, tf, rec = vlp16_hosts[case]
    log = {k: [] for k in ("jfit", "tfit", "jstep", "tstep")}
    monkeypatch.setattr(jh, "_fit", _recorded(jh._fit, log["jfit"]))
    monkeypatch.setattr(th, "_fit", _recorded(th._fit, log["tfit"]))
    monkeypatch.setattr(jh, "_light_step",
                        _recorded(jh._light_step, log["jstep"]))
    monkeypatch.setattr(th, "_light_step",
                        _recorded(th._light_step, log["tstep"]))
    jpose, pose = _pose_pair(prior)
    jr, tr = jh.register(*jf, jpose), th.register(*tf, pose)

    def table(steps):
        return [(int(s.n_valid), float(s.error), float(s.scale),
                 float(s.dq_norm), float(s.dt_norm)) for s in steps]

    steps = f"JAX {table(log['jstep'])}, port {table(log['tstep'])}"
    assert len(log["tfit"]) == len(log["jfit"]), steps
    for r, ((jeg, jsg), (teg, tsg)) in enumerate(zip(log["jfit"],
                                                     log["tfit"])):
        for name in ("w", "u", "wnorm", "valid"):
            np.testing.assert_array_equal(
                getattr(tsg, name).numpy(), np.asarray(getattr(jsg, name)),
                err_msg=f"round {r}: surface {name}")
        np.testing.assert_array_equal(teg.valid.numpy(),
                                      np.asarray(jeg.valid),
                                      err_msg=f"round {r}: edge valid")
        for name in ("p1", "p2"):
            ulps = _point_ulps(getattr(teg, name).numpy(),
                               getattr(jeg, name))
            assert ulps.max() <= 4, f"round {r}: edge {name}"
    assert len(log["tstep"]) == len(log["jstep"]), steps
    for i, (j, t) in enumerate(zip(table(log["jstep"]),
                                   table(log["tstep"]))):
        assert t[0] == j[0], f"step {i}: n_valid; {steps}"
        np.testing.assert_allclose(t[1:3], j[1:3], rtol=1e-5,
                                   err_msg=f"step {i}: error, scale")
    for name, r in (("JAX", jr), ("port", tr)):
        assert (int(r.status), int(r.iterations)) == (
            rec["localize_status"][prior],
            rec["localize_iterations"][prior]), name
    np.testing.assert_allclose(tr.pose.t.numpy(), rec["localize_t"][prior],
                               rtol=0, atol=rc.T_ATOL)
    np.testing.assert_allclose(tr.pose.q.numpy(), rec["localize_q"][prior],
                               rtol=0, atol=rc.Q_ATOL)
