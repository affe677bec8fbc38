"""Port parity of the host-stepped localizer and the last helpers:
``HostLocalizer`` (``register`` and ``localize`` on both map types),
``gn_iteration`` / ``run_gauss_newton_host``, the exact-sort robust
statistics, ``right_multiplication_matrix``, ``xy_range``,
``neighbor_flags``, ``process_noise`` and ``io/native_io.py``.

Tolerances:
- ``HostLocalizer``: status and iteration count equal, error and scale
  within rtol 1e-5, pose within 1e-4 (translation, m; quaternion
  components). The kNN registrations (``FeatureMaps``) run with the maps
  and the prior in float64, as in test_torch_registration: the
  reference's float32 plane fit is ill-conditioned away from the origin,
  so float32 runs of two implementations differ by up to 1e-4 m and 5e-4
  in the error on test_host_localizer's scene, where float64 runs agree
  to 1e-13. The ``GeometryMaps`` runs are float64 too: in float32 an ulp
  of the pose moves the MAD scale of a converged street scan by 1e-4;
- ``gn_iteration``: rtol 1e-5 in float64; ``run_gauss_newton_host``
  on scripted steps: exact (it only moves values);
- statistics, quaternion matrices, ranges, process noise: rtol 1e-6;
  neighbour flags and prefetched files: exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_pipeline import (  # noqa: E402
    make_world, pad_to, sample_scan_features, small_cfg)
from torch_parity import np32, port_config, t32, to_np  # noqa: E402
from lidar_feature_extraction_tpu.config import (  # noqa: E402
    kitti_hdl64 as j_kitti)
from lidar_feature_extraction_tpu.core import quaternion as jq  # noqa: E402
from lidar_feature_extraction_tpu.core import scan as jscan  # noqa: E402
from lidar_feature_extraction_tpu.core import stats as jstats  # noqa: E402
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.fusion import ekf as jekf  # noqa: E402
from lidar_feature_extraction_tpu.io import native_io as jio  # noqa: E402
from lidar_feature_extraction_tpu.ops import extraction as jex  # noqa: E402
from lidar_feature_extraction_tpu.ops import gauss_newton as jgn  # noqa: E402
from lidar_feature_extraction_tpu.ops import residuals as jres  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    localization as jloc)
from lidar_feature_extraction_tpu_torch.config import (  # noqa: E402
    kitti_hdl64 as t_kitti)
from lidar_feature_extraction_tpu_torch.core import (  # noqa: E402
    quaternion as tq, scan as tscan, stats as tstats)
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.fusion import ekf as tekf  # noqa: E402
from lidar_feature_extraction_tpu_torch.interop import (  # noqa: E402
    range_image_from_numpy)
from lidar_feature_extraction_tpu_torch.io import native_io as tio  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import extraction as tex  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import gauss_newton as tgn  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import residuals as tres  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    localization as tloc)
from lidar_feature_extraction_tpu_torch.utils.synthetic import (  # noqa: E402
    street_scan, street_world, to_world)

# The float64 references need x64 (the whole suite runs with it on).
jax.config.update("jax_enable_x64", True)

T_ATOL = Q_ATOL = 1e-4
ERR_RTOL = 1e-5
RTOL = 1e-6


def _pose_pair(q, t, dtype):
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (JPose(jnp.asarray(q, jd), jnp.asarray(t, jd)),
            Pose(torch.as_tensor(np.array(q), dtype=dtype),
                 torch.as_tensor(np.array(t), dtype=dtype)))


def _assert_same_result(got, want):
    assert int(got.status) == int(want.status)
    assert int(got.iterations) == int(want.iterations)
    for f in ("error", "scale"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=ERR_RTOL)
    np.testing.assert_allclose(to_np(got.pose.t), np.asarray(want.pose.t),
                               rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(to_np(got.pose.q), np.asarray(want.pose.q),
                               rtol=0, atol=Q_ATOL)
    assert got.block_errors is None and want.block_errors is None


# --- register on test_host_localizer's scene ---

# The priors of the scene (true pose yaw 0.12 rad at t = (0.8, -0.4,
# 0.1), prior yaw 0.08 rad): the test's own, two that end at
# ERROR_INCREASED (where localize_scan's loop control reports another
# error) and one that takes a second search round.
PRIORS_T = {"test": (0.5, -0.2, 0.0), "near": (0.2, -0.1, 0.0),
            "origin": (0.0, 0.0, 0.0), "far": (1.2, -0.8, 0.1)}


@pytest.fixture(scope="module")
def small_scene():
    """The scene's features, and per refit mode the maps and the JAX
    HostLocalizer's result at every prior (computed once)."""
    rng = np.random.default_rng(0)
    cfg = small_cfg()
    we, ws = make_world(rng)
    true = JPose(q=jq.exp_so3(jnp.asarray([0.0, 0.0, 0.12], jnp.float32)),
                 t=jnp.asarray([0.8, -0.4, 0.1], jnp.float32))
    e, s = sample_scan_features(we, ws, true, rng)
    jf = (*pad_to(e, cfg.extraction.max_edges),
          *pad_to(s, cfg.extraction.max_surfaces))
    tf = tuple(torch.as_tensor(np.array(a)) for a in jf)
    q0 = np.asarray(jq.exp_so3(jnp.asarray([0.0, 0.0, 0.08], jnp.float32)),
                    np.float64)
    out = dict(jf=jf, tf=tf, q0=q0, cfg=cfg)
    # The maps do not depend on the refit mode.
    jm = jloc.build_feature_maps(
        jnp.asarray(we, jnp.float64), jnp.ones(len(we), bool),
        jnp.asarray(ws, jnp.float64), jnp.ones(len(ws), bool), cfg)
    tm = tloc.build_feature_maps(
        torch.as_tensor(we), torch.ones(len(we), dtype=torch.bool),
        torch.as_tensor(ws), torch.ones(len(ws), dtype=torch.bool),
        port_config(cfg))
    for refit in (False, True):
        c = dataclasses.replace(cfg, registration=dataclasses.replace(
            cfg.registration, refit_per_iteration=refit))
        tc = port_config(c)
        host = jloc.HostLocalizer(jm, c)
        want = {name: host.register(*jf, _pose_pair(q0, t,
                                                      torch.float64)[0])
                for name, t in PRIORS_T.items()}
        out[refit] = dict(tm=tm, tcfg=tc, want=want, jhost=host)
    return out


@pytest.mark.parametrize("refit", [False, True], ids=["frozen", "refit"])
@pytest.mark.parametrize("prior", sorted(PRIORS_T))
def test_register_matches_reference_host_localizer(small_scene, refit,
                                                   prior):
    """The port's HostLocalizer.register is the JAX HostLocalizer's
    (status, iterations, the aborting iteration's error and scale, pose),
    also where localize_scan's loop ends elsewhere."""
    sc = small_scene[refit]
    tp = _pose_pair(small_scene["q0"], PRIORS_T[prior], torch.float64)[1]
    got = tloc.HostLocalizer(sc["tm"], sc["tcfg"]).register(
        *small_scene["tf"], tp)
    want = sc["want"][prior]
    _assert_same_result(got, want)
    np.testing.assert_allclose(to_np(got.hessian), np.asarray(want.hessian),
                               rtol=ERR_RTOL, atol=1e-8 * float(np.abs(
                                   np.asarray(want.hessian)).max()))


def test_register_empty_scan_keeps_the_prior(small_scene):
    cfg = small_scene[False]
    n_e = small_scene["cfg"].extraction.max_edges
    n_s = small_scene["cfg"].extraction.max_surfaces
    jp, tp = _pose_pair([1.0, 0, 0, 0], [0.1, 0.2, 0.3], torch.float64)
    got = tloc.HostLocalizer(cfg["tm"], cfg["tcfg"]).register(
        torch.zeros(n_e, 3), torch.zeros(n_e, dtype=torch.bool),
        torch.zeros(n_s, 3), torch.zeros(n_s, dtype=torch.bool), tp)
    assert int(got.status) == tgn.EMPTY_INPUT
    assert int(got.iterations) == 1
    assert torch.equal(got.pose.t, tp.t) and torch.equal(got.pose.q, tp.q)
    # The reference's JAX HostLocalizer on the same empty scan.
    want = cfg["jhost"].register(
        jnp.zeros((n_e, 3), jnp.float32), jnp.zeros(n_e, bool),
        jnp.zeros((n_s, 3), jnp.float32), jnp.zeros(n_s, bool), jp)
    assert int(want.status) == tgn.EMPTY_INPUT
    assert float(got.error) == float(want.error) == 0.0
    assert np.isnan(float(got.scale)) and np.isnan(float(want.scale))


# --- gn_iteration and run_gauss_newton_host ---

def _blocks(rng, n=(40, 60), dims=(3, 1)):
    """Random residual blocks (float64) with a few invalid rows."""
    out = []
    for nb, d in zip(n, dims):
        jac = rng.normal(size=(nb, d, 7))
        res = rng.normal(scale=0.1, size=(nb, d))
        res[:3] *= 30.0                      # outliers past the Huber elbow
        valid = rng.random(nb) < 0.85
        out.append((jac, res, valid))
    return out


def test_gn_iteration_matches_reference():
    rng = np.random.default_rng(3)
    blocks = _blocks(rng)
    q = jq.exp_so3(jnp.asarray([0.1, -0.2, 0.3]))
    jp, tp = _pose_pair(np.asarray(q), [0.5, -1.0, 0.2], torch.float64)
    want = jax.jit(lambda bl, p: jgn.gn_iteration(jgn.make_problem([
        jres.ResidualBlock(*b) for b in bl]), p, 1.345, 0.1))(
            [tuple(jnp.asarray(a) for a in b) for b in blocks], jp)
    got = tgn.gn_iteration(tgn.make_problem([tres.ResidualBlock(
        *(torch.as_tensor(a) for a in b)) for b in blocks]), tp, 1.345, 0.1)
    assert int(got.n_valid) == int(want.n_valid)
    assert got.n_valid.dtype == torch.int32
    for f in ("error", "scale", "dq_norm", "dt_norm", "hessian"):
        np.testing.assert_allclose(to_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)),
                                   rtol=ERR_RTOL, err_msg=f)
    np.testing.assert_allclose(to_np(got.pose.q), np.asarray(want.pose.q),
                               rtol=ERR_RTOL)
    np.testing.assert_allclose(to_np(got.pose.t), np.asarray(want.pose.t),
                               rtol=ERR_RTOL)


def test_gn_iteration_is_the_fused_loops_step():
    """One iteration of run_gauss_newton moves the pose to exactly
    gn_iteration's (the same device ops)."""
    rng = np.random.default_rng(4)
    blocks = [tres.ResidualBlock(*(torch.as_tensor(a) for a in b))
              for b in _blocks(rng)]
    blocks = [b._replace(jacobian=b.jacobian.float(),
                         residual=b.residual.float()) for b in blocks]
    tp = Pose(tq.exp_so3(torch.tensor([0.1, -0.2, 0.3])),
              torch.tensor([0.5, -1.0, 0.2]))
    problem = tgn.make_problem(blocks)
    step = tgn.gn_iteration(problem, tp)
    fused = tgn.run_gauss_newton(lambda p: problem, tp, max_iterations=1)
    assert int(fused.status) == tgn.MAX_ITERATIONS
    assert torch.equal(fused.pose.q, step.pose.q)
    assert torch.equal(fused.pose.t, step.pose.t)
    assert torch.equal(fused.hessian, step.hessian)


# Scripted steps: max_iterations, and (n_valid, error, scale, dq_norm,
# dt_norm) per iteration; each step moves t[0] by 1.
_SCRIPTS = {
    "converged": (5, [(5, 4.0, 1.0, 0.1, 0.1), (5, 3.0, 0.9, 1e-4, 1e-4)]),
    "error_up": (5, [(5, 4.0, 1.0, 0.1, 0.1), (5, 4.5, 0.9, 0.1, 0.1)]),
    "scale_up": (5, [(5, 4.0, 1.0, 0.1, 0.1), (5, 3.0, 1.5, 0.1, 0.1)]),
    "empty": (5, [(5, 4.0, 1.0, 0.1, 0.1),
                  (0, 0.0, float("nan"), 0.0, 0.0)]),
    "max_iterations": (3, [(5, 4.0, 1.0, 0.1, 0.1), (5, 4.0, 1.0, 0.1, 0.1),
                           (5, 3.0, 1.0, 0.1, 2e-3)]),
    "no_step": (0, []),
}
# (float32 array, int32 array, GNStep, Pose) of each implementation.
_JAX_SIDE = (lambda v: jnp.asarray(v, jnp.float32),
             lambda v: jnp.asarray(v, jnp.int32), jgn.GNStep, JPose)
_PORT_SIDE = (lambda v: torch.tensor(v, dtype=torch.float32),
              lambda v: torch.tensor(v, dtype=torch.int32), tgn.GNStep, Pose)


def _scripted(steps, side):
    """A step function returning the script's scalars in turn, with a
    Hessian numbered by the step."""
    f32, i32, step_cls, pose_cls = side
    calls = []

    def step_fn(p):
        n, e, s, dq, dt = steps[len(calls)]
        calls.append(p)
        return step_cls(pose=pose_cls(p.q, p.t + f32([1.0, 0.0, 0.0])),
                        error=f32(e), scale=f32(s), n_valid=i32(n),
                        dq_norm=f32(dq), dt_norm=f32(dt),
                        hessian=f32(np.eye(6) * len(calls)))
    return step_fn


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_run_gauss_newton_host_matches_reference(name):
    n_it, steps = _SCRIPTS[name]
    jp, tp = _pose_pair([1.0, 0, 0, 0], [0.0, 0.0, 0.0], torch.float32)
    want = jgn.run_gauss_newton_host(_scripted(steps, _JAX_SIDE), jp, n_it,
                                     1e-3)
    got = tgn.run_gauss_newton_host(_scripted(steps, _PORT_SIDE), tp, n_it,
                                    1e-3)
    assert int(got.status) == int(want.status)
    assert int(got.iterations) == int(want.iterations)
    assert got.status.dtype == got.iterations.dtype == torch.int32
    assert got.error.dtype == got.scale.dtype == torch.float32
    np.testing.assert_array_equal(to_np(got.error), np.asarray(want.error))
    np.testing.assert_array_equal(to_np(got.scale), np.asarray(want.scale))
    np.testing.assert_array_equal(to_np(got.pose.t), np.asarray(want.pose.t))
    assert (got.hessian is None) == (want.hessian is None)
    if want.hessian is not None:
        np.testing.assert_array_equal(to_np(got.hessian),
                                      np.asarray(want.hessian))


# --- localize on the street scene, both map types ---

R, P = 16, 576
# (compact extraction, map kind, fused table kept)
_LOCALIZE = {"compact_geometry": (True, "geometry", True),
             "full_geometry": (False, "geometry", True),
             "full_geometry_unfused": (False, "geometry", False),
             "full_feature_maps": (False, "feature", None)}


@pytest.fixture(scope="module")
def street():
    """The scan at the identity and map clouds from 7 keyframes (the
    port's extraction; test_torch_registration holds it equal to the
    reference's)."""
    rng = np.random.default_rng(1)
    world = street_world(rng)
    cut = lambda c: dataclasses.replace(  # noqa: E731
        c, extraction=dataclasses.replace(c.extraction, n_rings=R,
                                          max_points_per_ring=P))
    jcfg, tcfg = cut(j_kitti()), cut(t_kitti())
    mask, count = np.ones((R, P), bool), np.full(R, P, np.int32)
    edges, surfs, scan0 = [], [], None
    for k in range(7):
        o = (0.0, 0.0) if k == 0 else tuple(rng.uniform(-3, 3, 2) * [1, .3])
        yaw = 0.0 if k == 0 else float(rng.uniform(-0.05, 0.05))
        xyz = street_scan(world, rng, R, P, o, yaw)
        scan0 = xyz if k == 0 else scan0
        f = tex.extract_features(range_image_from_numpy(xyz, mask, count,
                                                        "cpu"),
                                 tcfg.extraction)
        edges.append(to_world(to_np(f.edge_xyz)[to_np(f.edge_valid)], o,
                              yaw))
        surfs.append(to_world(to_np(f.surface_xyz)[to_np(f.surface_valid)],
                              o, yaw))
    return dict(scan=scan0, mask=mask, count=count, jcfg=jcfg, tcfg=tcfg,
                edge=np.concatenate(edges), surf=np.concatenate(surfs),
                cases={})


def _street_case(street, case):
    """The reference's and the port's maps, configs and the reference's
    HostLocalizer of one case, made once per module. Float64 maps and
    priors (see the module docstring)."""
    if case in street["cases"]:
        return street["cases"][case]
    compact, kind, fused = _LOCALIZE[case]
    jcfg, tcfg = (dataclasses.replace(c, compact_extraction=compact)
                  for c in (street["jcfg"], street["tcfg"]))
    e, s = street["edge"], street["surf"]
    build = "build_feature_maps" if kind == "feature" else \
        "build_geometry_maps"
    jm = getattr(jloc, build)(jnp.asarray(e), jnp.ones(len(e), bool),
                              jnp.asarray(s), jnp.ones(len(s), bool), jcfg)
    tm = getattr(tloc, build)(
        torch.as_tensor(e), torch.ones(len(e), dtype=torch.bool),
        torch.as_tensor(s), torch.ones(len(s), dtype=torch.bool), tcfg)
    if fused is False:
        jm, tm = jm._replace(fused=None), tm._replace(fused=None)
    jhost = jloc.HostLocalizer(jm, jcfg)
    if not compact:
        # The full extraction's jitted program is the same in every full
        # case: compile it once.
        jhost._extract = street["cases"].setdefault("extract",
                                                    jhost._extract)
    street["cases"][case] = (tm, tcfg, jhost)
    return street["cases"][case]


def _street_prior(noisy, dtype):
    q, t = np.array([1.0, 0, 0, 0]), np.array([0.3, -0.2, 0.05])
    if noisy:
        d = np.random.default_rng(7).normal(size=4)
        t = t + 0.2 * d[:3] / np.linalg.norm(d[:3])
        yaw = np.radians(1.0) * d[3]
        q = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
    return _pose_pair(q, t, dtype)


@pytest.mark.parametrize("noisy", [False, True], ids=["best", "noisy"])
@pytest.mark.parametrize("case", sorted(_LOCALIZE))
def test_localize_matches_reference_host_localizer(street, case, noisy):
    tm, tcfg, jhost = _street_case(street, case)
    jp, tp = _street_prior(noisy, torch.float64)
    want, jfeats = jhost.localize(jscan.RangeImage(
        *(jnp.asarray(street[k]) for k in ("scan", "mask", "count"))), jp)
    img = range_image_from_numpy(street["scan"], street["mask"],
                                 street["count"], "cpu")
    host = tloc.HostLocalizer(tm, tcfg)
    got, feats = host.localize(img, tp)
    for f in ("edge_xyz", "edge_valid", "surface_xyz", "surface_valid"):
        np.testing.assert_array_equal(to_np(getattr(feats, f)),
                                      np.asarray(getattr(jfeats, f)))
    _assert_same_result(got, want)
    if getattr(tm, "fused", None) is not None:
        # On GeometryMaps the port's two drivers reach the same pose in
        # the same iterations (localize_scan always gathers from the
        # fused table; without one the host steps gather per grid).
        fused, _ = tloc.localize_scan(tm, img, tp, tcfg)
        assert (int(got.status), int(got.iterations)) == (
            int(fused.status), int(fused.iterations))
        assert torch.equal(got.pose.t, fused.pose.t)
        assert torch.equal(got.pose.q, fused.pose.q)


# --- statistics and small helpers ---

def _stat_inputs(case):
    rng = np.random.default_rng(11)
    if case == "odd":
        return np32([5.0, 1.0, 4.0, 2.0, 3.0, 9.0]), np.array(
            [1, 1, 1, 1, 1, 0], bool)
    if case == "even":
        return np32([5.0, 1.0, 4.0, 2.0, 7.0, 9.0]), np.array(
            [1, 1, 1, 1, 0, 0], bool)
    if case == "empty":
        return np32(rng.normal(size=7)), np.zeros(7, bool)
    if case == "random":
        return np32(rng.exponential(size=301)), rng.random(301) < 0.6
    # batched: lanes with odd, even and no valid values
    v = np32(rng.normal(size=(4, 50)))
    m = rng.random((4, 50)) < 0.5
    m[2] = False
    m[3] = np.arange(50) < 10
    return v, m


@pytest.mark.parametrize("name", ["masked_median", "masked_mad",
                                  "masked_scale"])
@pytest.mark.parametrize("case", ["odd", "even", "empty", "random",
                                  "batched"])
def test_exact_median_statistics_match_reference(name, case):
    v, m = _stat_inputs(case)
    fn = getattr(jstats, name)
    if v.ndim == 2:
        fn = jax.vmap(fn)
    want = np32(fn(jnp.asarray(v), jnp.asarray(m)))
    got = to_np(getattr(tstats, name)(t32(v), torch.as_tensor(m)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if case == "even" and name == "masked_median":
        assert float(got) == 3.0          # the mean of the middle two


def test_huber_matches_reference():
    e = np32(np.concatenate([np.random.default_rng(2).exponential(
        scale=3.0, size=512), [0.0, 1.345 ** 2]]))
    want = np32(jstats.huber(jnp.asarray(e), 1.345))
    np.testing.assert_allclose(to_np(tstats.huber(t32(e), 1.345)), want,
                               rtol=RTOL)


def test_right_multiplication_matrix_matches_reference():
    rng = np.random.default_rng(5)
    q = np32(rng.normal(size=(16, 4)))
    want = np32(jq.right_multiplication_matrix(jnp.asarray(q)))
    got = to_np(tq.right_multiplication_matrix(t32(q)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # R(q) vec(l) = vec(l * q)
    lq = to_np(tq.quat_multiply(t32(q[::-1].copy()), t32(q)))
    np.testing.assert_allclose(np.einsum("nij,nj->ni", got, q[::-1]), lq,
                               rtol=1e-5, atol=1e-6)


def test_xy_range_and_neighbor_flags_match_reference():
    rng = np.random.default_rng(6)
    xyz = np32(rng.normal(scale=10.0, size=(4, 32, 3)))
    count = np.array([32, 20, 1, 0], np.int32)
    jimg = jscan.RangeImage(jnp.asarray(xyz), jnp.ones((4, 32), bool),
                            jnp.asarray(count))
    timg = range_image_from_numpy(xyz, np.ones((4, 32), bool), count, "cpu")
    np.testing.assert_allclose(to_np(tscan.xy_range(timg)),
                               np32(jscan.xy_range(jimg)), rtol=RTOL)
    np.testing.assert_array_equal(
        to_np(tex.neighbor_flags(t32(xyz), torch.as_tensor(count), 0.3)),
        np.asarray(jex.neighbor_flags(jnp.asarray(xyz), jnp.asarray(count),
                                      0.3)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_process_noise_matches_reference(dtype):
    v = [0.01, 1e-4, 0.25, 0.04]
    want = np.asarray(jekf.process_noise(v, dtype=getattr(jnp, dtype)))
    got = tekf.process_noise(v, dtype=getattr(torch, dtype), device="cpu")
    assert got.dtype == getattr(torch, dtype)
    assert str(want.dtype) == dtype
    np.testing.assert_allclose(to_np(got), want, rtol=RTOL)


# --- native_io ---

@pytest.fixture()
def scan_files(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(12):
        p = tmp_path / f"{i:06d}.bin"
        np32(rng.normal(size=(50 + 13 * i) * 4)).tofile(p)
        paths.append(str(p))
    return paths


def test_read_f32_matches_reference(scan_files, tmp_path):
    for p in scan_files[:3]:
        got = tio.read_f32(p)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jio.read_f32(p))
    missing = str(tmp_path / "nope.bin")
    for mod in (jio, tio):
        with pytest.raises(FileNotFoundError):
            mod.read_f32(missing)


def test_scan_prefetcher_matches_reference_and_bounds_lookahead(scan_files):
    """Every get returns the file's contents, as the reference's does, and
    no read is started past ``lookahead`` files after the furthest index
    asked for (the reference's bound, on the same counter when its shim
    is built)."""
    lookahead = 3
    want = jio.ScanPrefetcher(scan_files, n_threads=2, lookahead=lookahead)
    got = tio.ScanPrefetcher(scan_files, n_threads=2, lookahead=lookahead)
    try:
        assert got._next_submit == lookahead + 1
        furthest = 0
        for i in (0, 1, 2, 7, 5, 11):    # in order, a skip, a step back
            np.testing.assert_array_equal(got.get(i), want.get(i))
            furthest = max(furthest, i)
            assert got._next_submit == min(len(scan_files),
                                           furthest + lookahead + 1)
            if want._p is not None:
                assert want._next_submit == got._next_submit
        # A scan taken before is read again.
        np.testing.assert_array_equal(got.get(5), jio.read_f32(scan_files[5]))
    finally:
        want.close()
        got.close()
        got.close()   # idempotent


def test_scan_prefetcher_failed_read_names_the_file(scan_files, tmp_path):
    paths = scan_files[:2] + [str(tmp_path / "gone.bin")]
    got = tio.ScanPrefetcher(paths, n_threads=1, lookahead=1)
    want = jio.ScanPrefetcher(paths, n_threads=1, lookahead=1)
    try:
        np.testing.assert_array_equal(got.get(0), want.get(0))
        for pf in (want, got):
            with pytest.raises(IOError, match="gone.bin"):
                pf.get(2)
    finally:
        want.close()
        got.close()
