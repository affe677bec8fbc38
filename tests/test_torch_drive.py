"""The port's closed loop held to the JAX package's, scan by scan, over
eval_ate.py's 20-scan drive at full width (ROADMAP §C20, §C21).

The reference is the committed drive record,
``tests/data/torch_reference_drive.npz`` (``reference_cases.py`` reads it,
``tests/torch_reference_record.py --drive --write`` writes it): what the
JAX package's ``FusedLocalizationPipeline`` computes on the CPU under
``kitti_hdl64()`` (production) and its faithful variant. Checked here:

- the record's inputs are the port's worldsim draws (a digest);
- at the recorded prior of each drive (production scan 4, faithful scan
  10) the first Gauss-Newton problem's Jacobian and residual rows
  (digests), per-correspondence errors, valid mask and MAD scale, the
  Huber weights and the normal equations D, A and b equal the
  reference's bit for bit;
- the faithful drive's 20 scans and the production drive's first 8: the
  record's status and iterations, measured and fused positions within
  ``DRIVE_T_ATOL`` (1e-6 m); the faithful ATE within 1e-6 m of the
  record's;
- the time-delay EKF's ``predict``, ``update_twist`` and ``update_pose``
  fed the record's measurements equal the jitted reference's bit for bit
  after every call;
- the port's GeometryMaps equal the JAX package's jitted map build bit
  for bit;
- the knife-edge forms: glibc's float32 ``acos`` / ``cos`` / ``sin`` /
  ``atan2`` as XLA:CPU calls them, the residual rows' dot products,
  cross products and rotated points, against jitted JAX functions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import reference_cases as rc  # noqa: E402
from lidar_feature_extraction_tpu import config as jconfig  # noqa: E402
from lidar_feature_extraction_tpu.fusion import ekf as jekf  # noqa: E402
from lidar_feature_extraction_tpu.fusion import kalman as jkal  # noqa: E402
from lidar_feature_extraction_tpu.core import quaternion as jquat  # noqa: E402
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    localization as jloc)
from lidar_feature_extraction_tpu_torch.config import (  # noqa: E402
    EkfConfig, kitti_hdl64)
from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd  # noqa: E402
from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf  # noqa: E402
from lidar_feature_extraction_tpu_torch.core import stats  # noqa: E402
from lidar_feature_extraction_tpu_torch.fusion import ekf  # noqa: E402
from lidar_feature_extraction_tpu_torch.fusion import kalman  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    localization as tloc)
from lidar_feature_extraction_tpu_torch.pipeline.replay import (  # noqa: E402
    scan_range_image)
from lidar_feature_extraction_tpu_torch.utils.evaluation import (  # noqa: E402
    ate_rmse)

jax.config.update("jax_enable_x64", True)   # as in-suite

# The scans of each drive held to the record: the faithful drive's all 20
# since ROADMAP §C21; the production drive's first 8 (its 20 are held on
# the card by chip_smoke.py's DRIVE_HELD_SCANS and run on the CPU by
# ``python3 reference_cases.py --device cpu``; 8 keep the suite's time).
HELD_SCANS = {"production": 8, "faithful": 20}
# The drive's ATE against the record's (metres).
ATE_ATOL = 1e-6


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.fixture(scope="module")
def drive():
    """The drive's inputs (the port's draws), the record, and the port's
    maps of each configuration on the CPU."""
    edges, surfs, scans, gt, twists, _, _ = rc.drive_inputs()
    arrays, manifest = rc.load_drive()
    clouds = (torch.as_tensor(edges, dtype=torch.float32),
              torch.ones(len(edges), dtype=torch.bool),
              torch.as_tensor(surfs, dtype=torch.float32),
              torch.ones(len(surfs), dtype=torch.bool))
    cfgs = {name: rc.drive_config(name, kitti_hdl64()) for name in rc.DRIVES}
    maps = {"production": tloc.build_geometry_maps(*clouds,
                                                   cfgs["production"]),
            "faithful": tloc.build_feature_maps(*clouds, cfgs["faithful"])}
    return dict(inputs=(edges, surfs, scans, gt, twists), arrays=arrays,
                manifest=manifest, cfgs=cfgs, maps=maps)


def test_record_inputs_are_the_ports_worldsim_draws(drive):
    assert rc.drive_inputs_sha256(*drive["inputs"]) \
        == drive["manifest"]["inputs_sha256"]


@pytest.mark.parametrize("name", rc.DRIVES)
def test_problem_at_the_recorded_prior_equals_the_reference(drive, name):
    rec = rc.drive_arrays(drive["arrays"], name)
    want = drive["manifest"]["drives"][name]
    k = rc.DRIVE_PROBE[name]
    cfg = drive["cfgs"][name]
    image = scan_range_image(*drive["inputs"][2][k], cfg, "cpu")
    prior = Pose(torch.as_tensor(rec["prior_q"][k]),
                 torch.as_tensor(rec["prior_t"][k]))
    problem, scale = rc.port_first_problem(drive["maps"][name], image, prior,
                                           cfg)
    np.testing.assert_array_equal(problem.valid.numpy(), rec["probe_valid"])
    differ = int((_bits(problem.errors) != _bits(rec["probe_errors"])).sum())
    assert differ == 0, f"{differ} of {problem.errors.numel()} errors differ"
    assert _bits(scale) == _bits(rec["probe_scale"])
    assert rc.rows_sha256(problem.jac_rows.numpy()) == want["jac_rows_sha256"]
    assert rc.rows_sha256(problem.res_rows.numpy()) == want["res_rows_sha256"]
    # The update's Huber weights (XLA's float32 rsqrt) and normal
    # equations (ROADMAP §C21), as weighted_update forms them.
    errors = torch.where(problem.valid, problem.errors, 0.0)
    weights = stats.huber_derivative(errors / (scale + 1e-16),
                                     cfg.registration.huber_k)
    np.testing.assert_array_equal(_bits(weights), _bits(rec["probe_weights"]))
    w = gn.rows_from_corr(problem, torch.where(problem.valid, weights, 0.0))
    v = gn.rows_from_corr(problem, problem.valid.float())
    j = problem.jac_rows
    got = xd.normal_equations(j * v[:, None], j * w[:, None], j,
                              w * problem.res_rows)
    for key, value in zip("DAb", got):
        np.testing.assert_array_equal(_bits(value),
                                      _bits(rec[f"probe_{key}"]), key)


@pytest.mark.parametrize("name", rc.DRIVES)
def test_drive_follows_the_record(drive, name):
    n = HELD_SCANS[name]
    _, _, scans, _, twists = drive["inputs"]
    got = rc.port_drive(drive["maps"][name], drive["cfgs"][name], scans,
                        twists, "cpu", n_scans=n)
    gaps = rc.drive_gaps(got, rc.drive_arrays(drive["arrays"], name), n)
    assert gaps["first_scan_that_differs"] is None, gaps
    assert gaps["max_fused_t_gap_m"] <= rc.DRIVE_T_ATOL, gaps
    if n == rc.DRIVE_SCANS:
        ate = ate_rmse(np.float64(got["measured_t"]), drive["inputs"][3],
                       align=False)
        want = drive["manifest"]["drives"][name]["ate_rmse_m"]
        assert abs(ate - want) <= ATE_ATOL, (ate, want)


def test_ekf_steps_equal_the_jitted_reference(drive):
    """The drive's EKF calls (50 Hz predicts up to each scan, the twist,
    then the pose measured by the record's registration) through the
    jitted reference and the port in float32: x and P equal bit for bit
    after every call. (The EKF's products, LAPACK inverse and solve are
    single-threaded, so a live reference is the running machine's.)"""
    rec = rc.drive_arrays(drive["arrays"], "production")
    twists = drive["inputs"][4]
    jcfg, cfg = jconfig.EkfConfig(), EkfConfig()
    dt = 1.0 / cfg.predict_frequency
    pose_r = np.diag(np.float32([1.0, 1.0, 0.1])) * cfg.pose_smoothing_steps
    twist_r = np.diag(np.float32([0.04, 0.01])) * cfg.twist_smoothing_steps
    js = jekf.init_ekf(jcfg, dtype=jnp.float32)
    ts = ekf.init_ekf(cfg, dtype=torch.float32, device="cpu")
    calls, clock = 0, 0.0
    for i in range(len(twists)):
        steps = []
        while clock < 0.1 * i:
            steps.append(("predict", dt))
            clock += dt
        y_pose = np.float32([*rec["measured_t"][i][:2], float(xf.atan2(
            *_yaw_terms(torch.as_tensor(rec["measured_q"][i]))))])
        steps += [("twist", np.float32(twists[i])), ("pose", y_pose)]
        for kind, arg in steps:
            if kind == "predict":
                js = jekf.predict(js, arg, jcfg)
                ts = ekf.predict(ts, arg, cfg)
            else:
                update = {"twist": (jekf.update_twist, ekf.update_twist,
                                    twist_r),
                          "pose": (jekf.update_pose, ekf.update_pose,
                                   pose_r)}[kind]
                js = update[0](js, jnp.asarray(arg), jnp.asarray(update[2]),
                               jnp.asarray(0), jcfg)
                ts = update[1](ts, torch.as_tensor(arg),
                               torch.as_tensor(update[2]), 0, cfg)
            calls += 1
            for g, w in ((ts.td.x, js.td.x), (ts.td.p, js.td.p)):
                np.testing.assert_array_equal(_bits(g), _bits(w),
                                              f"scan {i} {kind}")
    assert calls > 3 * len(twists)


def _yaw_terms(q: torch.Tensor):
    """``quat_yaw``'s atan2 arguments, as the closed loop forms them."""
    w, x, y, z = q
    return 2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z)


def test_lu_forms_equal_the_jitted_reference():
    """``kalman.lu_inverse`` and ``lu_solve`` of float32 2 x 2 and 3 x 3
    matrices (random and symmetric positive definite) equal jitted
    ``jnp.linalg.inv`` and ``solve`` (LAPACK's ``sgetrf`` and ``strsm``)
    bit for bit."""
    rng = np.random.default_rng(9)
    inv, solve = jax.jit(jnp.linalg.inv), jax.jit(jnp.linalg.solve)
    for n in (2, 3):
        for t in range(400):
            a = np.float32(rng.normal(size=(n, n)))
            if t % 2:
                a = np.float32(a @ a.T + np.eye(n))
            b = np.float32(rng.normal(size=n))
            ta = torch.as_tensor(a)
            np.testing.assert_array_equal(
                _bits(kalman.lu_inverse(ta)), _bits(inv(a)))
            np.testing.assert_array_equal(
                _bits(kalman.lu_solve(*kalman.lu_factor(ta),
                                      torch.as_tensor(b))),
                _bits(solve(a, b)))


def test_geometry_maps_equal_the_jitted_reference(drive):
    edges, surfs = drive["inputs"][:2]
    cfg = jconfig.kitti_hdl64()
    want = jloc.build_geometry_maps(
        jnp.asarray(edges, jnp.float32), jnp.ones(len(edges), bool),
        jnp.asarray(surfs, jnp.float32), jnp.ones(len(surfs), bool), cfg)
    got = drive["maps"]["production"]
    for g, w in ((got.edge.rec, want.edge.rec),
                 (got.surface.rec, want.surface.rec),
                 (got.fused, want.fused)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _knife_edge_floats(rng, n: int, lo: float, hi: float) -> np.ndarray:
    """Uniform draws plus values an ulp either side of a few round
    numbers in [lo, hi]."""
    base = np.float32([lo, hi, 0.5 * (lo + hi), 0.0, 1.0, -1.0, 0.75,
                       -0.75, np.pi / 2, 2.0943951])
    base = base[(base >= lo) & (base <= hi)]
    ulps = np.concatenate([np.nextafter(base, np.float32(np.inf)),
                           np.nextafter(base, np.float32(-np.inf)), base])
    return np.float32(np.clip(np.concatenate(
        [rng.uniform(lo, hi, n), ulps]), lo, hi))


@pytest.mark.parametrize("fn, lo, hi", [
    ("acos", -1.0, 1.0), ("cos", -3.5, 3.5), ("sin", -3.5, 3.5)])
def test_transcendentals_equal_xla(fn, lo, hi):
    """``xf.acos`` / ``cos`` / ``sin`` are XLA:CPU's float32 ones (glibc's
    ``atan2f`` of ``sqrt((1 - v)(1 + v))``, ``cosf``, ``sinf``) bit for
    bit."""
    x = _knife_edge_floats(np.random.default_rng(3), 200_000, lo, hi)
    jfn = {"acos": jnp.arccos, "cos": jnp.cos, "sin": jnp.sin}[fn]
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    got = getattr(xf, fn)(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_atan2_equals_xla():
    rng = np.random.default_rng(4)
    scale = np.exp(rng.uniform(-30, 30, 100_000))
    y = np.float32(rng.normal(size=scale.size) * scale)
    x = np.float32(rng.normal(size=scale.size))
    y[:50], x[50:100], x[100:150] = 0.0, 0.0, 1.0
    want = np.asarray(jax.jit(jnp.arctan2)(jnp.asarray(y), jnp.asarray(x)))
    got = xf.atan2(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _points_and_poses(n: int, seed: int):
    rng = np.random.default_rng(seed)
    p = np.float32(rng.uniform(-40, 40, (n, 3)))
    axis = rng.normal(size=(n, 3))
    q = np.concatenate([np.cos(0.1 * rng.normal(size=(n, 1))),
                        np.sin(0.05) * axis / np.linalg.norm(
                            axis, axis=-1, keepdims=True)], axis=-1)
    q = np.float32(q / np.linalg.norm(q, axis=-1, keepdims=True))
    return p, q, np.float32(rng.normal(size=(n, 3)))


def test_rotated_points_equal_the_jitted_reference():
    """The residual rows' point transform ``p + 2 fma(w, v x p, v x (v x
    p)) + t`` against the jitted JAX ``Pose.apply``, bit for bit.
    (``DRpDq``'s forms are the rows program's: a lone jit of ``drpdq``
    fuses its right block otherwise; the recorded rows' digests above
    hold them.)"""
    p, q, t = _points_and_poses(50_000, 5)
    want = np.asarray(jax.jit(lambda q, t, p: JPose(q, t).apply(p))(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(p)))
    got = Pose(torch.as_tensor(q), torch.as_tensor(t)).apply_fma(
        torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_residual_forms_equal_the_jitted_reference():
    """The rows' reductions and crosses: ``sum(u * p)`` and ``sum(r * r)``
    as in-order ``fma`` chains, ``Hat(k) @ DRpDq`` and ``u^T DRpDq`` as
    XLA's elemental dot, ``(p - p1) x (p - p2)`` with the first product of
    each component fused, against jitted JAX expressions, bit for bit."""
    p, q, _ = _points_and_poses(50_000, 6)
    u = np.float32(np.random.default_rng(7).normal(size=p.shape))
    dr = np.asarray(jax.jit(jquat.drpdq)(jnp.asarray(q), jnp.asarray(p)))
    kh = np.asarray(jquat.hat(jnp.asarray(u)))
    cases = {
        "dot": (lambda a, b: jnp.sum(a * b, axis=-1), (u, p),
                lambda a, b: xf.dot(a, b)),
        "sum_squares": (lambda a: jnp.sum(a * a, axis=-1), (p,),
                        xf.sum_squares),
        "matmul": (lambda a, b: a @ b, (kh, dr), xf.matmul),
        "vecmat": (lambda a, b: jnp.einsum("...i,...ij->...j", a, b),
                   (u, dr), xf.vecmat),
        "cross": (lambda a, b: jnp.cross(p + a, p - b), (u, u),
                  lambda a, b: xf.cross(torch.as_tensor(p) + a,
                                        torch.as_tensor(p) - b)),
    }
    for name, (jfn, args, tfn) in cases.items():
        want = np.asarray(jax.jit(jfn)(*map(jnp.asarray, args)))
        got = tfn(*map(torch.as_tensor, args)).numpy()
        assert (_bits(got) != _bits(want)).sum() == 0, name


def test_graph_maps_are_plain_under_torch_func():
    """The IMU graph batches and differentiates ``exp_so3`` /
    ``log_so3`` with ``torch.func`` (``plain=True``: torch's ``sin``,
    ``cos``, ``atan2`` and ``sqrt``, since the float32 forms read float
    bits through integer views): in float32 under ``vmap`` and the
    graph's ``_jac`` (``jacfwd``) they give the unbatched values and the identity Jacobian of
    ``log(exp(x))``."""
    from torch.func import vmap
    from lidar_feature_extraction_tpu_torch.core import quaternion as quat
    from lidar_feature_extraction_tpu_torch.parallel.imu_graph import _jac

    theta = torch.as_tensor(np.float32(
        np.random.default_rng(8).normal(scale=0.3, size=(64, 3))))

    def round_trip(x):
        return quat.log_so3(quat.exp_so3(x, plain=True), plain=True)

    value, jac = vmap(lambda x: (round_trip(x), _jac(round_trip, x)))(theta)
    assert jac.dtype == torch.float32
    torch.testing.assert_close(value, round_trip(theta), rtol=1e-6,
                               atol=1e-7)
    torch.testing.assert_close(value, theta, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(jac, torch.eye(3).expand(64, 3, 3),
                               rtol=0, atol=1e-5)
