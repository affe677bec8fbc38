"""Port parity of the keyframe back end and the open-loop map builder:
the pose-graph residual and its Jacobians, the dense and matrix-free
pose-graph solvers, the IMU graph with gyro-bias estimation, the
constraint information and ``MapBuilder``. The mapping pipeline that
drives them is held to the reference in test_torch_slam.py.

Tolerances:
- residuals and Jacobians rtol 1e-5 against ``jax.jacfwd`` (float32,
  the same forward-mode derivative of the same formulas);
- the pose-graph solvers in float64, positions and quaternions within
  1e-6: the gauge prior (1e6) against the damping (1e-6) leaves the
  normal equations with a condition number near 1e12, where the float32
  LU solves of two libraries part by 1e-4 m on this graph (its outlier
  is not down-weighted in the plain runs). The conjugate-gradient solver
  runs 10 steps per iteration: past ~20 its iterates lose conjugacy on
  this system and amplify rounding, in either library and even in
  float64, by up to 1e-3 m; at 10 steps the two agree to 1e-14;
- the IMU graph in float32: positions and quaternions within 1e-4, the
  gyro bias within 1e-4 rad/s, velocities within 1e-3 m/s (its Jacobi
  equilibration keeps the float32 solve well conditioned);
- constraint information within 1e-5 (float64 on the host in both, the
  registration Hessian differing in float32 rounding only);
- the map builder: accept decisions, cursor and masks exactly, points
  within 1e-5 m.

The reference's linearization and the IMU graph's keyframe
preintegration run jitted (the noise densities static): one program
instead of a compile per eager operation or call; the IMU graph's
problem is built once.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import np32, port_config, to_np  # noqa: E402
from test_pipeline import small_cfg  # noqa: E402
from lidar_feature_extraction_tpu.core import quaternion as jq  # noqa: E402
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.fusion import imu as jimu  # noqa: E402
from lidar_feature_extraction_tpu.parallel import imu_graph as jig  # noqa: E402
from lidar_feature_extraction_tpu.parallel import pose_graph as jpg  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import mapping as jmap  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import slam as jslam  # noqa: E402
from lidar_feature_extraction_tpu_torch import interop  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.parallel import (  # noqa: E402
    imu_graph as tig, pose_graph as tpg)
from lidar_feature_extraction_tpu_torch.pipeline import mapping as tmap  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import slam as tslam  # noqa: E402

# The float64 solver references need x64 (the whole suite runs with it
# on: ROADMAP §C1); the float32 inputs below are explicit.
jax.config.update("jax_enable_x64", True)

RTOL = 1e-5
POS_ATOL = 1e-4
GRAPH64_ATOL = 1e-6
CG_STEPS = 10
CPU = "cpu"


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _yaw_q(yaw):
    return np32([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


# ---- pose graph ------------------------------------------------------

def _looped_graph(seed, k=10, with_info=False):
    """k poses around a circle, the chain measured with noise, one loop
    constraint k-1 -> 0 and one gross outlier; the initial guess is the
    noisy chain integrated. Returns numpy (poses_q, poses_t) and the
    constraint fields."""
    rng = np.random.default_rng(seed)
    yaw = np.linspace(0, 1.6 * np.pi, k)
    gt = [JPose(jnp.asarray(_yaw_q(a)), jnp.asarray(
        np32([6 * np.sin(a), 6 * (1 - np.cos(a)), 0.1 * a]))) for a in yaw]
    pairs = [(n, n + 1) for n in range(k - 1)] + [(0, k - 1), (2, 6)]
    z_q, z_t = [], []
    for n, (a, b) in enumerate(pairs):
        rel = gt[a].inverse().compose(gt[b])
        noise = jq.exp_so3(jnp.asarray(np32(rng.normal(scale=0.01, size=3))))
        t_off = np32(rng.normal(scale=0.05, size=3))
        if n == len(pairs) - 1:
            t_off = t_off + np32([0.0, 3.0, 0.0])    # the outlier
        z_q.append(np.asarray(jq.quat_multiply(rel.q, noise)))
        z_t.append(np.asarray(rel.t) + t_off)
    poses = [gt[0]]
    for n in range(k - 1):
        poses.append(poses[-1].compose(JPose(jnp.asarray(z_q[n]),
                                             jnp.asarray(z_t[n]))))
    info = None
    if with_info:
        a = rng.normal(size=(len(pairs), 6, 6))
        info = np32(a @ np.swapaxes(a, 1, 2) / 6 + 0.2 * np.eye(6))
    cons = (np.asarray([p[0] for p in pairs], np.int32),
            np.asarray([p[1] for p in pairs], np.int32),
            np32(z_q), np32(z_t),
            np32(np.r_[np.ones(k - 1), 0.8, 0.7]), info)
    return (np32([np.asarray(p.q) for p in poses]),
            np32([np.asarray(p.t) for p in poses])), cons


def _jcons(cons):
    i, j, z_q, z_t, w, info = cons
    return jpg.Constraints(i=jnp.asarray(i), j=jnp.asarray(j),
                           z_q=jnp.asarray(z_q), z_t=jnp.asarray(z_t),
                           weight=jnp.asarray(w),
                           info=None if info is None else jnp.asarray(info))


def test_constraint_linearization_matches_jacfwd():
    (q, t), cons = _looped_graph(0)
    i, j, z_q, z_t = cons[:4]
    args = (q[i], t[i], q[j], t[j], z_q, z_t)
    want = jax.jit(jpg._linearize)(*[jnp.asarray(a) for a in args])
    got = tpg._linearize(*[torch.as_tensor(a) for a in args])
    for a, b in zip(got, want):
        _close(a, b, 1e-5, RTOL)
    _close(tpg.constraint_residual(*[torch.as_tensor(a) for a in args]),
           want[0], 1e-6, RTOL)


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("with_info", [False, True], ids=["scalar", "info"])
@pytest.mark.parametrize("robust_delta", [None, 0.5], ids=["plain", "robust"])
def test_optimize_pose_graph_matches_reference(solver, with_info,
                                               robust_delta):
    (q, t), cons = _looped_graph(1, with_info=with_info)
    q, t = np.asarray(q, np.float64), np.asarray(t, np.float64)
    cons = tuple(c if c is None or c.dtype.kind in "iu"
                 else np.asarray(c, np.float64) for c in cons)
    jfn, tfn, kw = ((jpg.optimize_pose_graph, tpg.optimize_pose_graph, {})
                    if solver == "dense" else
                    (jpg.optimize_pose_graph_cg, tpg.optimize_pose_graph_cg,
                     dict(n_cg=CG_STEPS)))
    want = jfn(jpg.PoseGraph(jnp.asarray(q), jnp.asarray(t)), _jcons(cons),
               n_iterations=6, robust_delta=robust_delta, **kw)
    assert want.poses_t.dtype == jnp.float64
    got = tfn(tpg.PoseGraph(torch.as_tensor(q), torch.as_tensor(t)),
              tpg.Constraints(*[None if a is None else torch.as_tensor(a)
                                for a in cons]),
              n_iterations=6, robust_delta=robust_delta, **kw)
    np.testing.assert_allclose(to_np(got.poses_t), np.asarray(want.poses_t),
                               rtol=0, atol=GRAPH64_ATOL)
    np.testing.assert_allclose(to_np(got.poses_q), np.asarray(want.poses_q),
                               rtol=0, atol=GRAPH64_ATOL)
    # The graph moved: the loop closure bent the drifted chain.
    assert np.abs(np.asarray(want.poses_t) - t).max() > 0.05


_preintegrate = jax.jit(jimu.preintegrate,
                        static_argnames=("gyro_noise", "accel_noise"))


@functools.cache
def _imu_graph_problem(bias=(0.0, 0.0, 0.02)):
    """An arc driven for 2 s, keyframes every 0.2 s, the gyro biased by
    ``bias``; factors preintegrated at zero bias (with their Jacobians),
    the chain measured from the truth with noise, the initial guess the
    noisy chain integrated. All numpy float32."""
    rng = np.random.default_rng(3)
    n, dt, every = 101, 0.02, 10
    th = 2.0 * dt * np.arange(n) / 20.0
    q_gt = np32([_yaw_q(a) for a in th])
    t_gt = np32(np.stack([20 * np.sin(th), 20 * (1 - np.cos(th)),
                          np.zeros(n)], -1))
    gyro, accel, dts, _ = jimu.synthesize_imu(jnp.asarray(q_gt),
                                              jnp.asarray(t_gt), dt)
    gyro = jnp.asarray(np32(np.asarray(gyro) + np32(bias)))
    kf = list(range(0, n, every))
    zero = jnp.zeros(3, jnp.float32)
    pres = [_preintegrate(gyro[a:b], accel[a:b], dts[a:b], zero, zero)
            for a, b in zip(kf[:-1], kf[1:])]
    k = len(kf)
    w_rot, w_vel, w_pos = jig.weights_from_covariance(
        jnp.stack([p.cov for p in pres]))
    gt = [JPose(jnp.asarray(q_gt[a]), jnp.asarray(t_gt[a])) for a in kf]
    rels = [gt[a].inverse().compose(gt[a + 1]) for a in range(k - 1)]
    z_q = np32([np.asarray(r.q) for r in rels])
    z_t = np32([np.asarray(r.t) for r in rels]) \
        + np32(rng.normal(scale=0.02, size=(k - 1, 3)))
    poses = [gt[0]]
    for r_q, r_t in zip(z_q, z_t):
        poses.append(poses[-1].compose(JPose(jnp.asarray(r_q),
                                             jnp.asarray(r_t))))
    pq = np32([np.asarray(p.q) for p in poses])
    pt = np32([np.asarray(p.t) for p in poses])
    vels = np32(np.gradient(pt, axis=0) / (every * dt))
    idx_i = np.arange(k - 1, dtype=np.int32)
    cons = (idx_i, idx_i + 1, z_q, z_t, np32(np.ones(k - 1)), None)
    stack = {f: np32([np.asarray(getattr(p, f)) for p in pres])
             for f in jimu.ImuPreintegration._fields}
    factors = (idx_i, idx_i + 1, stack["dq"], stack["dv"], stack["dp"],
               stack["dt"], np32(w_rot), np32(w_vel), np32(w_pos),
               np32(np.ones(k - 1)), stack["dq_dbg"], stack["dv_dbg"],
               stack["dv_dba"], stack["dp_dbg"], stack["dp_dba"])
    return (pq, pt, vels), cons, factors, t_gt[kf]


@pytest.fixture(scope="module")
def imu_graph_runs():
    (pq, pt, vels), cons, factors, gt = _imu_graph_problem()
    zero3 = np32(np.zeros(3))
    out = {}
    for delta in (None, 0.5):
        want = jig.optimize_imu_graph(
            jig.ImuGraph(jnp.asarray(pq), jnp.asarray(pt), jnp.asarray(vels),
                         bg=jnp.asarray(zero3)),
            _jcons(cons), jig.ImuFactors(*[jnp.asarray(a) for a in factors]),
            n_iterations=8, robust_delta=delta)
        got = tig.optimize_imu_graph(
            interop.imu_graph_from_numpy(pq, pt, vels, bg=zero3, device=CPU),
            interop.constraints_from_numpy(*cons, device=CPU),
            interop.imu_factors_from_numpy(*factors, device=CPU),
            n_iterations=8, robust_delta=delta)
        out[delta] = (want, got)
    return out, gt


@pytest.mark.parametrize("robust_delta", [None, 0.5], ids=["plain", "robust"])
def test_optimize_imu_graph_matches_reference(imu_graph_runs, robust_delta):
    runs, gt = imu_graph_runs
    want, got = runs[robust_delta]
    _close(got.bg, want.bg, 1e-4)
    _close(got.poses_t, want.poses_t, POS_ATOL)
    _close(got.poses_q, want.poses_q, POS_ATOL)
    _close(got.vels, want.vels, 1e-3)
    # The injected 0.02 rad/s yaw-rate bias is recovered.
    assert abs(float(got.bg[2]) - 0.02) < 5e-3, got.bg


def test_estimate_gyro_bias_and_weights_match_reference():
    _, cons, factors, _ = _imu_graph_problem()
    want = jig.estimate_gyro_bias(
        jig.ImuFactors(*[jnp.asarray(a) for a in factors]), _jcons(cons))
    got = tig.estimate_gyro_bias(
        interop.imu_factors_from_numpy(*factors, device=CPU),
        interop.constraints_from_numpy(*cons, device=CPU))
    _close(got, want, 1e-6, RTOL)
    cov = np32(np.random.default_rng(4).uniform(1e-7, 1e-3, (5, 9, 9)))
    for a, b in zip(tig.weights_from_covariance(torch.as_tensor(cov)),
                    jig.weights_from_covariance(jnp.asarray(cov))):
        _close(a, b, 0.0, RTOL)


def test_constraint_info_from_hessian_matches_reference():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(6, 6))
    h = np32(a @ a.T * np.r_[400.0, 300, 200, 5, 4, 0.01])
    q = _yaw_q(0.7)
    want = jslam.constraint_info_from_hessian(jnp.asarray(h), jnp.asarray(q))
    for hess in (torch.as_tensor(h), h):
        got = tslam.constraint_info_from_hessian(hess, torch.as_tensor(q))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
        assert got.dtype == np.float32
    assert tslam.constraint_info_from_hessian(None, q) is None
    assert tslam.constraint_info_from_hessian(
        torch.zeros(6, 6), torch.as_tensor(q)) is None


# ---- open-loop map builder --------------------------------------------

def test_map_builder_matches_reference(tmp_path):
    cfg = small_cfg()
    rng = np.random.default_rng(1)
    scan = np32(rng.uniform(-5, 5, size=(100, 3)))
    valid = np.arange(100) < 70
    jb = jmap.MapBuilder(cfg.mapping, capacity=160)
    tb = tmap.MapBuilder(port_config(cfg).mapping, capacity=160, device=CPU)
    for x, yaw in ((0.0, 0.0), (0.1, 0.0), (2.0, 0.3), (2.1, 0.35),
                   (5.0, 0.0)):
        q, t = _yaw_q(yaw), np32([x, 0.5 * x, 0.0])
        want = jb.add(jnp.asarray(scan), jnp.asarray(valid),
                      JPose(jnp.asarray(q), jnp.asarray(t)))
        got = tb.add(scan, valid, Pose(torch.as_tensor(q),
                                       torch.as_tensor(t)))
        assert got == want
        assert int(tb.state.n) == int(jb.state.n)
        np.testing.assert_array_equal(to_np(tb.valid), np.asarray(jb.valid))
        _close(tb.points, jb.points, 1e-5)
    assert int(tb.state.n) == 160          # capacity reached, rest dropped
    path = str(tmp_path / "map.pcd")
    tb.save_pcd(path)
    from lidar_feature_extraction_tpu_torch.io import pcd
    np.testing.assert_array_equal(pcd.load_pcd(path),
                                  to_np(tb.points)[to_np(tb.valid)])
