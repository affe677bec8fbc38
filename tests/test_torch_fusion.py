"""Port parity of the fusion layer: the time-delay Kalman filter, the
pose EKF, the scalar filters, the host-side queues and the EKF node,
against the JAX reference and the dense-matrix oracle of test_ekf.

Tolerances: rtol 1e-5 against the reference, with an absolute floor of
1e-5 of the largest entry of the compared array (P mixes variances of
1e4 with cross terms near 0), and in the float32 node scenarios of 1e-5
of a unit (a twist of 1e-6 m/s is float32 noise around 0); 1e-9
against the float64 dense oracle, as test_ekf holds the reference. Gate
decisions (applied or discarded) are exact. The filter runs in float64
here except in the node scenarios, which run in the node's float32, as
the reference's tests do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_ekf import (  # noqa: E402
    np_time_delay_predict, np_time_delay_update)
from torch_parity import to_np  # noqa: E402
from lidar_feature_extraction_tpu.config import (  # noqa: E402
    EkfConfig as JEkfConfig)
from lidar_feature_extraction_tpu.fusion import ekf as jekf  # noqa: E402
from lidar_feature_extraction_tpu.fusion import kalman as jkal  # noqa: E402
from lidar_feature_extraction_tpu.fusion import queues as jqueues  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import ekf_node as jnode  # noqa: E402
from lidar_feature_extraction_tpu.pipeline.prior_queue import (  # noqa: E402
    PriorPoseQueue as JPriorPoseQueue)
from lidar_feature_extraction_tpu_torch.config import EkfConfig  # noqa: E402
from lidar_feature_extraction_tpu_torch.fusion import ekf  # noqa: E402
from lidar_feature_extraction_tpu_torch.fusion import kalman  # noqa: E402
from lidar_feature_extraction_tpu_torch.fusion import queues  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import ekf_node  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline.prior_queue import (  # noqa: E402
    PriorPoseQueue)

jax.config.update("jax_enable_x64", True)

F64 = torch.float64
D, N = 6, 10


def close(got, want, rtol=1e-5, unit=1e-30):
    """rtol, with an absolute floor of 1e-5 of the array's largest entry
    or of ``unit``, the scale of quantities that are near 0."""
    got, want = to_np(got), np.asarray(want)
    floor = 1e-5 * max(float(np.max(np.abs(want))), unit)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def t64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64))


def _correlated_state(rng):
    """A register after 4 predicts (so blocks are correlated): the
    reference's, the port's and the dense oracle's."""
    x0 = rng.normal(size=D)
    p0 = np.eye(D) * 2.0
    js = jkal.init_time_delay(jnp.asarray(x0), jnp.asarray(p0), N)
    ts = kalman.init_time_delay(t64(x0), t64(p0), N)
    xd, pd = np.tile(x0, N), np.kron(np.eye(N), p0)
    for _ in range(4):
        a = np.eye(D) + 0.05 * rng.normal(size=(D, D))
        q = np.diag(rng.uniform(0, 0.1, size=D))
        xn = rng.normal(size=D)
        js = jkal.predict_with_delay(js, jnp.asarray(xn), jnp.asarray(a),
                                     jnp.asarray(q))
        ts = kalman.predict_with_delay(ts, t64(xn), t64(a), t64(q))
        xd, pd = np_time_delay_predict(xd, pd, xn, a, q)
    return js, ts, xd, pd


def test_time_delay_predict_matches_reference_and_oracle():
    js, ts, xd, pd = _correlated_state(np.random.default_rng(0))
    for got, oracle, want in ((ts.x, xd, js.x), (ts.p, pd, js.p)):
        np.testing.assert_allclose(to_np(got), oracle, atol=1e-9)
        close(got, want)


@pytest.mark.parametrize("delay", [0, 3, 9])
def test_time_delay_update_matches_reference_and_oracle(delay):
    rng = np.random.default_rng(1)
    js, ts, xd, pd = _correlated_state(rng)
    c = rng.normal(size=(3, D))
    r = np.eye(3) * 0.5
    y = rng.normal(size=3)
    js = jkal.update_with_delay(js, jnp.asarray(y), jnp.asarray(c),
                                jnp.asarray(r), jnp.asarray(delay), D)
    ts = kalman.update_with_delay(ts, t64(y), t64(c), t64(r),
                                  torch.tensor(delay), D)
    xd, pd = np_time_delay_update(xd, pd, y, c, r, delay, D)
    for got, oracle, want in ((ts.x, xd, js.x), (ts.p, pd, js.p)):
        np.testing.assert_allclose(to_np(got), oracle, atol=1e-9)
        close(got, want)
    close(kalman.state_at(ts, delay, D), jkal.state_at(js, delay, D))


@pytest.mark.parametrize("delay", [-3, -25, 10, 57])
def test_out_of_range_delay_clamps_like_dynamic_slice(delay):
    """lax.dynamic_slice wraps a negative block once and clamps; the port
    places the block the same way, so that shapes hold (the EKF gate
    then discards the update)."""
    rng = np.random.default_rng(2)
    js, ts, _, _ = _correlated_state(rng)
    c, r, y = rng.normal(size=(2, D)), np.eye(2), rng.normal(size=2)
    want = jkal.update_with_delay(js, jnp.asarray(y), jnp.asarray(c),
                                  jnp.asarray(r), jnp.asarray(delay), D)
    got = kalman.update_with_delay(ts, t64(y), t64(c), t64(r), delay, D)
    close(got.x, want.x)
    close(got.p, want.p)
    close(kalman.state_at(ts, delay, D), jkal.state_at(js, delay, D))


def test_kalman_kernels_match_reference():
    rng = np.random.default_rng(6)
    x, u, y = rng.normal(size=4), rng.normal(size=2), rng.normal(size=2)
    a, b, c = (rng.normal(size=s) for s in ((4, 4), (4, 2), (2, 4)))
    p = rng.normal(size=(4, 4))
    p = p @ p.T + np.eye(4)
    q, r = np.diag(rng.uniform(0, 0.1, 4)), np.eye(2) * 0.3
    k = jkal.calc_kalman_gain(jnp.asarray(p), jnp.asarray(c), jnp.asarray(r))
    close(kalman.calc_kalman_gain(t64(p), t64(c), t64(r)), k)
    for name, args in (("predict_next_state", (x, u, a, b)),
                       ("predict_next_covariance", (p, a, q)),
                       ("update_state", (x, y, c, k)),
                       ("update_covariance", (p, c, k))):
        close(getattr(kalman, name)(*map(t64, args)),
              getattr(jkal, name)(*map(jnp.asarray, args)))


def test_transition_model_matches_reference():
    x = np.random.default_rng(3).normal(size=6)
    close(ekf.predict_next_state(t64(x), 0.02),
          jekf.predict_next_state(jnp.asarray(x), 0.02))
    close(ekf.state_transition_matrix(t64(x), 0.02),
          jekf.state_transition_matrix(jnp.asarray(x), 0.02))
    ys = np.array([0.0, 3.0 * np.pi, -3.0 * np.pi, np.pi, 7.0])
    close(ekf.normalize_yaw(t64(ys)), jekf.normalize_yaw(jnp.asarray(ys)))


def _ekf_run(mod, cfg, steps, t, dtype):
    """Predicts and delayed updates through one filter; returns the
    state after each step."""
    st = mod.init_ekf(cfg, dtype=dtype, **({"device": "cpu"}
                                            if mod is ekf else {}))
    out = []
    for kind, arg in steps:
        if kind == "predict":
            st = mod.predict(st, arg, cfg)
        else:
            y, r, delay = arg
            fn = mod.update_pose if kind == "pose" else mod.update_twist
            st = fn(st, t(y), t(r), (torch.tensor(delay) if mod is ekf
                                     else jnp.asarray(delay)), cfg)
        out.append(st.td)
    return st, out


def _steps(rng):
    """A drive: predicts, pose and twist updates with delays 0-4, an
    outlier 100 sigma off (gated), a delay past the register (gated)
    and a non-finite measurement (discarded)."""
    steps, x = [], 0.0
    for i in range(30):
        steps.append(("predict", 0.02))
        x += 0.02 * 1.5
        if i % 3 == 0:
            steps.append(("twist", ([1.5 + 0.05 * rng.normal(), 0.01],
                                    np.eye(2) * 0.04, 0)))
        if i % 4 == 1:
            d = int(rng.integers(0, 5))
            steps.append(("pose", ([x - 0.03 * d + 0.01 * rng.normal(),
                                    0.01 * rng.normal(), 0.02],
                                   np.eye(3) * 0.01, d)))
    steps += [("pose", ([x + 100.0, 0.0, 0.0], np.eye(3) * 0.01, 0)),
              ("pose", ([x, 0.0, 0.0], np.eye(3) * 0.01, 60)),
              ("twist", ([np.nan, 0.0], np.eye(2), 0)),
              ("pose", ([x, 0.1, 0.0], np.eye(3) * 0.01, -1))]
    return steps


def test_ekf_drive_matches_reference_with_gates_and_delays():
    cfg = EkfConfig(extend_state_step=10, pose_gate_dist=3.0)
    jcfg = JEkfConfig(extend_state_step=10, pose_gate_dist=3.0)
    steps = _steps(np.random.default_rng(4))
    _, want = _ekf_run(jekf, jcfg, steps,
                       lambda a: jnp.asarray(a, jnp.float64), jnp.float64)
    _, got = _ekf_run(ekf, cfg, steps, t64, F64)
    for (kind, _), g, w in zip(steps, got, want):
        close(g.x, w.x)
        close(g.p, w.p)
    # The last four updates were each discarded, in both.
    for g in got[-4:]:
        assert torch.equal(g.x, got[-5].x) and torch.equal(g.p, got[-5].p)
    pose, twist, p = ekf.current_pose_twist(ekf.EkfState(got[-1]))
    jp, jt, jpp = jekf.current_pose_twist(jekf.EkfState(want[-1]))
    close(pose, jp)
    close(twist, jt)
    close(p, jpp)


def test_mahalanobis_gate_rejects_outlier():
    cfg = EkfConfig(extend_state_step=10, pose_gate_dist=3.0)
    st = ekf.init_ekf(cfg, x0=torch.zeros(6, dtype=F64),
                      p0=torch.eye(6, dtype=F64) * 0.01)
    r = torch.eye(3, dtype=F64) * 0.01
    st2 = ekf.update_pose(st, t64([10.0, 0.0, 0.0]), r, 0, cfg)
    assert torch.equal(st2.td.x, st.td.x)
    st3 = ekf.update_pose(st, t64([0.01, 0.0, 0.0]), r, 0, cfg)
    assert abs(float(st3.td.x[0])) > 1e-6


def test_filter1d_matches_reference():
    rng = np.random.default_rng(5)
    f = ekf.Filter1D.create(proc_stddev=0.1, dtype=F64, device="cpu")
    jf = jekf.Filter1D.create(proc_stddev=0.1, dtype=jnp.float64)
    for obs in [5.0] + list(3.0 + 0.1 * rng.normal(size=20)):
        f = ekf.filter1d_update(f, t64(obs), t64(0.1), t64(0.1))
        jf = jekf.filter1d_update(jf, jnp.asarray(obs), jnp.asarray(0.1),
                                  jnp.asarray(0.1))
        close(f.x, jf.x)
        close(f.stddev, jf.stddev)
    assert bool(f.initialized)


# --- host plumbing and the node ---

def test_queue_copies_behave_like_the_reference():
    results = []
    for mod, pq in ((jqueues, JPriorPoseQueue), (queues, PriorPoseQueue)):
        q = mod.AgedMessageQueue(max_age=3)
        q.push("a")
        aged = [q.pop_increment_age() for _ in range(4)]
        ui = mod.UpdateInterval(frequency=50.0)
        dts = [ui.compute(t) for t in (100.0, 100.05, 99.0, 99.1)]
        w = mod.Warning(sink=lambda m: None)
        steps = [mod.delay_step(d, 0.02, 50, w) for d in (0.05, -0.1, 2.0)]
        p = np.arange(36, dtype=np.float64).reshape(6, 6)
        flat = mod.ekf_covariance_to_pose_covariance(p + p.T)
        tw = mod.ekf_covariance_to_twist_covariance(p + p.T)
        r = mod.pose_covariance_to_measurement_r(flat, 5)
        checks = (mod.check_measurement_finite([1.0, np.nan], "pose", w),
                  mod.check_frame("odom", "map", w),
                  mod.check_mahalanobis(9.0, 2.0, w))
        prior = pq()
        for s in (0.3, 0.1, 0.2, 0.2):
            prior.insert(s, f"at {s}")
        closest = [prior.get_closest(s) for s in (0.0, 0.14, 0.16, 9.0)]
        prior.remove_older_than(0.2)
        results.append((aged, dts, steps, flat.tolist(), tw.tolist(),
                        r.tolist(), checks, closest, len(prior)))
    assert results[0] == results[1]


def _pose_cov(var_xy=0.01, var_yaw=0.01):
    c = np.zeros(36)
    c[0] = c[7] = var_xy
    c[35] = var_yaw
    return c


def _twist_cov(var=0.01):
    c = np.zeros(36)
    c[0] = c[35] = var
    return c


def _scenario(name):
    """(EkfConfig kwargs, events): the scenarios of test_ekf_node, and a
    delayed one. An event is ("pose", stamp, x, y, yaw, frame),
    ("twist", stamp, vx, wz), ("tick", now), ("init", args) or
    ("1d", z, roll, pitch)."""
    ev = []
    if name == "static_pose":
        now = 0.0
        for _ in range(100):
            now += 0.02
            ev += [("pose", now, 2.0, -1.0, 0.3, "map"), ("tick", now)]
        return dict(pose_smoothing_steps=1), ev
    if name == "twist_drives_motion":
        now = 0.0
        for _ in range(50):
            now += 0.02
            ev += [("twist", now, 1.0, 0.0), ("tick", now)]
        return {}, ev
    if name == "wrong_frame_and_nan":
        return {}, [("pose", 0.0, 1.0, 0.0, 0.0, "odom"),
                    ("pose", 0.0, np.nan, 0.0, 0.0, "map"), ("tick", 0.02)]
    if name == "stale_measurement":
        return dict(pose_smoothing_steps=1), [
            ("tick", 10.0), ("pose", 5.0, 100.0, 100.0, 1.0, "map"),
            ("tick", 10.02)]
    if name == "initial_pose_reset":
        return {}, [("init", (5.0, -3.0, 0.7, 1.2, 0.1, -0.1)),
                    ("1d", 1.0, 0.05, -0.05), ("tick", 0.02)]
    if name == "smoothing_steps":
        return dict(pose_smoothing_steps=5), [
            ("pose", 0.02, 1.0, 0.0, 0.0, "map"), ("tick", 0.02),
            ("tick", 0.04), ("tick", 0.06)]
    # "delayed": poses that arrive three ticks late, with a twist.
    now = 0.0
    for i in range(60):
        now += 0.02
        ev.append(("twist", now, 1.0, 0.05))
        if i >= 3 and i % 2 == 0:
            lag = now - 0.06
            ev.append(("pose", lag, lag * 1.0, 0.0, 0.05 * lag, "map"))
        ev.append(("tick", now))
    return dict(pose_smoothing_steps=2), ev


def _drive_node(mod, cfg, events, **kw):
    node = mod.EkfNode(cfg, warn=(jqueues if mod is jnode else queues)
                       .Warning(sink=lambda m: None), **kw)
    out = []
    for e in events:
        if e[0] == "pose":
            node.push_pose(mod.PoseMeasurement(
                stamp=e[1], x=e[2], y=e[3], yaw=e[4],
                covariance=_pose_cov(), frame_id=e[5]))
        elif e[0] == "twist":
            node.push_twist(mod.TwistMeasurement(
                stamp=e[1], vx=e[2], wz=e[3], covariance=_twist_cov()))
        elif e[0] == "init":
            node.set_initial_pose(*e[1])
        elif e[0] == "1d":
            node.update_1d_filters(*e[1:])
        else:
            out.append(node.tick(e[1]))
    return out, node


@pytest.mark.parametrize("name", ["static_pose", "twist_drives_motion",
                                  "wrong_frame_and_nan", "stale_measurement",
                                  "initial_pose_reset", "smoothing_steps",
                                  "delayed"])
def test_ekf_node_scenario_matches_reference(name):
    kw, events = _scenario(name)
    want, jn = _drive_node(jnode, JEkfConfig(**kw), events)
    got, tn = _drive_node(ekf_node, EkfConfig(**kw), events, device="cpu")
    assert len(tn.pose_queue) == len(jn.pose_queue)
    assert len(tn.twist_queue) == len(jn.twist_queue)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("pose_xyyaw", "twist", "pose_covariance",
                      "twist_covariance"):
            close(getattr(g, field), getattr(w, field), unit=1.0)
        for field in ("z", "roll", "pitch"):
            assert getattr(g, field) == pytest.approx(getattr(w, field),
                                                      rel=1e-5, abs=1e-6)
