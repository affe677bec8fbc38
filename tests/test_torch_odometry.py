"""Port parity of the odometry front end and IMU preintegration: Pose
algebra, the incremental moment grid (signed scatter, whole-voxel rolls,
per-grid residual rows), both odometry steps, the wide-basin
registration, the ``Odometry`` facade's fallback ladder and IMU prior,
and ``fusion/imu.py``.

Inputs are test_pipeline's world and scans (seeded numpy, float32), with
the odometry grid cut to 32 x 32 x 8 voxels and a window of 3 scans so
that eviction runs within five steps. The steps are compared one at a
time: the reference's state before each step is carried into the port
(``interop``), both take the same scan, and their outputs are compared.

Tolerances:
- GN status and iteration counts, window masks, slots and scan counts
  exactly (integer outputs);
- poses, window points and moment grids bit for bit (tolerance 0): the
  port computes the float32 forms of the reference's jitted steps (the
  window's points ``Pose.apply_fma``, ROADMAP §C23), and the facade's
  constant-velocity prior as the reference computes it on the host
  (``Pose.compose``: ``jnp.cross`` is a jitted function of its own);
- whole-voxel rolls exactly (they move values without arithmetic);
- Pose algebra (compose, inverse, matrix) bit for bit, as the reference
  computes it outside ``jax.jit``; pose deltas, residual rows and IMU
  functions rtol 1e-5 (float32, the same formulas); each preintegrated field within 1e-5 of its largest
  entry (100 compounded steps; the small entries of a bias Jacobian are
  differences of large ones);
- the facade's fallback ladder: the same rungs taken (wide-basin calls
  per update) and poses bit for bit; the IMU-seeded update within 1e-4
  (its preintegration is a Python loop, not the reference's ``lax.scan``
  order: ROADMAP §C24).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import np32, port_config, to_np  # noqa: E402
from test_pipeline import (  # noqa: E402
    make_world, pad_to, sample_scan_features, small_cfg)
from lidar_feature_extraction_tpu.core import quaternion as jq  # noqa: E402
from lidar_feature_extraction_tpu.core import pose as jpose  # noqa: E402
from lidar_feature_extraction_tpu.fusion import imu as jimu  # noqa: E402
from lidar_feature_extraction_tpu.ops import geometry_grid as jgg  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import odometry as jodo  # noqa: E402
from lidar_feature_extraction_tpu_torch import interop  # noqa: E402
from lidar_feature_extraction_tpu_torch.core import pose as tpose  # noqa: E402
from lidar_feature_extraction_tpu_torch.fusion import imu as timu  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import geometry_grid as tgg  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import odometry as todo  # noqa: E402

POSE_ATOL = 0.0
PTS_ATOL = 0.0
MOMENT_ATOL = 0.0
# The IMU-seeded update keeps its tolerance until the preintegration is
# in the reference's order (ROADMAP §C24).
IMU_POSE_ATOL = 1e-4
RTOL = 1e-5
N_STEPS = 5
CPU = "cpu"


def _cfgs():
    jc = small_cfg()
    jc = dataclasses.replace(
        jc, registration=dataclasses.replace(jc.registration,
                                             odometry_grid_dims=(32, 32, 8)),
        mapping=dataclasses.replace(jc.mapping, recent_scans_window=3))
    return jc, port_config(jc)


def _true_pose(step):
    return jpose.Pose(q=jq.exp_so3(jnp.asarray([0, 0, 0.02 * step],
                                               jnp.float32)),
                      t=jnp.asarray([0.4 * step, 0.05 * step, 0.0],
                                    jnp.float32))


def _scan(world, pose, rng, cfg):
    e, s = sample_scan_features(*world, pose, rng, n_e=200, n_s=500)
    e_pts, e_valid = pad_to(e, cfg.extraction.max_edges)
    s_pts, s_valid = pad_to(s, cfg.extraction.max_surfaces)
    return (np32(e_pts), np.asarray(e_valid), np32(s_pts),
            np.asarray(s_valid))


def _t(scan):
    return tuple(torch.as_tensor(a) for a in scan)


def _j(scan):
    return tuple(jnp.asarray(a) for a in scan)


def _state_np(state):
    return [np.asarray(x) for x in state]


@pytest.fixture(scope="module")
def drive():
    jc, tc = _cfgs()
    rng = np.random.default_rng(11)
    world = make_world(rng)
    scans = [_scan(world, _true_pose(k), rng, jc) for k in range(N_STEPS)]
    return dict(jc=jc, tc=tc, world=world, scans=scans)


_STEPS = {
    "points": (jodo.init_odometry, jodo.odometry_step,
               interop.odometry_state_from_numpy, todo.odometry_step),
    "geometry": (jodo.init_geometry_odometry, jodo.geometry_odometry_step,
                 interop.geometry_odometry_state_from_numpy,
                 todo.geometry_odometry_step),
}


@pytest.fixture(scope="module")
def steps(drive):
    """Per kind, per step: (reference state before, reference (state,
    result) after, port (state, result) after)."""
    out = {}
    for kind, (j_init, j_step, from_np, t_step) in _STEPS.items():
        state = j_init(drive["jc"], jnp.float32)
        runs = []
        for scan in drive["scans"]:
            want = j_step(state, *_j(scan), drive["jc"])
            got = t_step(from_np(*_state_np(state), device=CPU), *_t(scan),
                         drive["tc"])
            runs.append((state, want, got))
            state = want[0]
        out[kind] = runs
    return out


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def test_pose_algebra_matches_reference():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(6, 4))
    q = np32(q / np.linalg.norm(q, axis=-1, keepdims=True))
    t = np32(rng.normal(scale=5.0, size=(6, 3)))
    ja, jb = jpose.Pose(jnp.asarray(q), jnp.asarray(t)), \
        jpose.Pose(jnp.asarray(q[::-1].copy()), jnp.asarray(t[::-1].copy()))
    ta, tb = tpose.Pose(torch.as_tensor(q), torch.as_tensor(t)), \
        tpose.Pose(torch.as_tensor(q[::-1].copy()),
                   torch.as_tensor(t[::-1].copy()))
    # The reference runs these outside jax.jit: the port's forms are its
    # eager ones, bit for bit (ROADMAP §C23).
    for got, want in ((ta.compose(tb), ja.compose(jb)),
                      (ta.inverse(), ja.inverse()),
                      (tpose.Pose.from_matrix(ta.matrix()),
                       jpose.Pose.from_matrix(ja.matrix()))):
        _close(got.q, want.q, 0.0)
        _close(got.t, want.t, 0.0)
    _close(ta.matrix(), ja.matrix(), 0.0)
    for got, want in zip(tpose.pose_delta_magnitudes(ta, tb),
                         jpose.pose_delta_magnitudes(ja, jb)):
        _close(got, want, 1e-6, RTOL)


def _moments(seed, dims, voxel, origin):
    rng = np.random.default_rng(seed)
    ext = np32(dims) * voxel
    xyz = np32(origin + rng.uniform(-0.2, 1.2, size=(400, 3)) * ext)
    mask = rng.uniform(size=400) < 0.9
    m = jgg.voxel_moments(jnp.asarray(xyz), jnp.asarray(mask), voxel,
                          jnp.asarray(origin), dims)
    return np.asarray(m), xyz, mask


@pytest.mark.parametrize("target", [(3.1, -2.2, 0.7), (-5.3, 4.6, -1.9),
                                    (0.0, 0.0, 0.0)],
                         ids=["positive", "negative", "zero"])
def test_recenter_moments_matches_reference(target):
    dims, voxel = (8, 6, 4), 1.0
    origin = np32([-4.0, -3.0, -2.0])
    m, _, _ = _moments(1, dims, voxel, origin)
    want_m, want_o = jgg.recenter_moments(jnp.asarray(m), dims, voxel,
                                          jnp.asarray(origin),
                                          jnp.asarray(np32(target)))
    got_m, got_o = tgg.recenter_moments(torch.as_tensor(m), dims, voxel,
                                        torch.as_tensor(origin),
                                        torch.as_tensor(np32(target)))
    np.testing.assert_array_equal(to_np(got_m), np.asarray(want_m))
    np.testing.assert_array_equal(to_np(got_o), np.asarray(want_o))


def test_voxel_moments_weight_minus_one_removes_points():
    dims, voxel = (8, 6, 4), 1.0
    origin = np32([-4.0, -3.0, -2.0])
    m, xyz, mask = _moments(2, dims, voxel, origin)
    args = (voxel, torch.as_tensor(origin), dims)
    added = tgg.voxel_moments(torch.as_tensor(xyz), torch.as_tensor(mask),
                              *args)
    _close(added, m, 1e-5)
    both = np.concatenate([xyz, xyz[:200]])
    both_mask = np.concatenate([mask, mask[:200]])
    both_sign = np32(np.concatenate([np.ones(400), np.full(200, -1.0)]))
    # Insert all, then remove the first 200 in the same scatter: what is
    # left is the scatter of the last 200 alone.
    got = tgg.voxel_moments(torch.as_tensor(both),
                            torch.as_tensor(both_mask), *args,
                            weight=torch.as_tensor(both_sign))
    want = jgg.voxel_moments(jnp.asarray(both), jnp.asarray(both_mask),
                             voxel, jnp.asarray(origin), dims,
                             weight=jnp.asarray(both_sign))
    rest = tgg.voxel_moments(torch.as_tensor(xyz[200:]),
                             torch.as_tensor(mask[200:]), *args)
    _close(got, want, 1e-5)
    _close(got, to_np(rest), 1e-5)


@pytest.mark.parametrize("kind", ["edge", "surface"])
def test_rows_from_grid_match_reference(drive, kind):
    jc = drive["jc"]
    reg = jc.registration
    dims = reg.odometry_grid_dims
    vm = reg.edge_map if kind == "edge" else reg.surface_map
    world = np32(drive["world"][0] if kind == "edge" else drive["world"][1])
    origin = np32(-np32(dims) * vm.voxel_size / 2.0)
    build = (jgg.build_edge_geometry_grid if kind == "edge"
             else jgg.build_surface_geometry_grid)
    grid = build(jnp.asarray(world), jnp.ones(len(world), bool),
                 vm.voxel_size, jnp.asarray(origin), dims)
    tgrid = tgg.GeometryGrid(rec=torch.as_tensor(np.asarray(grid.rec)),
                             voxel_size=torch.as_tensor(vm.voxel_size),
                             origin=torch.as_tensor(origin), dims=dims)
    e_pts, e_valid, s_pts, s_valid = drive["scans"][2]
    pts, valid = (e_pts, e_valid) if kind == "edge" else (s_pts, s_valid)
    jp = _true_pose(2)
    tp = tpose.Pose(torch.as_tensor(np.asarray(jp.q)),
                    torch.as_tensor(np.asarray(jp.t)))
    jfn = jgg.edge_rows_from_grid if kind == "edge" \
        else jgg.surface_rows_from_grid
    tfn = tgg.edge_rows_from_grid if kind == "edge" \
        else tgg.surface_rows_from_grid
    want = jfn(grid, jnp.asarray(pts), jnp.asarray(valid), jp,
               reg.min_fit_points)
    got = tfn(tgrid, torch.as_tensor(pts), torch.as_tensor(valid), tp,
              reg.min_fit_points)
    np.testing.assert_array_equal(to_np(got.valid), np.asarray(want.valid))
    assert np.asarray(want.valid).sum() > 50
    _close(got.residual, want.residual, 1e-4, RTOL)
    _close(got.jacobian, want.jacobian, 1e-4, RTOL)


@pytest.mark.parametrize("kind", sorted(_STEPS))
def test_odometry_step_matches_reference_step_by_step(steps, kind):
    for n, (_, (want_s, want_r), (got_s, got_r)) in enumerate(steps[kind]):
        assert int(got_r.status) == int(want_r.status), n
        assert int(got_r.iterations) == int(want_r.iterations), n
        _close(got_s.pose_q, want_s.pose_q, POSE_ATOL)
        _close(got_s.pose_t, want_s.pose_t, POSE_ATOL)
        for name in ("edge_mask", "surf_mask", "slot", "n_scans"):
            np.testing.assert_array_equal(to_np(getattr(got_s, name)),
                                          np.asarray(getattr(want_s, name)))
        _close(got_s.edge_window, want_s.edge_window, PTS_ATOL)
        _close(got_s.surf_window, want_s.surf_window, PTS_ATOL)
        if kind == "geometry":
            _close(got_s.edge_origin, want_s.edge_origin, 1e-6)
            _close(got_s.surf_origin, want_s.surf_origin, 1e-6)
            _close(got_s.edge_m, want_s.edge_m, MOMENT_ATOL)
            _close(got_s.surf_m, want_s.surf_m, MOMENT_ATOL)
    # Five steps through a window of three: slots wrapped, scans evicted.
    assert int(steps[kind][-1][1][0].n_scans) == N_STEPS


def test_geometry_odometry_tracks_the_drive(steps):
    final = steps["geometry"][-1][2][0]
    want = np.asarray(_true_pose(N_STEPS - 1).t)
    assert np.linalg.norm(to_np(final.pose_t) - want) < 0.15


def test_register_to_window_matches_reference(steps, drive):
    jstate = steps["points"][3][0]
    scan = drive["scans"][3]
    prior = _true_pose(2)
    want = jodo.register_to_window(
        jstate.edge_window, jstate.edge_mask, jstate.surf_window,
        jstate.surf_mask, *_j(scan), prior.q, prior.t, drive["jc"], 2)
    t = {n: torch.as_tensor(np.asarray(getattr(jstate, n)))
         for n in ("edge_window", "edge_mask", "surf_window", "surf_mask")}
    got = todo.register_to_window(
        t["edge_window"], t["edge_mask"], t["surf_window"], t["surf_mask"],
        *_t(scan), torch.as_tensor(np.asarray(prior.q)),
        torch.as_tensor(np.asarray(prior.t)), drive["tc"], 2)
    assert int(got.status) == int(want.status)
    assert int(got.iterations) == int(want.iterations)
    _close(got.pose.q, want.pose.q, POSE_ATOL)
    _close(got.pose.t, want.pose.t, POSE_ATOL)


def _count_calls(monkeypatch, module):
    calls = []
    inner = module.register_to_window

    def counted(*args, **kwargs):
        calls.append(args[-1])
        return inner(*args, **kwargs)

    monkeypatch.setattr(module, "register_to_window", counted)
    return calls


def test_odometry_fallback_ladder_matches_reference(drive, monkeypatch):
    """Three steady scans, then a motion break (1.5 m sideways and 0.35
    rad of yaw in one scan): the constant-velocity attempt fails the
    edge gate and the ladder runs, in the reference and the port alike."""
    jc, tc = drive["jc"], drive["tc"]
    rng = np.random.default_rng(5)
    poses = [_true_pose(k) for k in range(3)]
    poses.append(jpose.Pose(jq.exp_so3(jnp.asarray([0, 0, 0.4],
                                                   jnp.float32)),
                            jnp.asarray([0.9, 1.6, 0.0], jnp.float32)))
    scans = [_scan(drive["world"], p, rng, jc) for p in poses]
    j_calls = _count_calls(monkeypatch, jodo)
    t_calls = _count_calls(monkeypatch, todo)
    jo = jodo.Odometry(jc)
    to = todo.Odometry(tc, device=CPU)
    for n, scan in enumerate(scans):
        want = jo.update(*_j(scan))
        got = to.update(*_t(scan))
        assert int(got.status) == int(want.status), n
        assert t_calls == j_calls, n
        _close(to.pose.q, jo.pose.q, POSE_ATOL)
        _close(to.pose.t, jo.pose.t, POSE_ATOL)
    assert j_calls, "the motion break did not reach the wide-basin rung"
    assert to.n_scans == int(jo.state.n_scans)


# ---- IMU ---------------------------------------------------------------

def _imu_window(seed, n=100):
    rng = np.random.default_rng(seed)
    gyro = np32(rng.normal(scale=0.3, size=(n, 3)))
    accel = np32(rng.normal(scale=2.0, size=(n, 3)) + [0, 0, 9.8])
    dts = np32(np.full(n, 0.001) + rng.uniform(0, 1e-4, n))
    valid = np.arange(n) < n - 7      # masked padding lanes at the end
    valid[40] = False                 # and one in the middle
    bg, ba = np32([0.01, -0.02, 0.005]), np32([0.05, 0.0, -0.03])
    return gyro, accel, dts, valid, bg, ba


@pytest.fixture(scope="module")
def preint():
    gyro, accel, dts, valid, bg, ba = _imu_window(3)
    want = jimu.preintegrate(*[jnp.asarray(a) for a in
                               (gyro, accel, dts, bg, ba, valid)])
    got = timu.preintegrate(*[torch.as_tensor(a) for a in
                              (gyro, accel, dts, bg, ba, valid)])
    return want, got


@pytest.mark.parametrize("field", jimu.ImuPreintegration._fields)
def test_preintegrate_matches_reference(preint, field):
    want, got = preint
    w = np.asarray(getattr(want, field))
    _close(getattr(got, field), w, RTOL * np.abs(w).max(), RTOL)


def test_preintegrate_skips_masked_lanes():
    gyro, accel, dts, valid, bg, ba = _imu_window(4)
    full = timu.preintegrate(*[torch.as_tensor(a) for a in
                               (gyro, accel, dts, bg, ba, valid)])
    packed = timu.preintegrate(*[torch.as_tensor(a) for a in
                                 (gyro[valid], accel[valid], dts[valid],
                                  bg, ba)])
    for a, b in zip(full, packed):
        np.testing.assert_array_equal(to_np(a), to_np(b))


def test_predict_state_and_factor_residual_match_reference(preint):
    """On the reference's own preintegrated window, carried across."""
    want_pre, _ = preint
    got_pre = interop.imu_preintegration_from_numpy(
        *[np.asarray(f) for f in want_pre], device=CPU)
    q = np32([0.9, 0.1, -0.2, 0.3])
    q = np32(q / np.linalg.norm(q))
    t, v = np32([1.0, -2.0, 0.5]), np32([3.0, 0.5, -0.1])
    jout = jimu.predict_state(jnp.asarray(q), jnp.asarray(t), jnp.asarray(v),
                              want_pre)
    tout = timu.predict_state(torch.as_tensor(q), torch.as_tensor(t),
                              torch.as_tensor(v), got_pre)
    for a, b in zip(tout, jout):
        _close(a, b, 1e-5, RTOL)
    # The residual at a state off the prediction, with bias deltas.
    qj, pj, vj = (np.asarray(x) + d for x, d in zip(
        jout, (np32([0.0, 0.01, 0, 0]), np32([0.05, 0, 0]),
               np32([0, 0.1, 0]))))
    dbg, dba = np32([1e-3, 0, -2e-3]), np32([0, 1e-2, 0])
    jres = jimu.imu_factor_residual(
        want_pre, *[jnp.asarray(np32(a)) for a in (q, t, v, qj, pj, vj)],
        delta_bg=jnp.asarray(dbg), delta_ba=jnp.asarray(dba))
    tres = timu.imu_factor_residual(
        got_pre, *[torch.as_tensor(np32(a)) for a in (q, t, v, qj, pj, vj)],
        delta_bg=torch.as_tensor(dbg), delta_ba=torch.as_tensor(dba))
    for a, b in zip(tres, jres):
        _close(a, b, 1e-5, RTOL)


def test_synthesize_imu_matches_reference():
    th = np.linspace(0, 1.2, 41)
    q = np32(np.stack([np.cos(th / 2), 0 * th, 0 * th, np.sin(th / 2)], -1))
    t = np32(np.stack([5 * np.sin(th), 5 * (1 - np.cos(th)), 0.1 * th], -1))
    want = jimu.synthesize_imu(jnp.asarray(q), jnp.asarray(t), 0.01)
    got = timu.synthesize_imu(torch.as_tensor(q), torch.as_tensor(t), 0.01)
    for a, b in zip(got, want):
        _close(a, b, 1e-3, 1e-4)


def test_update_with_imu_matches_reference(drive):
    """Two IMU-seeded updates along the drive, the IMU windows made from
    the true motion."""
    jc, tc = drive["jc"], drive["tc"]
    jo = jodo.Odometry(jc)
    to = todo.Odometry(tc, device=CPU)
    fine_t = np.linspace(0, 2, 201)
    q = np32(np.stack([np.cos(0.01 * fine_t), 0 * fine_t, 0 * fine_t,
                       np.sin(0.01 * fine_t)], -1))
    t = np32(np.stack([0.4 * fine_t, 0.05 * fine_t, 0 * fine_t], -1))
    gyro, accel, dts, _ = jimu.synthesize_imu(jnp.asarray(q), jnp.asarray(t),
                                              0.01)
    gyro, accel, dts = np32(gyro), np32(accel), np32(dts)
    for n, scan in enumerate(drive["scans"][:3]):
        sl = slice(max(n - 1, 0) * 100, max(n, 1) * 100)
        want = jo.update_with_imu(*_j(scan), gyro[sl], accel[sl], dts[sl])
        got = to.update_with_imu(*_t(scan), gyro[sl], accel[sl], dts[sl])
        assert int(got.status) == int(want.status), n
        assert int(got.iterations) == int(want.iterations), n
        _close(to.pose.t, jo.pose.t, IMU_POSE_ATOL)
        _close(to.pose.q, jo.pose.q, IMU_POSE_ATOL)
        _close(to.velocity, jo.velocity, 1e-3)
