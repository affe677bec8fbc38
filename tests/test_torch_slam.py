"""Port parity of the mapping pipeline, the slice as a whole: the whole
``MappingPipeline`` (odometry, keyframes, loop closure through the
coarse-to-fine pyramid, the pose-graph or IMU-graph back end) with and
without IMU windows, its checkpoint, and the mapping drive simulator.
The back-end solvers are held to the reference one by one in
test_torch_pose_graph.py.

The pipeline runs test_slam's loop-closure scenario (an out-and-back
drive over test_pipeline's world) with the odometry grid cut to
32 x 32 x 8 voxels; the reference's runs are computed once per module.
The reference runs its graph solvers, its keyframe preintegration and
its loop-closure registrations eagerly, which compiles their loops
again at every call; here they are jitted (iteration counts and noise
densities static; a registration's problem closure with its arrays as
arguments), so the runs reuse one program per shape (the same functions
on the same inputs).

Tolerances:
- keyframe count, every constraint's (i, j) and IMU factor count
  exactly; without IMU the chain constraints and the loop closures up to
  the first ``optimize()`` bit for bit (relative pose, weight, 6x6
  information), and the optimized graph, every constraint and the
  keyframe trajectory at 0 too (ROADMAP §C23, repaired); with IMU
  relative poses within 1e-4 (the preintegration's order, ROADMAP §C24),
  loop weights within 1e-6, the keyframe trajectory within 1e-3 m and
  the assembled map within 2e-3 m (a dozen chained float32
  registrations and graph solves); the gyro bias within 1e-4 rad/s;
- the resumed run: its trajectory within 1e-6 m of the unbroken run's
  (the same operations on the same values in one process);
- the mapping drive: ray-cast scans and IMU windows exactly (the same
  numpy draws), feature masks and points exactly: the reference
  extracts under ``jax.jit``, whose float32 arithmetic XLA contracts
  into FMAs, and the port computes the same fused operations (ROADMAP
  §C6, §C18).
"""

import contextlib
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import np32, port_config, to_np  # noqa: E402
from test_pipeline import (  # noqa: E402
    make_world, pad_to, sample_scan_features, small_cfg)
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.fusion import imu as jimu  # noqa: E402
from lidar_feature_extraction_tpu.ops import gauss_newton as jgn  # noqa: E402
from lidar_feature_extraction_tpu.parallel import imu_graph as jig  # noqa: E402
from lidar_feature_extraction_tpu.parallel import pose_graph as jpg  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import slam as jslam  # noqa: E402
from lidar_feature_extraction_tpu.utils import worldsim as jws  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import slam as tslam  # noqa: E402
from lidar_feature_extraction_tpu_torch.utils import worldsim as tws  # noqa: E402

# The whole suite runs with x64 on (ROADMAP §C1); so does this file
# alone, and every input below is explicit float32.
jax.config.update("jax_enable_x64", True)

REL_ATOL = 1e-4
TRAJ_ATOL = 1e-3
# Without IMU the front end equals the reference bit for bit: every
# constraint whose registration does not start from an optimized graph
# (the chain's, and loop closures up to the first optimize()) is held at
# 0 in test_mapping_pipeline_matches_reference, and the graph and the
# closures registered from it in
# test_mapping_pipeline_graph_is_the_reference_bit_for_bit.
EXACT = 0.0
CPU = "cpu"


def _cfgs():
    jc = small_cfg()
    jc = dataclasses.replace(
        jc, registration=dataclasses.replace(jc.registration,
                                             odometry_grid_dims=(32, 32, 8)))
    return jc, port_config(jc)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _yaw_q(yaw):
    return np32([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


# ---- the pipeline ------------------------------------------------------

_XS = [0, 2, 4, 6, 4, 2, 0.2]        # out and back along x
_KW = dict(loop_radius=2.5, loop_min_gap=2, optimize_every=100)


def _drive():
    """test_slam's loop-closure scenario: test_pipeline's world and, from
    the same ``rng`` stream, per scan (edge, edge valid, surface, surface
    valid, stamp) as float32 numpy; and IMU windows of 10 samples
    between scans (piecewise-linear motion through the scan positions)."""
    jc, _ = _cfgs()
    rng = np.random.default_rng(1)
    world = make_world(rng)
    out = []
    for n, x in enumerate(_XS):
        pose = JPose(jnp.asarray(_yaw_q(0.0)), jnp.asarray(np32([x, 0, 0])))
        e, s = sample_scan_features(*world, pose, rng, n_e=200, n_s=500)
        e_pts, e_valid = pad_to(e, jc.extraction.max_edges)
        s_pts, s_valid = pad_to(s, jc.extraction.max_surfaces)
        out.append((np32(e_pts), np.asarray(e_valid), np32(s_pts),
                    np.asarray(s_valid), 0.1 * n))
    fine = np.linspace(0, len(_XS) - 1, 10 * (len(_XS) - 1) + 1)
    px = np.interp(fine, np.arange(len(_XS)), np.asarray(_XS, float))
    t = np32(np.stack([px, 0 * fine, 0 * fine], -1))
    q = np32(np.tile(_yaw_q(0.0), (len(fine), 1)))
    gyro, accel, dts, _ = jimu.synthesize_imu(jnp.asarray(q), jnp.asarray(t),
                                              0.01)
    windows = [None] + [tuple(np32(a)[10 * (n - 1):10 * n]
                              for a in (gyro, accel, dts))
                        for n in range(1, len(_XS))]
    return out, windows


def _compiled_once(run):
    """``run(problem_fn, pose, **kw)`` jitted once per kind of problem:
    the arrays of the problem closure (its cells and defaults) become
    arguments of one compiled program, keyed by the closure's code, its
    other (static) contents, the arrays' shapes and the keywords. Every
    loop-closure registration of one pyramid stage then reuses it."""
    cache = {}

    def cached(problem_fn, initial_pose, **kw):
        leaves, tree = jax.tree_util.tree_flatten((
            [c.cell_contents for c in problem_fn.__closure__ or ()],
            problem_fn.__defaults__ or ()))
        traced = [isinstance(x, (jax.Array, np.ndarray, float))
                  for x in leaves]
        key = (problem_fn.__code__, tree, tuple(
            (jnp.shape(x), jnp.result_type(x)) if t else x
            for x, t in zip(leaves, traced)), tuple(sorted(kw.items())))
        if key not in cache:
            static = list(leaves)

            def program(pose, arrays):
                it = iter(arrays)
                cells, defaults = jax.tree_util.tree_unflatten(
                    tree, [next(it) if t else x
                           for x, t in zip(static, traced)])
                fn = types.FunctionType(
                    problem_fn.__code__, problem_fn.__globals__,
                    problem_fn.__name__, tuple(defaults) or None,
                    tuple(types.CellType(c) for c in cells) or None)
                return run(fn, pose, **kw)
            cache[key] = jax.jit(program)
        return cache[key](initial_pose,
                          [x for x, t in zip(leaves, traced) if t])
    return cached


_REF_GN = types.SimpleNamespace(**{
    **vars(jgn), "run_gauss_newton": _compiled_once(jgn.run_gauss_newton)})


@contextlib.contextmanager
def _jitted_reference():
    """The reference's graph solvers, keyframe preintegration and
    loop-closure registrations, jitted (iteration counts and noise
    densities static). The kernel width stays a Python float argument:
    with x64 on it is traced as a weak float64, so its square is rounded
    as the float's is, and one program serves all three stages of the
    graduated schedule of a given length."""
    static = ("n_iterations",)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jslam, "gn", _REF_GN)
        mp.setattr(jslam, "optimize_pose_graph", jax.jit(
            jpg.optimize_pose_graph, static_argnames=static))
        mp.setattr(jig, "optimize_imu_graph", jax.jit(
            jig.optimize_imu_graph, static_argnames=static))
        mp.setattr(jimu, "preintegrate", jax.jit(
            jimu.preintegrate, static_argnames=("gyro_noise",
                                                "accel_noise")))
        yield


def _run_pipeline(pipeline, scans, windows, as_arrays):
    for scan, win in zip(scans, windows):
        *feats, stamp = scan
        kw = {} if win is None else dict(imu_gyro=win[0], imu_accel=win[1],
                                         imu_dts=win[2])
        pipeline.process_scan(*as_arrays(feats), stamp=stamp, **kw)
    pipeline.optimize()
    return pipeline


@pytest.fixture(scope="module")
def pipelines():
    jc, tc = _cfgs()
    scans, windows = _drive()
    out = {}
    for imu in (False, True):
        win = windows if imu else [None] * len(scans)
        with _jitted_reference():
            want = _run_pipeline(jslam.MappingPipeline(jc, **_KW), scans,
                                 win, lambda f: [jnp.asarray(a) for a in f])
        got = _run_pipeline(tslam.MappingPipeline(tc, device=CPU, **_KW),
                            scans, win, lambda f: f)
        out[imu] = (want, got)
    return out


@pytest.mark.parametrize("imu", [False, True], ids=["pose_graph",
                                                    "imu_graph"])
def test_mapping_pipeline_matches_reference(pipelines, imu):
    want, got = pipelines[imu]
    assert len(got.keyframes) == len(want.keyframes)
    assert [c[:2] for c in got.constraints] == \
        [c[:2] for c in want.constraints]
    n_chain = len(want.keyframes) - 1
    assert len(want.constraints) > n_chain, "no loop constraint in the run"
    for k, ((_, _, rel, w, info), (i, j, jrel, jw, jinfo)) in enumerate(
            zip(got.constraints, want.constraints)):
        exact = not imu and k <= _first_optimize(want.constraints)
        atol = EXACT if exact or (not imu and j == i + 1) else REL_ATOL
        _close(rel.q, jrel.q, atol)
        _close(rel.t, jrel.t, atol)
        if atol == EXACT:
            assert w == jw
            if info is not None:
                _close(info, jinfo, EXACT)
        assert abs(w - jw) < 1e-6
        assert (info is None) == (jinfo is None)
    _close(got.trajectory, want.trajectory, TRAJ_ATOL)
    assert len(got.imu_factors) == len(want.imu_factors)
    if imu:
        _close(got.imu_bias[0], want.imu_bias[0], 1e-4)
    e, s = got.assemble_map()
    je, js = want.assemble_map()
    assert e.shape == je.shape and s.shape == js.shape
    _close(e, je, TRAJ_ATOL + 1e-3)


def _first_optimize(constraints) -> int:
    """Index of the constraint after which the run first optimized: its
    first loop closure (optimize_every exceeds the run's keyframes)."""
    return next(k for k, c in enumerate(constraints) if c[1] - c[0] > 1)


def test_mapping_pipeline_graph_is_the_reference_bit_for_bit(pipelines):
    """The optimized trajectory and the loop closures registered from it,
    at tolerance 0."""
    want, got = pipelines[False]
    for (_, _, rel, _, _), (_, _, jrel, _, _) in zip(got.constraints,
                                                     want.constraints):
        _close(rel.q, jrel.q, EXACT)
        _close(rel.t, jrel.t, EXACT)
    _close(got.trajectory, want.trajectory, EXACT)


def _scans_half_metre(cfg, world):
    rng = np.random.default_rng(21)
    out = []
    for n in range(10):
        pose = JPose(jnp.asarray(_yaw_q(0.0)),
                     jnp.asarray(np32([0.5 * n, 0.0, 0.0])))
        e, s = sample_scan_features(*world, pose, rng, n_e=200, n_s=500)
        e_pts, e_valid = pad_to(e, cfg.extraction.max_edges)
        s_pts, s_valid = pad_to(s, cfg.extraction.max_surfaces)
        out.append((np32(e_pts), np.asarray(e_valid), np32(s_pts),
                    np.asarray(s_valid), 0.1 * n))
    return out


@pytest.mark.parametrize("imu", [False, True], ids=["no_imu", "imu"])
def test_checkpoint_resume_gives_the_unbroken_run(tmp_path, imu):
    """Five scans, checkpoint (with IMU samples buffered since the last
    keyframe: steps of 0.5 m leave every other scan out), restore, five
    more: the trajectory and the bookkeeping of the unbroken run."""
    jc, tc = _cfgs()
    scans = _scans_half_metre(jc, make_world(np.random.default_rng(5)))
    rng = np.random.default_rng(2)
    windows = [None] + [
        (np32(rng.normal(scale=1e-3, size=(10, 3))),
         np32(rng.normal(scale=1e-2, size=(10, 3)) + [5.0, 0, 9.80665]),
         np32(np.full(10, 0.01))) for _ in scans[1:]]
    if not imu:
        windows = [None] * len(scans)
    kw = dict(loop_min_gap=99, optimize_every=2)

    def feed(p, part, wins):
        for scan, win in zip(part, wins):
            *feats, stamp = scan
            extra = {} if win is None else dict(
                imu_gyro=win[0], imu_accel=win[1], imu_dts=win[2])
            p.process_scan(*feats, stamp=stamp, **extra)

    unbroken = tslam.MappingPipeline(tc, device=CPU, **kw)
    feed(unbroken, scans, windows)
    first = tslam.MappingPipeline(tc, device=CPU, **kw)
    feed(first, scans[:5], windows[:5])
    assert bool(first._imu_buffer) == imu
    path = str(tmp_path / "slam_ckpt.npz")
    first.save_checkpoint(path)
    resumed = tslam.MappingPipeline.restore(path, tc, device=CPU, **kw)
    feed(resumed, scans[5:], windows[5:])
    assert len(resumed.keyframes) == len(unbroken.keyframes) >= 4
    assert [c[:2] for c in resumed.constraints] == \
        [c[:2] for c in unbroken.constraints]
    assert len(resumed.imu_factors) == len(unbroken.imu_factors)
    np.testing.assert_allclose(resumed.trajectory, unbroken.trajectory,
                               rtol=0, atol=1e-6)


def test_run_mapping_drive_draws_the_reference_inputs(monkeypatch):
    """The port's drive simulator hands the pipeline what the
    reference's does: scans, features, IMU windows, the IMU trust
    model. Both pipelines are replaced by a recorder, and both ray
    casters record what they return."""
    seen = {}

    def recorder(tag):
        class Recorder:
            def __init__(self, cfg, **kwargs):
                seen[tag].update(kwargs=kwargs, scans=[])
                self.keyframes = []

            def process_scan(self, *feats, stamp=0.0, **imu):
                seen[tag]["scans"].append(
                    ([to_np(f) for f in feats],
                     {k: to_np(v) for k, v in imu.items()}))
                self.keyframes.append(type("Kf", (), {"stamp": stamp}))

            def optimize(self):
                pass
        return Recorder

    def recording(tag, raycast):
        def wrapped(*args, **kwargs):
            out = raycast(*args, **kwargs)
            seen[tag]["raycast"].append(tuple(np.asarray(a) for a in out))
            return out
        return wrapped

    for tag, ws, sl in (("ref", jws, jslam), ("port", tws, tslam)):
        seen[tag] = dict(raycast=[])
        monkeypatch.setattr(sl, "MappingPipeline", recorder(tag))
        monkeypatch.setattr(ws, "raycast_scan",
                            recording(tag, ws.raycast_scan))
    jc, tc = _cfgs()
    kw = dict(n_scans=4, radius=5.0, with_imu=True, imu_substeps=10,
              n_rings=8, n_az=256)
    _, jgt = jws.run_mapping_drive(jws.make_world(np.random.default_rng(0)),
                                   jc, np.random.default_rng(1), **kw)
    _, tgt = tws.run_mapping_drive(tws.make_world(np.random.default_rng(0)),
                                   tc, np.random.default_rng(1), device=CPU,
                                   **kw)
    np.testing.assert_allclose(tgt, jgt, rtol=0, atol=1e-6)
    ref, port = seen["ref"], seen["port"]
    assert port["kwargs"]["device"] == CPU
    assert port["kwargs"]["imu_accel_noise"] == ref["kwargs"][
        "imu_accel_noise"]
    assert len(port["raycast"]) == len(ref["raycast"]) == 4
    for got, want in zip(port["raycast"], ref["raycast"]):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert len(port["scans"]) == len(ref["scans"]) == 4
    for (feats, imu), (jfeats, jimu_) in zip(port["scans"], ref["scans"]):
        for n in (1, 3):
            assert feats[n].sum() > 0
        for n in range(4):
            np.testing.assert_array_equal(feats[n], jfeats[n])
        assert sorted(imu) == sorted(jimu_)
        for k in imu:
            np.testing.assert_allclose(imu[k], jimu_[k], rtol=1e-5,
                                       atol=1e-5)
