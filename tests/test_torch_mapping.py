"""The port's mapper against the mapping record
(``tests/data/torch_reference_mapping.npz``, written from the JAX package
by ``tests/torch_reference_record.py --mapping``; ``reference_cases.py``
reads it) and the back end's float32 forms against the reference's
jitted programs, all at tolerance 0.

- The odometry chain (bench_odometry.py's 100 extracted-feature frames
  at ``kitti_hdl64()`` widths): the constant-velocity prior of every
  frame from the record's poses (``odometry.chained_prior``), and the
  port's chain over the first frames (ray cast, K1's plain version,
  ``geometry_odometry_step``): status, iterations, prior and pose bit
  for bit.
- slam_loop (eval_ate.py's 80 scans): the port's pipeline over the first
  scans from the record's generator state: odometry poses, keyframes and
  constraints (relative poses, weights, 6x6 information) bit for bit
  (``reference_cases.mapping_gaps``). Its first ``optimize()`` comes at
  scan 14, ~45 s of CPU at full width; chip_smoke's ``slam`` phase holds
  all 80 scans on the card.
- The pose graph (ROADMAP §C23, repaired): held to the program the
  mapper runs, the reference's eager ``optimize_pose_graph`` loop, at
  slam_loop's graphs (``reference_cases.slam_graph``) through the
  graduated schedule, every stage's poses; every iteration's residual and
  Jacobians and pose update against the values inside that loop (read
  through ``jax.debug.callback``, which leaves its results as they were);
  the residual against ``jax.jit(jax.vmap(constraint_residual))``; H and
  g against a jitted step; the dense solve (``fusion/kalman.py``'s
  ``lu_factor`` / ``lu_solve``) against ``jax.jit(jnp.linalg.solve)`` at
  6K = 48 to 768.
- OpenBLAS's own halves, which the reference's solve reaches: ``lu_factor``
  against ``scipy.linalg.lu_factor`` (factors and pivots) and ``lu_solve``
  on those factors against ``scipy.linalg.blas.strsm``. scipy's wheel and
  jaxlib share one OpenBLAS, whose order depends on its thread count:
  every reference call runs with it pinned to ``kalman.OPENBLAS_THREADS``
  (``_openblas_threads``), whatever the machine's core count. The float32
  form of the smallest systems (n <= 3, the EKF's) is held in
  test_torch_drive.py.
"""

import contextlib
import ctypes
import functools
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402  (numpy only at import)
import reference_cases as rc  # noqa: E402
from torch_parity import to_np  # noqa: E402  (two torch threads)
from lidar_feature_extraction_tpu.parallel import pose_graph as jpg  # noqa: E402
from lidar_feature_extraction_tpu_torch.config import kitti_hdl64  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.fusion import kalman  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import lu_cuda  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops.extraction import (  # noqa: E402
    extract_features)
from lidar_feature_extraction_tpu_torch.parallel import pose_graph as tpg  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import odometry as todo  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import slam as tslam  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline.replay import (  # noqa: E402
    scan_range_image)
from lidar_feature_extraction_tpu_torch.utils import worldsim  # noqa: E402

CPU = "cpu"
ODOM_PREFIX = 3          # frames of the chain run here
SLAM_PREFIX = 3          # scans of slam_loop run here (keyframes 0, 2)


@pytest.fixture(scope="module")
def record():
    return rc.load_mapping()


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(to_np(a), dtype=np.float32).view(np.int32)


def test_chained_prior_matches_the_record(record):
    """Every frame's prior from the recorded poses: the state's pose is
    the identity before frame 1, then each frame's registered pose."""
    arrays, _ = record
    q = torch.as_tensor(arrays["odometry.pose_q"]).clone()
    t = torch.as_tensor(arrays["odometry.pose_t"]).clone()
    q[0] = torch.tensor([1.0, 0.0, 0.0, 0.0])
    t[0] = 0.0
    prior = todo.chained_prior(Pose(q[1:-1], t[1:-1]), Pose(q[:-2], t[:-2]))
    np.testing.assert_array_equal(_bits(prior.q),
                                  _bits(arrays["odometry.prior_q"][2:]))
    np.testing.assert_array_equal(_bits(prior.t),
                                  _bits(arrays["odometry.prior_t"][2:]))


def test_odometry_chain_prefix_matches_the_record(record):
    arrays, _ = record
    cfg = kitti_hdl64()
    rng = np.random.default_rng(0)
    world = worldsim.make_world(rng, n_poles=50, extent=60.0)
    state = todo.init_geometry_odometry(cfg, device=CPU)
    prev = Pose(state.pose_q, state.pose_t)
    got = {k: [] for k in ("status", "iterations", "pose_q", "pose_t")}
    for i in range(ODOM_PREFIX):
        pts, ring = worldsim.raycast_scan(
            world, worldsim.straight_drive(i), rng, n_rings=64, n_az=2048,
            elev_deg=(2.0, -24.8))
        f = extract_features(scan_range_image(pts, ring, cfg, CPU),
                             cfg.extraction)
        cur = Pose(state.pose_q, state.pose_t)
        prior = todo.chained_prior(cur, prev)
        np.testing.assert_array_equal(_bits(prior.t),
                                      _bits(arrays["odometry.prior_t"][i]))
        state, res = todo.geometry_odometry_step(
            state, f.edge_xyz, f.edge_valid, f.surface_xyz, f.surface_valid,
            cfg, prior_q=prior.q, prior_t=prior.t)
        prev = cur
        for k, v in (("status", res.status), ("iterations", res.iterations),
                     ("pose_q", res.pose.q), ("pose_t", res.pose.t)):
            got[k].append(to_np(v))
    gaps = rc.odometry_gaps({k: np.stack(v) for k, v in got.items()},
                            arrays, ODOM_PREFIX)
    assert gaps["first_frame_that_differs"] is None, gaps


def test_slam_loop_prefix_matches_the_record(record, monkeypatch):
    arrays, manifest = record
    rng = np.random.default_rng()
    rng.bit_generator.state = manifest["slam"]["rng_state"]
    world = worldsim.make_world(np.random.default_rng(0), n_poles=50,
                                extent=35.0)
    rec = rc.MappingRecorder(stop_after=SLAM_PREFIX)
    monkeypatch.setattr(tslam, "MappingPipeline",
                        rec.recording(tslam.MappingPipeline))
    with pytest.raises(StopIteration):
        worldsim.run_mapping_drive(world, kitti_hdl64(), rng, device=CPU,
                                   **rc.SLAM_DRIVE)
    assert rec.features == manifest["slam"]["features_sha256"][:SLAM_PREFIX]
    fields = rec.fields(rec.pipeline)
    gaps = rc.mapping_gaps(fields, arrays)
    assert gaps["scans"] == SLAM_PREFIX
    assert gaps["first_scan_that_differs"] is None, gaps
    assert gaps["keyframes_equal"] and len(fields["keyframe_scans"]) == 2
    assert gaps["constraints"] == 1 and gaps["constraints_equal"], gaps


def test_mapping_gaps_find_the_first_difference(record):
    """The rule on the record itself (no difference), then with one bit
    of scan 17's odometry pose and of the third graph flipped."""
    arrays, _ = record
    fields = {k[5:]: v.copy() for k, v in arrays.items()
              if k.startswith("slam.")}
    same = rc.mapping_gaps(fields, arrays)
    assert same["first_scan_that_differs"] is None
    assert same["first_optimize_that_differs"] is None
    assert same["keyframes_equal"] and same["constraints_equal"]
    assert same["optimize_calls"] == len(arrays["slam.opt_scan"])
    fields["odom_t"][17, 1] = np.nextafter(fields["odom_t"][17, 1],
                                           np.float32(np.inf))
    lo = int(arrays["slam.opt_keyframes"][:2].sum())
    fields["opt_q"][lo + 3, 0] = np.nextafter(fields["opt_q"][lo + 3, 0],
                                              np.float32(0))
    fields["cons_j"] = fields["cons_j"].copy()
    fields["rel_t"][5, 2] += 1e-3
    moved = rc.mapping_gaps(fields, arrays)
    assert moved["first_scan_that_differs"] == 17
    assert moved["first_optimize_that_differs"] == 2
    assert not moved["constraints_equal"]
    gaps = rc.odometry_gaps({k: arrays[f"odometry.{k}"] for k in (
        "status", "iterations", "pose_q", "pose_t")}, arrays)
    assert gaps["first_frame_that_differs"] is None
    assert json.loads(json.dumps(gaps)) == gaps


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 17, 31, 48, 240, 384, 768])
def test_trsm_blocks_cover_the_rows(n):
    blocks = kalman.trsm_blocks(n)
    assert [lo for lo, _ in blocks] == [0] + [hi for _, hi in blocks[:-1]]
    assert blocks[-1][1] == n
    sizes = [hi - lo for lo, hi in blocks]
    full = n // kalman.TRSM_ROWS
    assert sizes[:full] == [kalman.TRSM_ROWS] * full
    assert sizes[full:] == sorted(sizes[full:], reverse=True)
    assert sum(sizes[full:]) == n % kalman.TRSM_ROWS


def _system(n: int, kind: str):
    """chip_smoke's seeded system of order ``n`` (float32 numpy)."""
    return tuple(to_np(x) for x in chip_smoke.lu_system(n, kind, CPU))


@pytest.mark.parametrize("n", [6, 48, 96])
def test_lu_solve_plain_solves_and_batches(n):
    """The plain version solves (against float64 LAPACK, within float32
    rounding of a well-conditioned system) and a batch's systems equal
    their lone solves bit for bit."""
    systems = [_system(n + k, "random")[0][:n, :n] for k in range(3)]
    systems = [(a, _system(n, "random")[1] * (k + 1))
               for k, a in enumerate(systems)]
    a = torch.as_tensor(np.stack([s[0] for s in systems]))
    b = torch.as_tensor(np.stack([s[1] for s in systems]))
    got = lu_cuda.solve(a, b)
    for k, (ak, bk) in enumerate(systems):
        lone = lu_cuda.solve(torch.as_tensor(ak), torch.as_tensor(bk))
        np.testing.assert_array_equal(_bits(got[k]), _bits(lone))
        want = np.linalg.solve(np.float64(ak), np.float64(bk))
        resid = np.float64(ak) @ to_np(lone).astype(np.float64) \
            - np.float64(bk)
        assert np.abs(resid).max() < 1e-3 * max(1.0, np.abs(want).max())
    # Several right-hand sides: each column as alone.
    rhs = torch.stack([b[0], -b[0]], dim=1)
    cols = kalman.lu_solve(*kalman.lu_factor(a[0]), rhs)
    np.testing.assert_array_equal(_bits(cols[:, 0]), _bits(got[0]))


@functools.cache
def _openblas() -> ctypes.CDLL:
    """The OpenBLAS of scipy's wheel (``scipy.libs``), which jaxlib's
    LAPACK calls reach too."""
    import scipy

    libs = Path(scipy.__file__).resolve().parent.parent / "scipy.libs"
    lib = ctypes.CDLL(str(next(libs.glob("libscipy_openblas-*.so"))))
    lib.scipy_openblas_get_num_threads.restype = ctypes.c_int
    lib.scipy_openblas_set_num_threads.argtypes = [ctypes.c_int]
    return lib


@contextlib.contextmanager
def _openblas_threads(threads: int = kalman.OPENBLAS_THREADS):
    """OpenBLAS pinned to ``threads`` threads, then restored: its sgetrf
    orders the sums by its thread count (``kalman.sgetrf_threads``)."""
    lib = _openblas()
    old = lib.scipy_openblas_get_num_threads()
    lib.scipy_openblas_set_num_threads(threads)
    try:
        yield
    finally:
        lib.scipy_openblas_set_num_threads(old)


def _lu_case(n: int, kind: str) -> np.ndarray:
    """A seeded float32 [n, n]: chip_smoke's pose-graph-shaped (``posegraph``,
    its ``spd``), random, ties and singular systems, or ``spd`` (m m^T / n
    + I, no row swaps)."""
    if kind == "spd":
        m = np.random.default_rng(n).normal(size=(n, n))
        return np.float32(m @ m.T / n + np.eye(n))
    return _system(n, "spd" if kind == "posegraph" else kind)[0]


def _permutation(piv: np.ndarray) -> np.ndarray:
    """LAPACK's sequential row swaps as the permutation they make."""
    perm = np.arange(len(piv))
    for i, p in enumerate(piv):
        perm[[i, p]] = perm[[p, i]]
    return perm


# A pose-graph-shaped system has the 6 x 6 gauge prior: n >= 6.
_LU_FACTOR_CASES = [
    (n, kind)
    for n in (2, 3, 4, 8, 16, 17, 32, 48, 96, 99, 100, 101, 192, 384, 768)
    for kind in ("random", "spd", "posegraph", "ties", "singular")
    if n >= 6 or kind != "posegraph"]


@pytest.mark.parametrize("n,kind", _LU_FACTOR_CASES,
                         ids=[f"{n}-{k}" for n, k in _LU_FACTOR_CASES])
def test_lu_factor_is_openblas_sgetrf(n, kind):
    """``kalman.lu_factor`` equals OpenBLAS's sgetrf at 8 threads
    (``scipy.linalg.lu_factor`` in float32): factors and pivots bit for
    bit, across getf2 (n <= 17), the single-threaded recursion and the
    threaded path (3 threads at 384, 8 at 768)."""
    import scipy.linalg

    a = _lu_case(n, kind)
    with _openblas_threads(), warnings.catch_warnings():
        warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
        want, piv = scipy.linalg.lu_factor(a, check_finite=False)
    lu, perm = kalman.lu_factor(torch.as_tensor(a))
    np.testing.assert_array_equal(_bits(lu), want.view(np.int32))
    np.testing.assert_array_equal(to_np(perm), _permutation(piv))


@pytest.mark.parametrize("kind", ["random", "posegraph", "singular"])
@pytest.mark.parametrize("n", [17, 48, 101, 384, 768])
def test_lu_solve_is_openblas_strsm(n, kind):
    """``kalman.lu_solve`` on OpenBLAS's own factors equals its two strsm
    calls (unit lower, then upper; at 768 strsm's blocks of GEMM_Q rows)
    bit for bit, a NaN against any NaN."""
    import scipy.linalg
    from scipy.linalg.blas import strsm

    a = _lu_case(n, kind)
    b = _system(n, "random")[1]
    with _openblas_threads(), warnings.catch_warnings():
        warnings.simplefilter("ignore", scipy.linalg.LinAlgWarning)
        lu, piv = scipy.linalg.lu_factor(a, check_finite=False)
        perm = _permutation(piv)
        y = strsm(1.0, lu, b[perm][:, None].copy(), lower=1, diag=1)
        want = strsm(1.0, lu, y, lower=0)[:, 0]
    got = to_np(kalman.lu_solve(torch.as_tensor(lu), torch.as_tensor(perm),
                                torch.as_tensor(b)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(got)
    np.testing.assert_array_equal(got[finite].view(np.int32),
                                  want[finite].view(np.int32))


@pytest.mark.parametrize("kind", ["random", "spd"])
@pytest.mark.parametrize("keyframes", [8, 16, 32, 64, 128])
def test_lu_matches_jitted_jnp_solve(keyframes, kind):
    """The port's float32 solve (``lu_cuda.solve`` on the CPU: the plain
    version) equals jitted ``jnp.linalg.solve`` bit for bit at slam_loop's
    keyframe buckets and the dense solver's most keyframes."""
    a, b = _system(6 * keyframes, kind)
    with _openblas_threads():
        want = np.asarray(jax.jit(jnp.linalg.solve)(jnp.asarray(a),
                                                     jnp.asarray(b)))
    got = lu_cuda.solve(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))


def test_openblas_pin_moves_the_reference():
    """The pin reaches jitted jnp.linalg.solve: at 384 (threaded from two
    threads) one and 8 threads differ, and the plan follows each."""
    a, b = _system(384, "random")
    solve = jax.jit(jnp.linalg.solve)
    outs = {}
    for threads in (1, kalman.OPENBLAS_THREADS):
        with _openblas_threads(threads):
            outs[threads] = np.asarray(solve(jnp.asarray(a),
                                             jnp.asarray(b))).copy()
    assert not np.array_equal(outs[1].view(np.int32),
                              outs[kalman.OPENBLAS_THREADS].view(np.int32))
    assert kalman.sgetrf_threads(384, 1) == 1
    assert kalman.sgetrf_threads(384) == 3
    assert kalman.sgetrf_threads(768) == 8
    assert kalman.sgetrf_threads(199) == 1
    assert kalman.lu_plan(384, 1) != kalman.lu_plan(384)


def _graph_inputs(m: int = 8, seed: int = 4):
    """Poses around a circle with measured relative poses that disagree
    with them by a few centimetres and milliradians (float32)."""
    rng = np.random.default_rng(seed)
    yaw = rng.uniform(-np.pi, np.pi, size=(2, m))
    q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    q[..., 1:3] += rng.normal(scale=0.02, size=(2, m, 2))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(scale=10.0, size=(2, m, 3))
    zq = q[1] + rng.normal(scale=0.01, size=(m, 4))
    zq /= np.linalg.norm(zq, axis=-1, keepdims=True)
    zt = t[1] - t[0] + rng.normal(scale=0.05, size=(m, 3))
    return [np.float32(x) for x in (q[0], t[0], q[1], t[1], zq, zt)]


def _graph(k: int = 8, seed: int = 6):
    """A float32 pose graph of ``k`` poses and its constraints (the
    chain, three loops, a zero-weight lane), each with a 6x6 information
    matrix, in both packages' types."""
    rng = np.random.default_rng(seed)
    yaw = np.linspace(0, 2 * np.pi, k, endpoint=False)
    q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    q[:, 1:3] += rng.normal(scale=0.01, size=(k, 2))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np.stack([5 * np.cos(yaw), 5 * np.sin(yaw), 0 * yaw], -1) \
        + rng.normal(scale=0.05, size=(k, 3))
    i = np.int32(list(range(k - 1)) + [0, 1, 2, 0])
    j = np.int32(list(range(1, k)) + [5, 6, 7, 1])
    z_q, z_t = [], []
    for a, b in zip(i, j):
        qa = q[a] * [1, -1, -1, -1]
        z_q.append(np.asarray(jq_mul(qa, q[b])) + rng.normal(scale=0.005,
                                                             size=4))
        z_t.append(rng.normal(scale=0.05, size=3) + np.asarray(
            jq_rot(qa, t[b] - t[a])))
    z_q = np.stack(z_q)
    z_q /= np.linalg.norm(z_q, axis=-1, keepdims=True)
    m = len(i)
    weight = np.ones(m)
    weight[-1] = 0.0
    weight[k - 1] = 0.8
    g6 = rng.normal(size=(m, 6, 6))
    info = g6 @ np.swapaxes(g6, 1, 2) / 6 + np.eye(6)
    arrays = [np.float32(a) for a in (q, t, z_q, np.stack(z_t), weight, info)]
    jgraph = jpg.PoseGraph(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))
    jcons = jpg.Constraints(jnp.asarray(i), jnp.asarray(j),
                            *map(jnp.asarray, arrays[2:]))
    tgraph = tpg.PoseGraph(*map(torch.as_tensor, arrays[:2]))
    tcons = tpg.Constraints(torch.as_tensor(i), torch.as_tensor(j),
                            *map(torch.as_tensor, arrays[2:]))
    return jgraph, jcons, tgraph, tcons


def jq_mul(a, b):
    from lidar_feature_extraction_tpu.core import quaternion as jq
    return jq.quat_multiply(jnp.asarray(a), jnp.asarray(b))


def jq_rot(q, p):
    from lidar_feature_extraction_tpu.core import quaternion as jq
    return jq.quat_rotate(jnp.asarray(q), jnp.asarray(p))


def _record_graph(record, ka: int):
    """``reference_cases.slam_graph`` in both packages' types."""
    (q, t), cons = rc.slam_graph(record[0], ka)
    return (jpg.PoseGraph(jnp.asarray(q), jnp.asarray(t)),
            jpg.Constraints(*map(jnp.asarray, cons)),
            tpg.PoseGraph(torch.as_tensor(q), torch.as_tensor(t)),
            tpg.Constraints(*map(torch.as_tensor, cons)))


def _recorded_calls(name, flatten, jgraph, jcons, **kw):
    """The reference's optimizer run eagerly, as the mapper calls it,
    with its function ``name`` wrapped in a ``jax.debug.callback`` that
    records each call's inputs (``flatten(*args)``) and outputs, and
    the final graphs of the same call without and with the wrapper."""
    seen = []
    original = getattr(jpg, name)

    def recorded(*args):
        out = original(*args)
        jax.debug.callback(lambda *v: seen.append([np.asarray(x) for x in v]),
                           *flatten(*args), *out)
        return out

    with _openblas_threads():
        plain = jpg.optimize_pose_graph(jgraph, jcons, **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpg, name, recorded)
            wrapped = jpg.optimize_pose_graph(jgraph, jcons, **kw)
    return seen, plain, wrapped


@pytest.mark.parametrize("delta", [None, 8.0, 0.5])
def test_normal_equations_and_update_match_the_reference_program(delta):
    """§C23's normal equations and update (repaired): fed the reference's
    own linearization, the port's H and g equal the reference's bit for
    bit (the blocks as in-order FMA chains, scattered onto the gauge
    prior and damping: XLA folds the reference's ``h + diag`` into the
    scatter); and the port's pose update equals every update in the
    reference's optimizer loop (read through ``jax.debug.callback``),
    whose vectorized loops over the poses round otherwise than a
    standalone jit of it."""
    jgraph, jcons, tgraph, tcons = _graph()
    k = jgraph.poses_q.shape[0]

    def step(graph, cons):
        lin = jpg._linearize(graph.poses_q[cons.i], graph.poses_t[cons.i],
                             graph.poses_q[cons.j], graph.poses_t[cons.j],
                             cons.z_q, cons.z_t)
        h, g = jpg._local_normal_equations(graph, cons, k,
                                           robust_delta=delta)
        prior = jnp.zeros(6 * k, h.dtype).at[:6].set(1e6)
        h = h + jnp.diag(prior + 1e-6)
        return (*lin, h, g)

    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.jit(step)(jgraph, jcons))]
    r, ji, jj, h, g = want
    prior = torch.zeros(6 * k)
    prior[:6] = 1e6
    got_h, got_g = tpg._normal_equations(
        tcons, *map(torch.as_tensor, (r, ji, jj)),
        torch.diag(prior + 1e-6), delta)
    np.testing.assert_array_equal(_bits(got_h), h.view(np.int32))
    np.testing.assert_array_equal(_bits(got_g), g.view(np.int32))
    seen, plain, wrapped = _recorded_calls(
        "_apply_update", lambda graph, dx: (*graph, dx), jgraph, jcons,
        n_iterations=3, robust_delta=delta)
    for a, b in zip(plain, wrapped):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert len(seen) == 3
    for q, t, dx, up_q, up_t in seen:
        up = tpg._apply_update(tpg.PoseGraph(torch.as_tensor(q),
                                             torch.as_tensor(t)),
                               torch.as_tensor(dx))
        np.testing.assert_array_equal(_bits(up.poses_q), up_q.view(np.int32))
        np.testing.assert_array_equal(_bits(up.poses_t), up_t.view(np.int32))



@pytest.mark.parametrize("ka,delta,iterations", [
    (8, 8.0, 3), (16, 2.0, 3), (24, 0.5, 4), (40, 0.5, 4)])
def test_linearization_matches_jitted_jacfwd(record, ka, delta, iterations):
    """§C23.1 (repaired): the residual and both Jacobians of every
    iteration equal the values in the reference's optimizer program,
    the loop that ``MappingPipeline.optimize`` runs (a standalone
    ``jax.jit(_linearize)`` is another program: its tangent basis is a
    constant that XLA folds, where the loop keeps it as an input, and a
    few Jacobian entries round otherwise). The values are read through
    ``jax.debug.callback``, which leaves the program's results as they
    were."""
    jgraph, jcons, _, _ = _record_graph(record, ka)
    seen, plain, wrapped = _recorded_calls(
        "_linearize", lambda *args: args, jgraph, jcons,
        n_iterations=iterations, robust_delta=delta)
    for a, b in zip(plain, wrapped):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert len(seen) == iterations
    for values in seen:
        got = tpg._linearize(*map(torch.as_tensor, values[:6]))
        for g, w in zip(got, values[6:]):
            np.testing.assert_array_equal(_bits(g), w.view(np.int32))


@pytest.mark.parametrize("m,seed", [(8, 4), (19, 5), (64, 6)])
def test_residual_matches_jitted_constraint_residual(m, seed):
    """The residual's float32 forms (the error quaternion's nested
    product, both rotations, the logarithm) against
    ``jax.jit(jax.vmap(constraint_residual))``."""
    args = _graph_inputs(m, seed)
    want = jax.jit(jax.vmap(jpg.constraint_residual))(
        *map(jnp.asarray, args))
    got = tpg.constraint_residual(*map(torch.as_tensor, args))
    np.testing.assert_array_equal(_bits(got), np.asarray(want).view(np.int32))


@pytest.mark.parametrize("ka", rc.SLAM_GRAPH_KEYFRAMES)
def test_optimizer_matches_the_reference_program(record, ka):
    """The dense Gauss-Newton over slam_loop's graphs (the record's
    constraints, weights and 6x6 information on the keyframes' odometry
    poses, at the pipeline's shape buckets) through the graduated
    schedule ``MappingPipeline.optimize`` runs (delta 8.0, 2.0, 0.5 for
    3, 3, 4 iterations), each stage's poses bit for bit against the
    reference's eager ``optimize_pose_graph`` with OpenBLAS pinned."""
    jgraph, jcons, tgraph, tcons = _record_graph(record, ka)
    for delta, iterations in tslam.MappingPipeline._gnc_schedule(0.5, 10):
        with _openblas_threads():
            jgraph = jpg.optimize_pose_graph(jgraph, jcons,
                                             n_iterations=iterations,
                                             robust_delta=delta)
        tgraph = tpg.optimize_pose_graph(tgraph, tcons,
                                         n_iterations=iterations,
                                         robust_delta=delta)
        for g, w in zip(tgraph, jgraph):
            np.testing.assert_array_equal(_bits(g), _bits(w))
