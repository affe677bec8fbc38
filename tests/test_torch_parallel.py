"""Port parity of the multi-device code: the mesh and the process group
(``parallel/mesh.py``, ``parallel/multihost.py``), the graph solvers
with their normal equations summed over the ranks, and the batched
localizer sharded over a mesh.

One module fixture spawns one 2-rank gloo process group on the CPU
(``multihost.spawn``, with a timeout that kills the ranks) and runs every
check of tests/torch_parallel_worker.py in it, while this process
computes the JAX package's references: its ``shard_map`` over conftest's
8 virtual devices on test_parallel.py's problems (the chains of
``test_distributed_matches_single_device`` and
``test_distributed_cg_matches_single_device``, the IMU arc of
``test_distributed_imu_graph_matches_single_device``, their constraints
padded with zero-weight lanes to 16) and ``jax.vmap(localize_scan)`` on
test_torch_batch's bench scene at B = 4 (2 lanes per rank).

Tolerances:
- the sharded solves against the reference's 8-device ``shard_map`` (in
  float64) and against the port's one-process solve: within 1e-6 in
  float64 and within the reference's own 1e-3 in float32 (poses; the IMU
  graph's velocities 3e-3 and gyro bias 1e-5, test_parallel's); a
  sharded sum adds the same terms in another order, which moves the last
  bits. The
  CG solver runs 10 steps for these (ROADMAP §C12: past ~20 its iterates
  lose conjugacy and amplify rounding, in either library; the card's
  ``multi`` phase runs the distributed optimizer's default 50), the IMU
  graph 5 iterations (test_parallel's 10 take twice as long and run the
  same code);
- a second call with the same ranks gives the same bits (float32), and
  so do the two ranks;
- every lane of the sharded localizer: status and iterations equal to
  ``jax.vmap(localize_scan)``'s, the pose within 1e-4; equal to the
  lane's lone ``localize_scan`` bit for bit; ``gather_to_host`` gives
  the shards in rank order, bit for bit.
"""

import concurrent.futures
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

jax.config.update("jax_enable_x64", True)   # as in-suite (test_extraction)

import torch_parallel_worker  # noqa: E402
from torch_parity import np32, scatter_rows_case  # noqa: E402
from test_parallel import chain_graph  # noqa: E402
from test_torch_batch import JCFG, TCFG  # noqa: E402
from lidar_feature_extraction_tpu.core import quaternion as jq  # noqa: E402
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.core.scan import (  # noqa: E402
    RangeImage as JImage)
from lidar_feature_extraction_tpu.fusion import imu as jimu  # noqa: E402
from lidar_feature_extraction_tpu.ops import extraction as jex  # noqa: E402
from lidar_feature_extraction_tpu.parallel import imu_graph as jig  # noqa: E402
from lidar_feature_extraction_tpu.parallel import pose_graph as jpg  # noqa: E402
from lidar_feature_extraction_tpu.parallel.mesh import (  # noqa: E402
    make_mesh as j_make_mesh)
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    localization as jloc)
from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf  # noqa: E402
from lidar_feature_extraction_tpu_torch.parallel import (  # noqa: E402
    mesh as tmesh, multihost, pose_graph as tpg)
from lidar_feature_extraction_tpu_torch.utils.synthetic import (  # noqa: E402
    bench_scan, keyframe_copies)

RANKS = 2
PAD_TO = 8            # the reference's mesh
N_CG = 10
IMU_ITERATIONS = 5
LANES = 4
ATOL = {"float32": 1e-3, "float64": 1e-6}
VEL_ATOL32, BG_ATOL32 = 3e-3, 1e-5
T_ATOL = Q_ATOL = 1e-4
SPAWN_TIMEOUT_S = 240.0
F64 = "float64"
DTYPES = ("float32", F64)


def _padded_cons(cons):
    """Constraints as numpy, padded with zero-weight lanes to a multiple
    of the reference's 8 devices (test_parallel's padding)."""
    m = len(np.asarray(cons.i))
    pad = (-m) % PAD_TO
    return (np.r_[np.asarray(cons.i), np.zeros(pad)].astype(np.int32),
            np.r_[np.asarray(cons.j), np.ones(pad)].astype(np.int32),
            np32(np.r_[np32(cons.z_q), np.tile([[1.0, 0, 0, 0]], (pad, 1))]),
            np32(np.r_[np32(cons.z_t), np.zeros((pad, 3))]),
            np32(np.r_[np32(cons.weight), np.zeros(pad)]), None)


def _chain(seed, k):
    init, _, cons = chain_graph(np.random.default_rng(seed), k)
    return {"graph": (np32(init.poses_q), np32(init.poses_t)),
            "cons": _padded_cons(cons)}


def _imu_problem():
    """test_parallel's IMU arc: 13 keyframes, a gyro bias to recover,
    real bias Jacobians; 12 factors and chain constraints padded to 16."""
    n, dt, kf_every = 121, 0.05, 10
    speed, radius = 2.0, 20.0
    theta = speed * dt * np.arange(n) / radius
    t_true = np32(np.stack([radius * np.sin(theta),
                            radius * (1 - np.cos(theta)), np.zeros(n)], -1))
    q_true = np32(jax.vmap(jq.exp_so3)(jnp.asarray(np32(
        np.stack([0 * theta, 0 * theta, theta], -1)))))
    gyro, accel, dts, _ = jimu.synthesize_imu(jnp.asarray(q_true),
                                              jnp.asarray(t_true), dt)
    gyro = gyro + jnp.asarray(np32([0.01, -0.008, 0.02]))
    kf = list(range(0, n, kf_every))
    k, m = len(kf), len(kf) - 1
    pad = (-m) % PAD_TO
    zero = jnp.zeros(3, jnp.float32)
    pre_fn = jax.jit(jimu.preintegrate)
    pres = [pre_fn(gyro[a:b], accel[a:b], dts[a:b], zero, zero)
            for a, b in zip(kf[:-1], kf[1:])]
    rels = [JPose(jnp.asarray(q_true[a]), jnp.asarray(t_true[a])).inverse()
            .compose(JPose(jnp.asarray(q_true[b]), jnp.asarray(t_true[b])))
            for a, b in zip(kf[:-1], kf[1:])]
    w = jig.weights_from_covariance(jnp.stack([p.cov for p in pres]))

    def padded(rows, fill=0.0):
        x = np32(rows)
        return np32(np.concatenate(
            [x, np.full((pad,) + x.shape[1:], fill, np.float32)]))

    ident = np32(np.tile([[1.0, 0, 0, 0]], (pad, 1)))
    i = np.r_[np.arange(m), np.zeros(pad)].astype(np.int32)
    j = np.r_[np.arange(1, k), np.ones(pad)].astype(np.int32)
    cons = (i, j, np32(np.r_[np32([r.q for r in rels]), ident]),
            padded([r.t for r in rels]), padded(np.ones(m)),
            padded(np.tile(np.eye(6), (m, 1, 1))))
    stack = lambda name: padded([getattr(p, name) for p in pres])  # noqa: E731
    imu = (i, j, np32(np.r_[np32([p.dq for p in pres]), ident]),
           stack("dv"), stack("dp"), stack("dt"), padded(w[0]),
           padded(w[1]), padded(w[2]), padded(np.ones(m)), stack("dq_dbg"),
           stack("dv_dbg"), stack("dv_dba"), stack("dp_dbg"),
           stack("dp_dba"))
    v_init = np32(np.gradient(t_true[kf], axis=0) / (kf_every * dt))
    graph = (q_true[kf], t_true[kf], v_init, np32(np.zeros(3)), None)
    return {"graph": graph, "cons": cons, "imu": imu}


def _localizer_problem():
    """test_torch_batch's bench scene (8 x 256 rings, a map of 7 noisy
    keyframe copies) and 4 lanes: the scan moved and turned, each with its
    own prior error."""
    ex = JCFG.extraction
    r, p = ex.n_rings, ex.max_points_per_ring
    rng = np.random.default_rng(0)
    xyz = bench_scan(rng, r, p)
    mask, count = np.ones((r, p), bool), np.full(r, p, np.int32)
    f = jex.extract_features(JImage(jnp.asarray(xyz), jnp.asarray(mask),
                                    jnp.asarray(count)), ex)
    e = np32(keyframe_copies(rng, np32(f.edge_xyz)[np.asarray(f.edge_valid)]))
    s = np32(keyframe_copies(rng, np32(f.surface_xyz)[
        np.asarray(f.surface_valid)]))
    jmaps = jloc.build_geometry_maps(
        jnp.asarray(e), jnp.ones(len(e), bool), jnp.asarray(s),
        jnp.ones(len(s), bool), JCFG)
    yaw = np.radians([0.0, 0.5, -1.0, 0.8])
    turn = [np32(jq.quat_to_matrix(jnp.asarray(np32(
        [np.cos(a / 2), 0, 0, np.sin(a / 2)])))) for a in np.radians(
            [0.0, 0.0, 1.0, -0.7])]
    shift = np32([[0, 0, 0], [0.04, -0.03, 0], [0, 0, 0], [-0.03, 0.02, 0]])
    scans = np32([xyz @ turn[b].T + shift[b] for b in range(LANES)])
    q = np32([[np.cos(a / 2), 0, 0, np.sin(a / 2)] for a in yaw])
    t = np32([[0.3, -0.2, 0.05], [0.35, -0.1, 0.0], [0.2, -0.3, 0.1],
              [0.25, -0.25, 0.0]])
    masks, counts = np.stack([mask] * LANES), np.stack([count] * LANES)
    maps = (np32(jmaps.edge.rec), np32(jmaps.edge.voxel_size),
            np32(jmaps.edge.origin), jmaps.edge.dims,
            np32(jmaps.surface.rec), np32(jmaps.surface.voxel_size),
            np32(jmaps.surface.origin), jmaps.surface.dims)
    return ({"cfg": TCFG, "maps": maps, "images": (scans, masks, counts),
             "priors": (q, t)},
            (jmaps, JImage(jnp.asarray(scans), jnp.asarray(masks),
                           jnp.asarray(counts)),
             JPose(jnp.asarray(q), jnp.asarray(t))))


def _as(dtype, arrays):
    return [None if a is None else jnp.asarray(a, dtype)
            if np.asarray(a).dtype.kind == "f" else jnp.asarray(a)
            for a in arrays]


def _reference(inputs, loc_args):
    """The JAX package's sharded solves on 8 virtual devices, in float64
    (the float32 runs of the port are held to them at the float32
    tolerance), and its vmapped localizer, as numpy."""
    mesh = j_make_mesh(PAD_TO)
    rep, shd = NamedSharding(mesh, PartitionSpec()), NamedSharding(
        mesh, PartitionSpec("data"))
    spec = lambda tree: jax.tree.map(lambda _: PartitionSpec("data"), tree)  # noqa: E731

    def sharded(fn, graph, *parts):
        run = jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=(PartitionSpec(),) + tuple(
                spec(p) for p in parts), out_specs=PartitionSpec(),
            check_vma=False))
        return run(jax.device_put(graph, rep),
                   *(jax.device_put(p, shd) for p in parts))

    out = {}
    f64 = jnp.float64
    for case in ("dense", "cg"):
        graph = jpg.PoseGraph(*_as(f64, inputs[case]["graph"]))
        cons = jpg.Constraints(*_as(f64, inputs[case]["cons"][:5]))
        res = jpg.make_distributed_pose_graph_optimizer(
            mesh, graph.poses_q.shape[0])(graph, cons) if case == "dense" \
            else sharded(lambda g, c: jpg.optimize_pose_graph_cg(
                g, c, n_cg=N_CG, axis_name="data"), graph, cons)
        out[case] = np.concatenate([np.asarray(res.poses_q),
                                    np.asarray(res.poses_t)], -1)
    imu = inputs["imu"]
    res = sharded(lambda g, f, c: jig.optimize_imu_graph(
        g, c, f, n_iterations=IMU_ITERATIONS, axis_name="data"),
        jig.ImuGraph(*_as(f64, imu["graph"])),
        jig.ImuFactors(*_as(f64, imu["imu"])),
        jpg.Constraints(*_as(f64, imu["cons"])))
    out["imu"] = np.concatenate([
        np.asarray(res.poses_q).ravel(), np.asarray(res.poses_t).ravel(),
        np.asarray(res.vels).ravel(), np.asarray(res.bg)])
    batched = jax.vmap(partial(jloc.localize_scan, cfg=JCFG),
                       in_axes=(None, 0, 0))
    want, _ = batched(*loc_args)
    out["localizer"] = {"status": np.asarray(want.status),
                        "iterations": np.asarray(want.iterations),
                        "q": np.asarray(want.pose.q),
                        "t": np.asarray(want.pose.t)}
    return out


@pytest.fixture(scope="module")
def run():
    """The two ranks' results and the JAX references: the ranks start
    first, the inputs follow them through a queue, and the references
    are computed while the ranks run."""
    inbox = torch.multiprocessing.get_context("spawn").Queue()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(multihost.spawn, torch_parallel_worker.run_checks,
                            RANKS, inbox, SPAWN_TIMEOUT_S, backend="gloo",
                            timeout_s=SPAWN_TIMEOUT_S)
        inputs = None
        try:
            loc_inputs, loc_args = _localizer_problem()
            inputs = {"dense": _chain(2, 12), "cg": _chain(7, 16),
                      "imu": _imu_problem(), "localizer": loc_inputs,
                      "n_cg": N_CG, "imu_iterations": IMU_ITERATIONS}
        finally:
            for _ in range(RANKS):      # the ranks wait for these
                inbox.put(inputs)
        want = _reference(inputs, loc_args)
        got = ranks.result()
    return inputs, got, want


def test_ranks_read_the_environment_contract(run):
    _, got, _ = run
    for rank, out in enumerate(got):
        assert out["env"] == {"RANK": str(rank), "WORLD_SIZE": str(RANKS),
                              "LOCAL_RANK": str(rank)}
        assert (out["rank"], out["world"]) == (rank, RANKS)
        assert out["mesh"] == (RANKS, rank, "data")


def _imu_close(got, want, k, dtype):
    """The IMU graph's flattened (q, t, v, bg) within the tolerances."""
    if dtype == F64:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL[F64])
        return
    v, bg = 7 * k, 10 * k          # after q [k, 4] and t [k, 3]
    np.testing.assert_allclose(got[:v], want[:v], rtol=0, atol=ATOL[dtype])
    np.testing.assert_allclose(got[v:bg], want[v:bg], rtol=0,
                               atol=VEL_ATOL32)
    np.testing.assert_allclose(got[bg:], want[bg:], rtol=0, atol=BG_ATOL32)


@pytest.mark.parametrize("dtype", ["float32", F64])
@pytest.mark.parametrize("solver", ["dense", "cg", "imu"])
def test_sharded_solve_matches_reference_and_one_process(run, solver,
                                                         dtype):
    inputs, got, want = run
    single = got[DTYPES.index(dtype) % RANKS]    # the rank that solved it
    for out in got:
        if solver == "imu":
            k = len(inputs["imu"]["graph"][0])
            mine = out["imu", dtype]
            _imu_close(mine["imu"], want["imu"], k, dtype)
            _imu_close(mine["imu"], single["imu", dtype]["imu_single"], k,
                       dtype)
            continue
        mine = out[solver, dtype]
        np.testing.assert_allclose(mine[solver], want[solver], rtol=0,
                                   atol=ATOL[dtype])
        np.testing.assert_allclose(
            mine[solver], single[solver, dtype][solver + "_single"], rtol=0,
            atol=ATOL[dtype])


def test_sharded_solves_repeat_and_agree_across_ranks(run):
    _, got, _ = run
    for out in got:
        flags = [v for key, res in out.items() if isinstance(key, tuple)
                 for name, v in res.items() if name.endswith("_repeats")
                 and v is not None]
        assert len(flags) == 3 and all(flags), flags
    for key, res in got[0].items():
        if isinstance(key, tuple):
            for name, v in res.items():
                if not name.endswith(("_repeats", "_single")) \
                        and v is not None:
                    np.testing.assert_array_equal(v, got[1][key][name])


def test_sharded_localizer_matches_vmapped_reference_and_lone_runs(run):
    _, got, want = run
    w = want["localizer"]
    assert len(set(w["iterations"].tolist())) > 1, w["iterations"]
    per = LANES // RANKS
    for rank, out in enumerate(got):
        loc = out["localizer"]
        sl = slice(rank * per, (rank + 1) * per)
        np.testing.assert_array_equal(loc["shard"]["status"], w["status"][sl])
        np.testing.assert_array_equal(loc["shard"]["iterations"],
                                      w["iterations"][sl])
        np.testing.assert_allclose(loc["shard"]["t"], np32(w["t"][sl]),
                                   rtol=0, atol=T_ATOL)
        np.testing.assert_allclose(loc["shard"]["q"], np32(w["q"][sl]),
                                   rtol=0, atol=Q_ATOL)
        for name in ("status", "iterations", "q", "t"):
            np.testing.assert_array_equal(loc["shard"][name],
                                          loc["lone"][name])


def test_gather_to_host_assembles_the_shards_in_rank_order(run):
    _, got, _ = run
    names = ("status", "iterations", "q", "t")
    for out in got:
        for n, name in enumerate(names):
            whole = np.concatenate([o["localizer"]["shard"][name]
                                    for o in got])
            np.testing.assert_array_equal(out["localizer"]["gathered"][n],
                                          whole)
            assert out["localizer"]["gathered"][n].dtype == whole.dtype


@pytest.mark.parametrize("what", ["odd_constraints_raise",
                                  "differing_trees_raise",
                                  "unequal_shards_raise", "odd_batch_raises"])
def test_misuse_raises_on_every_rank(run, what):
    _, got, _ = run
    for out in got:
        flag = out["localizer"][what] if what == "odd_batch_raises" \
            else out[what]
        assert flag, what


# ---- in this process: no group ------------------------------------------

class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, backend, **kw):
        self.calls.append((backend, kw))


_ENV = {"MASTER_ADDR": "10.0.0.7", "MASTER_PORT": "29511",
        "WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1"}


@pytest.mark.parametrize("case", ["no_world", "env", "explicit_wins",
                                  "unavailable_backend"])
def test_initialize_reads_the_environment_contract(monkeypatch, case):
    rec = _Recorder()
    monkeypatch.setattr(multihost.dist, "init_process_group", rec)
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    if case == "no_world":
        assert multihost.initialize(backend="gloo") is False
        assert rec.calls == []
        return
    for k, v in _ENV.items():
        monkeypatch.setenv(k, v)
    if case == "unavailable_backend":
        # No NCCL in a CPU build of torch: raise, never another backend.
        monkeypatch.setattr(multihost.dist, "is_backend_available",
                            lambda b: b != "nccl")
        with pytest.raises(RuntimeError, match="nccl"):
            multihost.initialize(backend="nccl")
        assert rec.calls == []
        return
    kw = {} if case == "env" else dict(
        coordinator_address="localhost:1234", num_processes=2, process_id=0)
    assert multihost.initialize(backend="gloo", timeout_s=12.0, **kw)
    (backend, call), = rec.calls
    assert backend == "gloo"
    assert call["timeout"].total_seconds() == 12.0
    if case == "env":
        assert call["init_method"] == "tcp://10.0.0.7:29511"
        assert (call["world_size"], call["rank"]) == (4, 3)
    else:
        assert call["init_method"] == "tcp://localhost:1234"
        assert (call["world_size"], call["rank"]) == (2, 0)


def test_one_rank_mesh_without_a_group():
    """No process group: a one-rank mesh whose collectives are the
    identity, and the distributed optimizer is the plain solver."""
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.rank) == (None, 1, 0)
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, device="cpu")
    x = (torch.arange(6.0).reshape(3, 2), torch.tensor([True, False, True]))
    for a, b in zip(multihost.gather_to_host(mesh, x), x):
        assert torch.equal(a, b)
    assert multihost.replicate_to_global(mesh, x)[0] is not None
    inp = _chain(2, 12)
    graph = tpg.PoseGraph(*(torch.as_tensor(a) for a in inp["graph"]))
    cons = tpg.Constraints(*(None if a is None else torch.as_tensor(a)
                             for a in inp["cons"]))
    got = tpg.make_distributed_pose_graph_optimizer(mesh, 12)(graph, cons)
    want = tpg.optimize_pose_graph(graph, cons._replace(
        info=torch.eye(6).expand(len(cons.i), 6, 6)))
    assert torch.equal(got.poses_t, want.poses_t)


@pytest.mark.parametrize("n", [3, 5])
def test_a_batch_that_does_not_divide_raises(n):
    mesh = tmesh.Mesh(group=None, axis="data", size=2, rank=1,
                      device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(mesh, torch.zeros(n, 3))
    assert tmesh.shard_range(mesh, n + 1) == slice((n + 1) // 2, n + 1)


def test_normal_equations_scatter_repeats_on_a_large_graph():
    """ROADMAP §C16 on the CPU: a graph whose block scatter is large
    enough for ``index_put(accumulate=True)`` to split it between threads
    (2,000 constraints x 36 entries per block, past torch's 32,768-element
    grain) gives the same bits on a second call, and the bits of a
    scatter in index order (``np.add.at``)."""
    rng = np.random.default_rng(11)
    k, m = 300, 2000
    i = rng.integers(0, k, m).astype(np.int64)
    j = (i + rng.integers(1, k, m)) % k
    r = torch.as_tensor(np32(rng.normal(size=(m, 6))))
    ji, jj, wji, wjj = (torch.as_tensor(np32(rng.normal(size=(m, 6, 6))))
                        for _ in range(4))
    args = (torch.as_tensor(i), torch.as_tensor(j), r, ji, jj, wji, wjj, 6)
    zeros = lambda: (torch.zeros(6 * k, 6 * k), torch.zeros(6 * k))  # noqa: E731
    h1, g1 = tpg.scatter_normal_equations(*zeros(), *args)
    h2, g2 = tpg.scatter_normal_equations(*zeros(), *args)
    assert torch.equal(h1, h2) and torch.equal(g1, g2)
    want = np.zeros(6 * k * 6 * k, np.float32)
    ar = np.arange(6)
    # The blocks in the reference's float32 form (in-order FMA chains,
    # ROADMAP §C23), then added in index order.
    wti, wtj = wji.transpose(1, 2), wjj.transpose(1, 2)
    for bi, bj, blocks in (
            (i, i, xf.matmul(wti, ji)),
            (i, j, xf.matmul(wti, jj)),
            (j, i, xf.matmul(wti, jj).transpose(1, 2)),
            (j, j, xf.matmul(wtj, jj))):
        rows = (bi[:, None] * 6 + ar)[:, :, None]
        cols = (bj[:, None] * 6 + ar)[:, None, :]
        np.add.at(want, (rows * 6 * k + cols).reshape(-1),
                  blocks.numpy().reshape(-1))
    np.testing.assert_array_equal(h1.numpy().reshape(-1), want)


@pytest.mark.parametrize("width", [1, 6, 9, 32, 33, 36])
def test_index_add_rows_in_order_adds_each_destination_in_turn(width):
    """The block scatter of the normal equations: each destination's
    rows added in ``src``'s order, ``((out + s_1) + s_2) + ...``, at the
    row widths of g (6, the IMU graph's 9) and of the blocks (36), and
    about torch's 32-value threshold between its CUDA ``index_put``
    kernels; summing a destination's rows first would give other bits."""
    from lidar_feature_extraction_tpu_torch.ops.scatter import (
        index_add_rows_in_order)

    out, index, src, want = scatter_rows_case(width)
    got = index_add_rows_in_order(torch.as_tensor(out),
                                  torch.as_tensor(index),
                                  torch.as_tensor(src))
    np.testing.assert_array_equal(got.numpy(), want)
    summed = out.copy()
    for dst in range(out.shape[0]):
        summed[dst] += src[index == dst].sum(0, dtype=np.float32)
    assert not np.array_equal(summed, want)

