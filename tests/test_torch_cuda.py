"""Kernel K1 and the Gauss-Newton step's kernels (normal_equations,
robust_weights, gn_update; bit for bit, NaN against NaN) on the card
against their plain PyTorch versions, and the paths
that run it (full extraction, one closed-loop scan, the odometry step,
IMU preintegration, the pose-graph and IMU-graph solvers, a short
mapping run with a loop closure, K1 at vlp16's widths against the CPU
and the full-width reference record, the chunked front end's one launch
per block, the batched localizer on every branch, the voxel-hash map)
against the CPU, their lone runs or the per-scan pipeline; and every
float scatter-add of the port giving the same bits on two calls (ROADMAP
§C16).

fma_f32 on chip_smoke's layouts and its random and edge triples, bit for
bit against its plain version, with no launch for an empty output, and
past 32-bit indices and offsets (2^31 + 5 elements, 8 GiB an operand).

Needs a CUDA device and ``nvcc``; every test here is marked ``gpu`` and
skips elsewhere. The file imports neither JAX nor the JAX package, so on
a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

Tolerances: labels, curvature and compaction columns bit-equal (both
round every operation as written, in the same order); the full
extraction on the card equal to it on the CPU; one closed-loop scan on
the card within 1e-4 of it on the CPU, with the same GN status and
iterations (sums run in another order on the card). The odometry step
and preintegration in float32: the same GN status and iterations, poses
within 1e-4; preintegrated fields within 1e-5 of each field's largest
entry (100 compounded steps, transcendentals rounded differently). The
graph solvers and the mapping run in float64 (the float32 graph normal
equations have a condition number near 1e12, where LU and
conjugate-gradient rounding on two devices part visibly): positions
within 1e-6, the mapping run's keyframes and constraints exactly and its
trajectory within 1e-6 m. The hash map on the card: keys, slots,
occupancies, neighbours and validity as on the CPU exactly, squared
distances within 1e-6 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lidar_feature_extraction_tpu_torch.config import (  # noqa: E402
    ExtractionConfig, kitti_hdl64)
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.quaternion import (  # noqa: E402
    quat_identity)
from lidar_feature_extraction_tpu_torch.interop import (  # noqa: E402
    range_image_from_numpy)
from lidar_feature_extraction_tpu_torch.ops import extraction as tex  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import extraction_cuda  # noqa: E402
from lidar_feature_extraction_tpu_torch.utils.synthetic import (  # noqa: E402
    bench_scan, street_scan, street_world)

pytestmark = pytest.mark.gpu

import chip_smoke  # noqa: E402  (numpy only at import)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(xyz, device):
    t = torch.as_tensor(xyz, device=device)
    return [t[..., i].contiguous() for i in range(3)]


def _check(xyz, count, cfg, device, leaf=1.0, ce=32, cs=128):
    x, y, z = _planes(xyz, device)
    cnt = torch.as_tensor(count, dtype=torch.int32, device=device)
    got = extraction_cuda.label_and_columns_cuda(x, y, z, cnt, cfg, leaf,
                                                 ce, cs)
    want = tex.label_and_columns_plain(x, y, z, cnt, cfg, leaf, ce, cs)
    torch.cuda.synchronize()
    for name, g, w in zip(("labels", "curvature", "col"), got, want):
        assert torch.equal(g, w), name


CASES = ("bench_kitti", "ragged_default", "circle_ties", "street_kitti",
         "round_cap_hit", "odd_2303", "uneven_300", "count_below_half",
         "count_at_split", "bench_full", "street_full", "padding_5",
         "padding_16", "round_cap_hit_full")


def _full(name, kitti):
    """The 64 x 2304 scans of chip_smoke (bench seed 0, street seed 1)."""
    R, P = kitti.n_rings, kitti.max_points_per_ring
    if name == "bench":
        return bench_scan(np.random.default_rng(0), R, P)
    rng = np.random.default_rng(1)
    return street_scan(street_world(rng), rng, R, P)


def _case(name):
    """(xyz [R, P, 3] float32, count [R], ExtractionConfig) of a case.
    K1 splits a ring of P lanes between two thread blocks at
    H = ceil(P / 2) rounded up to 32; the cases from odd_2303 on put
    rings on both sides of that split, and run padding up to the
    kernel's limit of 16."""
    rng = np.random.default_rng(0)
    kitti = kitti_hdl64().extraction
    if name in ("odd_2303", "uneven_300"):
        P = 2303 if name == "odd_2303" else 300
        return bench_scan(rng, 4, P), np.full(4, P, np.int32), kitti
    if name in ("count_below_half", "count_at_split"):
        # P = 2304: the split is at H = 1152.
        xyz = bench_scan(rng, 6, 2304)
        counts = (np.array([500, 1000, 1151, 3, 40, 1100], np.int32)
                  if name == "count_below_half" else
                  np.array([1152, 1152, 1153, 1151, 2304, 1152], np.int32))
        xyz[np.arange(2304)[None, :] >= counts[:, None]] = 1e3  # garbage
        return xyz, counts, kitti
    if name in ("bench_full", "street_full", "round_cap_hit_full"):
        xyz = _full("street" if name == "street_full" else "bench", kitti)
        cfg = (dataclasses.replace(kitti, nms_rounds=2)
               if name == "round_cap_hit_full" else kitti)
        return xyz, np.full(len(xyz), xyz.shape[1], np.int32), cfg
    if name in ("padding_5", "padding_16"):
        cfg = dataclasses.replace(
            kitti, padding=5 if name == "padding_5" else 16,
            surface_threshold=0.3)
        xyz = bench_scan(rng, 8, 2304)
        counts = np.array([2304, 2000, 1152, 40, 35, 20, 2304, 1200],
                          np.int32)
        return xyz, counts, cfg
    bench = bench_scan(rng, 8, 512)
    full = np.full(8, 512, np.int32)
    if name == "bench_kitti":
        return bench, full, kitti
    if name == "round_cap_hit":
        return bench, full, dataclasses.replace(kitti, nms_rounds=2)
    if name == "ragged_default":
        counts = np.array([512, 400, 17, 0, 300, 12, 511, 256], np.int32)
        bench[np.arange(512)[None, :] >= counts[:, None]] = 1e3  # garbage
        return bench, counts, ExtractionConfig()
    if name == "circle_ties":
        az = np.linspace(-np.pi, np.pi, 300, endpoint=False)
        circle = np.zeros((2, 300, 3), np.float32)
        circle[..., 0], circle[..., 1] = 10 * np.cos(az), 10 * np.sin(az)
        return circle, np.full(2, 300, np.int32), \
            ExtractionConfig(surface_threshold=1.0)
    street = street_scan(street_world(rng), rng, 16, 576)
    return street, np.full(16, 576, np.int32), kitti


@pytest.mark.parametrize("case", CASES)
def test_k1_matches_plain_version(cuda, case):
    _check(*_case(case), cuda)


def test_launch_counter_counts_kernel_launches(cuda):
    xyz, count, cfg = _case("bench_kitti")
    x, y, z = _planes(xyz, cuda)
    cnt = torch.as_tensor(count, device=cuda)
    before = extraction_cuda.label_and_columns_cuda.launches
    extraction_cuda.label_and_columns(x, y, z, cnt, cfg, 1.0, 32, 128)
    tex.label_and_columns_plain(x, y, z, cnt, cfg, 1.0, 32, 128)
    assert extraction_cuda.label_and_columns_cuda.launches == before + 1


def test_k1_refuses_what_it_cannot_take(cuda):
    cfg = ExtractionConfig()
    x = torch.zeros((2, 64), device=cuda)
    cnt = torch.full((2,), 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        extraction_cuda.label_and_columns_cuda(x.double(), x, x, cnt, cfg,
                                               1.0, 8, 8)
    big = torch.zeros((1, 1 << 16), device=cuda)
    with pytest.raises(ValueError):
        extraction_cuda.label_and_columns_cuda(
            big, big, big, cnt[:1], cfg, 1.0, 8, 8)


def test_k1_refuses_padding_17(cuda):
    """The window masks hold 2 * padding bits of a 32-bit word."""
    xyz, count, _ = _case("bench_kitti")
    x, y, z = _planes(xyz, cuda)
    cnt = torch.as_tensor(count, device=cuda)
    before = extraction_cuda.label_and_columns_cuda.launches
    with pytest.raises(ValueError, match="padding"):
        extraction_cuda.label_and_columns_cuda(
            x, y, z, cnt, ExtractionConfig(padding=17), 1.0, 32, 128)
    assert extraction_cuda.label_and_columns_cuda.launches == before


def test_entry_points_default_to_the_card(cuda):
    img = range_image_from_numpy(np.zeros((2, 8, 3), np.float32),
                                 np.ones((2, 8), bool), np.full(2, 8))
    assert all(t.is_cuda for t in img)
    assert Pose.identity().q.is_cuda and quat_identity().is_cuda


def test_compact_extraction_through_k1_matches_plain_path(cuda):
    xyz, count, _ = _case("ragged_default")
    mask = np.arange(512)[None, :] < count[:, None]
    img = range_image_from_numpy(xyz, mask, count, device=cuda)
    kw = dict(surface_leaf=1.0, edges_per_ring=16, surface_runs_per_ring=32)
    a = tex.extract_features_compact(img, ExtractionConfig(), **kw)
    b = tex.extract_features_compact(
        img, ExtractionConfig(pallas_labeling=False), **kw)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_centroid_mode_through_k1_matches_plain_path(cuda):
    xyz, count, _ = _case("ragged_default")
    mask = np.arange(512)[None, :] < count[:, None]
    img = range_image_from_numpy(xyz, mask, count, device=cuda)
    kw = dict(surface_leaf=1.0, edges_per_ring=16, surface_runs_per_ring=32,
              surface_centroid=True)
    a = tex.extract_features_compact(img, ExtractionConfig(), **kw)
    b = tex.extract_features_compact(
        img, ExtractionConfig(pallas_labeling=False), **kw)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("case", ["bench_full", "street_full",
                                  "ragged_default"])
def test_extract_features_on_the_card_labels_with_k1(cuda, case):
    """The full extraction on a CUDA image labels with K1 (one launch)
    and equals the plain path on the CPU bit for bit: labels, curvature
    and the compacted edge and surface points (both take the same
    correctly rounded FMAs and square roots)."""
    xyz, count, cfg = _case(case)
    mask = np.arange(xyz.shape[1])[None, :] < count[:, None]
    before = extraction_cuda.label_and_columns_cuda.launches
    got = tex.extract_features(range_image_from_numpy(xyz, mask, count,
                                                      device=cuda), cfg)
    assert extraction_cuda.label_and_columns_cuda.launches == before + 1
    want = tex.extract_features(range_image_from_numpy(xyz, mask, count,
                                                       device="cpu"), cfg)
    for name in want._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name


@pytest.mark.parametrize("scene", ["bench", "street"])
def test_k1_under_vlp16_matches_the_cpu_and_the_record(cuda, scene):
    """vlp16's widths: 16 rings x 1856 points, padding 5, 64 NMS rounds.
    K1 equals the plain version on the card bit for bit (labels,
    curvature, columns); the full extraction on the card (one K1 launch)
    gives the CPU's labels, curvature and features exactly, and the
    record's labels and curvature (the JAX package's,
    ``tests/data/torch_reference_fullwidth.npz``; ROADMAP §C18)."""
    import reference_cases as rc
    from lidar_feature_extraction_tpu_torch.pipeline.launch import (
        load_config)

    cfg = load_config("vlp16")
    ex = cfg.extraction
    R, P = ex.n_rings, ex.max_points_per_ring
    xyz, _ = rc.scene_scan(scene, R, P)
    count, mask = np.full(R, P, np.int32), np.ones((R, P), bool)
    _check(xyz, count, ex, cuda, cfg.registration.surface_downsample_leaf,
           ex.edges_per_ring, ex.surface_runs_per_ring)
    before = extraction_cuda.label_and_columns_cuda.launches
    got = tex.extract_features(range_image_from_numpy(xyz, mask, count,
                                                      device=cuda), ex)
    assert extraction_cuda.label_and_columns_cuda.launches == before + 1
    want = tex.extract_features(range_image_from_numpy(xyz, mask, count,
                                                       device="cpu"), ex)
    for name in want._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    arrays, _ = rc.load()
    record = rc.case_arrays(arrays, f"vlp16/{scene}")
    np.testing.assert_array_equal(got.labels.cpu().numpy(), record["labels"])
    np.testing.assert_array_equal(
        got.curvature.cpu().numpy().view(np.int32),
        record["curvature"].view(np.int32))


def _small_drive(cfg):
    """Three scans of a worldsim drive at cfg's ring count and the world's
    feature map clouds (seed 0)."""
    from lidar_feature_extraction_tpu_torch.utils import worldsim

    rng = np.random.default_rng(0)
    world = worldsim.make_world(rng)
    edges, surfs = worldsim.world_maps(world, rng)
    scans, _ = worldsim.make_scan_sequence(
        world, rng, n_scans=3, n_rings=cfg.extraction.n_rings,
        n_az=cfg.extraction.max_points_per_ring)
    return edges, surfs, scans, worldsim.synth_twists(3, rng=rng)


@pytest.mark.parametrize("faithful", [False, True])
def test_process_scan_on_the_card_matches_the_cpu(cuda, faithful):
    """One closed-loop scan after two (EKF prior, registration, EKF
    update) on the card and on the CPU: the measured pose within 1e-4,
    the same GN status and iterations. The faithful path (kNN plane
    fits, ill-conditioned in float32 far from the origin) is held in
    float64."""
    from lidar_feature_extraction_tpu_torch.pipeline import localization
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        FusedLocalizationPipeline)

    torch.backends.cuda.matmul.allow_tf32 = False
    kitti = kitti_hdl64()
    cfg = dataclasses.replace(kitti, extraction=dataclasses.replace(
        kitti.extraction, n_rings=16, max_points_per_ring=512,
        max_edges=512, max_surfaces=4096))
    if faithful:
        cfg = dataclasses.replace(
            cfg, compact_extraction=False,
            registration=dataclasses.replace(cfg.registration,
                                             refit_per_iteration=True))
    dtype = torch.float64 if faithful else torch.float32
    build = (localization.build_feature_maps if faithful
             else localization.build_geometry_maps)
    edges, surfs, scans, twists = _small_drive(cfg)
    out = []
    for dev in (cuda, torch.device("cpu")):
        ones = lambda a: torch.ones(len(a), dtype=torch.bool, device=dev)  # noqa: E731
        e = torch.as_tensor(edges, dtype=dtype, device=dev)
        s = torch.as_tensor(surfs, dtype=dtype, device=dev)
        pipe = FusedLocalizationPipeline(
            build(e, ones(e), s, ones(s), cfg),
            cfg, initial_pose=Pose.identity(dtype, dev), dtype=dtype,
            device=dev)
        for i, (pts, ring) in enumerate(scans):
            res = pipe.process_scan(pts, ring, 0.1 * i, twists[i])
        out.append(res)
    got, want = out
    assert (got.gn_status, got.gn_iterations) == (want.gn_status,
                                                  want.gn_iterations)
    for g, w in ((got.measured_pose.t, want.measured_pose.t),
                 (got.measured_pose.q, want.measured_pose.q),
                 (got.fused_pose.t, want.fused_pose.t)):
        assert float((g.cpu() - w).abs().max()) <= 1e-4


# ---- odometry, preintegration, back end, mapping ----------------------

def _mapping_cfg():
    """A small configuration: 256 edges, 512 surface points, 2 m voxels,
    a 32 x 32 x 8 odometry grid (test_pipeline's sizes)."""
    from lidar_feature_extraction_tpu_torch.config import (
        MappingConfig, PipelineConfig, RegistrationConfig, VoxelMapConfig)

    vm = VoxelMapConfig(voxel_size=2.0, table_capacity=1 << 12,
                        points_per_voxel=16, max_probes=8)
    return PipelineConfig(
        extraction=ExtractionConfig(n_rings=8, max_points_per_ring=256,
                                    nms_rounds=32, max_edges=256,
                                    max_surfaces=512),
        registration=RegistrationConfig(
            n_neighbors=8, max_iterations=30, edge_map=vm, surface_map=vm,
            odometry_grid_dims=(32, 32, 8)),
        mapping=MappingConfig(max_keyframes=16, max_map_points=1 << 14))


def _feature_scans(xs, seed=1):
    """Feature clouds seen from (x, 0.1 n, 0) for each x in ``xs``: pole
    samples and ground points of a seeded world within sensor-frame
    reach, padded to the small configuration's capacities; numpy."""
    rng = np.random.default_rng(seed)
    zs = np.linspace(-2, 4, 30)
    poles = np.concatenate([
        np.concatenate([np.tile(rng.uniform(-15, 15, size=2), (30, 1)),
                        zs[:, None]], axis=-1) for _ in range(20)])
    edges = poles + rng.normal(scale=0.01, size=poles.shape)
    g = rng.uniform(-20, 20, size=(4000, 2))
    surfs = np.concatenate([g, rng.normal(scale=0.01, size=(4000, 1))], -1)
    out = []
    for n, x in enumerate(xs):
        t = np.array([x, 0.1 * n, 0.0])
        scan = []
        for pts, k, cap in ((edges, 200, 256), (surfs, 500, 512)):
            pick = pts[rng.choice(len(pts), size=k, replace=False)] - t
            buf = np.zeros((cap, 3), np.float32)
            buf[:k] = pick
            scan += [buf, np.arange(cap) < k]
        out.append(scan)
    return out


def test_geometry_odometry_step_on_the_card_matches_the_cpu(cuda):
    """Three incremental odometry steps (window insert, eviction-free
    registration, a constant-velocity prior) on both devices."""
    from lidar_feature_extraction_tpu_torch.pipeline import odometry

    cfg = _mapping_cfg()
    out = []
    for dev in (cuda, torch.device("cpu")):
        state = odometry.init_geometry_odometry(cfg, device=dev)
        for scan in _feature_scans([0.0, 0.6, 1.2]):
            args = [torch.as_tensor(a, device=dev) for a in scan]
            state, res = odometry.geometry_odometry_step(state, *args, cfg)
        out.append((state, res))
    (gs, got), (ws, want) = out
    assert (int(got.status), int(got.iterations)) == (int(want.status),
                                                      int(want.iterations))
    assert int(got.iterations) >= 1
    for g, w in ((gs.pose_t, ws.pose_t), (gs.pose_q, ws.pose_q)):
        assert float((g.cpu() - w).abs().max()) <= 1e-4
    assert torch.equal(gs.edge_mask.cpu(), ws.edge_mask)
    assert float(gs.pose_t[0]) > 1.0        # it moved with the scans


def test_preintegrate_on_the_card_matches_the_cpu(cuda):
    from lidar_feature_extraction_tpu_torch.fusion import imu

    rng = np.random.default_rng(3)
    gyro = rng.normal(scale=0.3, size=(100, 3)).astype(np.float32)
    accel = (rng.normal(scale=1.0, size=(100, 3))
             + [0.0, 0.0, 9.80665]).astype(np.float32)
    dts = np.full(100, 0.001, np.float32)
    valid = np.arange(100) < 93
    out = []
    for dev in (cuda, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        out.append(imu.preintegrate(t(gyro), t(accel), t(dts),
                                    t(np.float32([1e-3, 0, 0])),
                                    t(np.float32([0, 2e-2, 0])),
                                    valid=t(valid)))
    got, want = out
    for name in want._fields:
        w = getattr(want, name)
        scale = max(float(w.abs().max()), 1e-12)
        assert float((getattr(got, name).cpu() - w).abs().max()) \
            <= 1e-5 * scale, name


def _looped_graph_np(k=10, seed=1):
    """k poses around an arc, the chain measured with noise plus a loop
    k-1 -> 0 and a 3 m outlier 2 -> 6; the initial guess is the noisy
    chain integrated. float64 numpy: (q, t), constraint fields."""
    from lidar_feature_extraction_tpu_torch.core import quaternion as quat

    f64 = torch.float64
    rng = np.random.default_rng(seed)
    yaw = np.linspace(0, 1.6 * np.pi, k)
    gt = [Pose(torch.tensor([np.cos(a / 2), 0, 0, np.sin(a / 2)], dtype=f64),
               torch.tensor([6 * np.sin(a), 6 * (1 - np.cos(a)), 0.1 * a],
                            dtype=f64)) for a in yaw]
    pairs = [(n, n + 1) for n in range(k - 1)] + [(0, k - 1), (2, 6)]
    zs = []
    for n, (a, b) in enumerate(pairs):
        rel = gt[a].inverse().compose(gt[b])
        noise = quat.exp_so3(torch.as_tensor(rng.normal(scale=0.01, size=3)))
        off = rng.normal(scale=0.05, size=3) + (
            [0.0, 3.0, 0.0] if n == len(pairs) - 1 else 0.0)
        zs.append(Pose(quat.quat_multiply(rel.q, noise),
                       rel.t + torch.as_tensor(off)))
    poses = [gt[0]]
    for z in zs[:k - 1]:
        poses.append(poses[-1].compose(z))
    cons = (np.array([p[0] for p in pairs], np.int32),
            np.array([p[1] for p in pairs], np.int32),
            torch.stack([z.q for z in zs]).numpy(),
            torch.stack([z.t for z in zs]).numpy(),
            np.r_[np.ones(k - 1), 0.8, 0.7])   # float64 throughout
    return (torch.stack([p.q for p in poses]).numpy(),
            torch.stack([p.t for p in poses]).numpy()), cons


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_solvers_on_the_card_match_the_cpu(cuda, solver):
    from lidar_feature_extraction_tpu_torch.parallel import pose_graph

    (q, t), cons = _looped_graph_np()
    fn, kw = ((pose_graph.optimize_pose_graph, {}) if solver == "dense"
              else (pose_graph.optimize_pose_graph_cg, dict(n_cg=10)))
    out = []
    for dev in (cuda, torch.device("cpu")):
        t64 = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        out.append(fn(pose_graph.PoseGraph(t64(q), t64(t)),
                      pose_graph.Constraints(*[t64(a) for a in cons]),
                      n_iterations=6, robust_delta=0.5, **kw))
    got, want = out
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-6
    assert float((want.poses_t - torch.as_tensor(t)).abs().max()) > 0.05


@pytest.mark.parametrize("keyframes", [8, 16, 24, 40])
def test_pose_graph_float32_on_the_card_equals_the_cpu(cuda, keyframes):
    """slam_loop's graphs from the mapping record through the graduated
    schedule ``MappingPipeline.optimize`` runs, float32: the card's
    poses equal the CPU's bit for bit (the linearization's forms, the
    block scatter adding each destination's blocks in turn, the
    ``lu_solve`` kernel against its plain version, the update)."""
    import reference_cases as rc
    from lidar_feature_extraction_tpu_torch.parallel import pose_graph
    from lidar_feature_extraction_tpu_torch.pipeline.slam import (
        MappingPipeline)

    (q, t), cons = rc.slam_graph(rc.load_mapping()[0], keyframes)
    out = []
    for dev in (cuda, torch.device("cpu")):
        graph = pose_graph.PoseGraph(torch.as_tensor(q, device=dev),
                                     torch.as_tensor(t, device=dev))
        c = pose_graph.Constraints(*[torch.as_tensor(a, device=dev)
                                     for a in cons])
        for delta, n in MappingPipeline._gnc_schedule(0.5, 10):
            graph = pose_graph.optimize_pose_graph(
                graph, c, n_iterations=n, robust_delta=delta)
        out.append(graph)
    for g, w in zip(*out):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("width", [1, 6, 9, 32, 33, 36])
def test_index_add_rows_in_order_on_the_card_equals_the_cpu(cuda, width):
    """The normal equations' block scatter on the card: each
    destination's rows added in turn, the CPU's bits and those of the
    rows added one at a time, at g's widths (6, 9), the blocks' (36) and
    about torch's 32-value threshold between its ``index_put`` kernels."""
    from torch_parity import scatter_rows_case
    from lidar_feature_extraction_tpu_torch.ops.scatter import (
        index_add_rows_in_order)

    out, index, src, want = scatter_rows_case(width)
    got = [index_add_rows_in_order(*(torch.as_tensor(a, device=dev)
                                     for a in (out, index, src))).cpu()
           for dev in (cuda, torch.device("cpu"))]
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], torch.as_tensor(want))


def test_optimize_imu_graph_on_the_card_matches_the_cpu(cuda):
    """A 2 s arc with a 0.02 rad/s yaw-rate bias, keyframes every 0.2 s,
    factors preintegrated at zero bias; the bias is recovered on both."""
    from lidar_feature_extraction_tpu_torch.fusion import imu
    from lidar_feature_extraction_tpu_torch.parallel import (
        imu_graph, pose_graph)

    f64 = torch.float64
    n, dt, every = 101, 0.02, 10
    th = 2.0 * dt * np.arange(n) / 20.0
    q_gt = torch.tensor(np.stack([np.cos(th / 2), 0 * th, 0 * th,
                                  np.sin(th / 2)], -1))
    t_gt = torch.tensor(np.stack([20 * np.sin(th), 20 * (1 - np.cos(th)),
                                  0 * th], -1))
    gyro, accel, dts, _ = imu.synthesize_imu(q_gt, t_gt, dt)
    gyro = gyro + torch.tensor([0.0, 0.0, 0.02], dtype=f64)
    kf = list(range(0, n, every))
    k = len(kf)
    out = []
    for dev in (cuda, torch.device("cpu")):
        zero = torch.zeros(3, dtype=f64, device=dev)
        pres = [imu.preintegrate(gyro[a:b].to(dev), accel[a:b].to(dev),
                                 dts[a:b].to(dev), zero, zero)
                for a, b in zip(kf[:-1], kf[1:])]
        w_rot, w_vel, w_pos = imu_graph.weights_from_covariance(
            torch.stack([p.cov for p in pres]))
        gt = [Pose(q_gt[a].to(dev), t_gt[a].to(dev)) for a in kf]
        rels = [gt[a].inverse().compose(gt[a + 1]) for a in range(k - 1)]
        poses = [gt[0]]
        for r in rels:
            poses.append(poses[-1].compose(Pose(r.q, r.t + 0.01)))
        idx = torch.arange(k - 1, dtype=torch.int32, device=dev)
        ones = torch.ones(k - 1, dtype=f64, device=dev)
        cons = pose_graph.Constraints(idx, idx + 1,
                                      torch.stack([r.q for r in rels]),
                                      torch.stack([r.t for r in rels]), ones)
        stack = {f: torch.stack([getattr(p, f) for p in pres])
                 for f in imu.ImuPreintegration._fields}
        factors = imu_graph.ImuFactors(
            idx, idx + 1, stack["dq"], stack["dv"], stack["dp"], stack["dt"],
            w_rot, w_vel, w_pos, ones, stack["dq_dbg"], stack["dv_dbg"],
            stack["dv_dba"], stack["dp_dbg"], stack["dp_dba"])
        pt = torch.stack([p.t for p in poses])
        vels = torch.gradient(pt, dim=0)[0] / (every * dt)
        graph = imu_graph.ImuGraph(torch.stack([p.q for p in poses]), pt,
                                   vels, bg=zero)
        out.append(imu_graph.optimize_imu_graph(graph, cons, factors,
                                                n_iterations=8,
                                                robust_delta=0.5))
    got, want = out
    for name in ("poses_q", "poses_t", "vels", "bg"):
        assert float((getattr(got, name).cpu() - getattr(want, name))
                     .abs().max()) <= 1e-6, name
    assert abs(float(want.bg[2]) - 0.02) < 5e-3


def test_mapping_pipeline_on_the_card_matches_the_cpu(cuda):
    """Ten scans out and back (2 m steps, then home): odometry,
    keyframes, one loop closure or more through the pyramid, the pose
    graph, on both devices in float64."""
    from lidar_feature_extraction_tpu_torch.pipeline.slam import (
        MappingPipeline)

    cfg = _mapping_cfg()
    scans = _feature_scans([0, 1.5, 3, 4.5, 6, 4.5, 3, 1.5, 0.5, 0.1])
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = MappingPipeline(cfg, loop_radius=2.5, loop_min_gap=2,
                            optimize_every=3, dtype=torch.float64,
                            device=dev)
        for n, scan in enumerate(scans):
            p.process_scan(*scan, stamp=0.1 * n)
        p.optimize()
        out.append(p)
    got, want = out
    assert len(got.keyframes) == len(want.keyframes)
    assert [c[:2] for c in got.constraints] == \
        [c[:2] for c in want.constraints]
    assert len(want.constraints) > len(want.keyframes) - 1   # a closure
    np.testing.assert_allclose(got.trajectory, want.trajectory, rtol=0,
                               atol=1e-6)


def _chunk_scans(cfg, device, n=12, dead=None):
    """test_mapping_chunk.py's construction: ``n`` scans of a ray-cast
    circle (24 scans around 5 m, 16 rings x 512 azimuths) as range images
    on ``device``; with ``dead`` that scan's points all invalid."""
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.utils import worldsim

    rng = np.random.default_rng(3)
    world = worldsim.make_world(rng, n_poles=30, extent=25.0)
    out = []
    for i in range(n):
        pts, ring = worldsim.raycast_scan(
            world, worldsim.circle_pose(i, 24, 5.0), rng, n_rings=16,
            n_az=512, elev_deg=(2.0, -24.8))
        im = scan_range_image(pts, ring, cfg, device)
        if i == dead:
            im = im._replace(xyz=torch.zeros_like(im.xyz),
                             mask=torch.zeros_like(im.mask),
                             count=torch.zeros_like(im.count))
        out.append(im)
    return out


def _chunk_cfg():
    cfg = _mapping_cfg()
    return dataclasses.replace(cfg, extraction=dataclasses.replace(
        cfg.extraction, n_rings=16, max_points_per_ring=512))


@pytest.mark.parametrize("dead", [None, 7])
def test_chunked_front_end_launches_k1_once_per_block(cuda, dead):
    """``ChunkedMappingPipeline`` on the card, 12 scans in blocks of 6
    (the odometry's edge gate off, as in test_torch_mapping_chunk.py, so
    that a block replays only when a scan fails outright): one K1 launch
    per block; a block with a dead scan is replayed scan by scan, one
    launch per scan more. Its keyframes, constraints and trajectory equal
    the per-scan pipeline's on the card, bit for bit."""
    from lidar_feature_extraction_tpu_torch.core.scan import (
        stack_range_images)
    from lidar_feature_extraction_tpu_torch.pipeline.mapping_chunk import (
        ChunkedMappingPipeline)
    from lidar_feature_extraction_tpu_torch.pipeline.slam import (
        MappingPipeline)

    cfg = _chunk_cfg()
    images = _chunk_scans(cfg, cuda, dead=dead)
    kw = dict(loop_radius=4.0, loop_min_gap=5, optimize_every=6,
              device=cuda)
    chunked = ChunkedMappingPipeline(cfg, **kw)
    chunked.odometry.edge_gate_distance = None
    launches = []
    for s in (0, 6):
        extraction_cuda.label_and_columns_cuda.launches = 0
        chunked.process_block(stack_range_images(images[s:s + 6]),
                              [0.1 * (s + k) for k in range(6)])
        torch.cuda.synchronize()
        launches.append(extraction_cuda.label_and_columns_cuda.launches)
    chunked.optimize()
    assert launches == ([1, 1] if dead is None else [1, 1 + 6])
    per_scan = MappingPipeline(cfg, **kw)
    per_scan.odometry.edge_gate_distance = None
    for n, im in enumerate(images):
        f = tex.extract_features(im, cfg.extraction)
        per_scan.process_scan(f.edge_xyz, f.edge_valid, f.surface_xyz,
                              f.surface_valid, stamp=0.1 * n)
    per_scan.optimize()
    assert len(chunked.keyframes) == len(per_scan.keyframes)
    assert [c[:2] for c in chunked.constraints] == \
        [c[:2] for c in per_scan.constraints]
    np.testing.assert_array_equal(chunked.trajectory, per_scan.trajectory)


# ---- the batched localizer and the entry points -------------------------

def _lanes(B, device):
    """B lanes of chip_smoke's bench scan at kitti widths, lane b moved
    by 1e-3 * b m: a batch of images [B, 64, 2304, 3] on ``device``."""
    from lidar_feature_extraction_tpu_torch.core.scan import (
        stack_range_images)

    kitti = kitti_hdl64().extraction
    xyz = _full("bench", kitti)
    R, P = xyz.shape[:2]
    step = np.float32([1.0, -0.5, 0.2])
    return stack_range_images([range_image_from_numpy(
        xyz + np.float32(1e-3 * b) * step, np.ones((R, P), bool),
        np.full(R, P, np.int32), device=device) for b in range(B)])


@pytest.mark.parametrize("B", [1, 3, 32])
def test_batched_k1_launch_matches_single_launches_and_plain(cuda, B):
    """One launch on the batch's [B * 64, 2304] planes: bit-equal to B
    single launches and to the plain version, counted once."""
    kitti = kitti_hdl64().extraction
    images = _lanes(B, cuda)
    args = (kitti, 1.0, kitti.edges_per_ring, kitti.surface_runs_per_ring)
    planes = [images.xyz.flatten(0, 1)[..., i].contiguous() for i in range(3)]
    count = images.count.flatten()
    before = extraction_cuda.label_and_columns_cuda.launches
    got = extraction_cuda.label_and_columns_cuda(*planes, count, *args)
    assert extraction_cuda.label_and_columns_cuda.launches == before + 1
    singles = [extraction_cuda.label_and_columns_cuda(
        *[p[b * 64:(b + 1) * 64] for p in planes], count[:64], *args)
        for b in range(B)]
    want = tex.label_and_columns_plain(*planes, count, *args)
    torch.cuda.synchronize()
    for n, name in enumerate(("labels", "curvature", "col")):
        assert torch.equal(got[n], torch.cat([s[n] for s in singles])), name
        assert torch.equal(got[n], want[n]), name


def test_localize_scans_on_the_card_matches_lone_runs(cuda):
    """Six lanes of the bench scene at kitti widths, each with its own
    prior, through the batched localizer on the card: each lane's status
    and iterations those of its lone ``localize_scan`` on the card, its
    pose within 1e-4; one K1 launch for the batch."""
    from lidar_feature_extraction_tpu_torch.parallel.distributed import (
        make_batched_localizer)
    from lidar_feature_extraction_tpu_torch.pipeline import localization
    from lidar_feature_extraction_tpu_torch.utils.synthetic import (
        keyframe_copies)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = kitti_hdl64()
    B = 6
    images = _lanes(B, cuda)
    one = range_image_from_numpy(*(a[0].cpu().numpy() for a in images),
                                 device=cuda)
    f = tex.extract_features(one, cfg.extraction)
    rng = np.random.default_rng(0)
    bench_scan(rng, 64, 2304)             # the map's draws follow the scan's
    edge = torch.as_tensor(keyframe_copies(rng, f.edge_xyz[
        f.edge_valid].cpu().numpy()), dtype=torch.float32, device=cuda)
    surf = torch.as_tensor(keyframe_copies(rng, f.surface_xyz[
        f.surface_valid].cpu().numpy()), dtype=torch.float32, device=cuda)
    ones = lambda a: torch.ones(len(a), dtype=torch.bool, device=cuda)  # noqa: E731
    maps = localization.build_geometry_maps(edge, ones(edge), surf,
                                            ones(surf), cfg)
    prng = np.random.default_rng(7)
    yaw = np.radians(1.0) * prng.normal(size=B)
    d = prng.normal(size=(B, 3))
    q = torch.as_tensor(np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw,
                                  np.sin(yaw / 2)], -1), dtype=torch.float32,
                        device=cuda)
    t = torch.as_tensor(np.float32([0.3, -0.2, 0.05]) + 0.2 * d
                        / np.linalg.norm(d, axis=-1, keepdims=True),
                        dtype=torch.float32, device=cuda)
    before = extraction_cuda.label_and_columns_cuda.launches
    got, feats = make_batched_localizer(cfg)(maps, images, Pose(q, t))
    assert extraction_cuda.label_and_columns_cuda.launches == before + 1
    assert feats.labels.shape == images.mask.shape
    for b in range(B):
        lone, _ = localization.localize_scan(
            maps, localization.RangeImage(*(a[b] for a in images)),
            Pose(q[b], t[b]), cfg)
        assert (int(got.status[b]), int(got.iterations[b])) == (
            int(lone.status), int(lone.iterations)), b
        assert float((got.pose.t[b] - lone.pose.t).abs().max()) <= 1e-4
        assert float((got.pose.q[b] - lone.pose.q).abs().max()) <= 1e-4


def test_batched_localizer_and_launchers_default_to_the_card(cuda,
                                                             tmp_path):
    from lidar_feature_extraction_tpu_torch.interop import (
        geometry_maps_from_numpy, poses_from_numpy, range_images_from_numpy)
    from lidar_feature_extraction_tpu_torch.io.pcd import save_pcd
    from lidar_feature_extraction_tpu_torch.parallel.distributed import (
        make_batched_localizer)
    from lidar_feature_extraction_tpu_torch.pipeline import launch

    cfg = launch.load_config("kitti_hdl64", overrides={
        "extraction": {"n_rings": 4, "max_points_per_ring": 64}})
    rec = np.zeros((5, 8), np.float32)
    maps = geometry_maps_from_numpy(
        rec, np.float32(0.5), np.zeros(3, np.float32), (2, 2, 1), rec,
        np.float32(0.5), np.zeros(3, np.float32), (2, 2, 1))
    assert maps.fused.is_cuda
    images = range_images_from_numpy(
        np.ones((2, 4, 64, 3), np.float32), np.ones((2, 4, 64), bool),
        np.full((2, 4), 64), device="cpu")
    priors = poses_from_numpy(np.float32([[1, 0, 0, 0]] * 2),
                              np.zeros((2, 3), np.float32), device="cpu")
    result, feats = make_batched_localizer(cfg)(maps, images, priors)
    assert result.pose.t.is_cuda and feats.labels.is_cuda
    rng = np.random.default_rng(0)
    edge, surf = str(tmp_path / "edge.pcd"), str(tmp_path / "surface.pcd")
    save_pcd(edge, np.float32(rng.uniform(-5, 5, (200, 3))))
    save_pcd(surf, np.float32(rng.uniform(-5, 5, (400, 3))))
    assert launch.load_maps(edge, surf, cfg).fused.is_cuda
    pipe = launch.launch_localization(edge, surf, cfg)
    assert pipe.device.type == "cuda" and pipe.maps.fused.is_cuda
    assert launch.launch_mapping(cfg).odometry.state.pose_t.is_cuda
    assert launch.launch_odometry(cfg).state.pose_t.is_cuda


# ---- fixed-order scatter-adds, the batched branches, the hash map -------

def _scatter_calls(dev):
    """Every float scatter-add site of the port on seeded inputs of map
    and scan size: name -> a call whose result must not change."""
    from lidar_feature_extraction_tpu_torch.ops import geometry_grid as gg
    from lidar_feature_extraction_tpu_torch.ops.downsample import (
        voxel_downsample, voxel_downsample_dense)
    from lidar_feature_extraction_tpu_torch.parallel import pose_graph

    rng = np.random.default_rng(4)
    pts = torch.as_tensor(np.float32(rng.uniform(-30, 30, (200000, 3))),
                          device=dev)
    scans = torch.as_tensor(np.float32(rng.uniform(-20, 20, (4, 30000, 3))),
                            device=dev)
    mask = torch.as_tensor(rng.random((4, 30000)) < 0.9, device=dev)
    (q, t), cons = _looped_graph_np(k=40, seed=2)
    graph = pose_graph.PoseGraph(torch.as_tensor(q, device=dev),
                                 torch.as_tensor(t, device=dev))
    cons = pose_graph.Constraints(*[torch.as_tensor(a, device=dev)
                                    for a in cons])
    ones = torch.ones(len(pts), dtype=torch.bool, device=dev)
    return {
        "voxel_moments": lambda: gg.voxel_moments(
            pts, ones, 1.0, [-32.0, -32.0, -32.0], (64, 64, 64)),
        "voxel_downsample": lambda: voxel_downsample(
            scans[0], mask[0], 1.0, 4096)[0],
        "voxel_downsample_batch": lambda: voxel_downsample(
            scans, mask, 1.0, 4096)[0],
        "voxel_downsample_dense": lambda: voxel_downsample_dense(
            scans[0], mask[0], 1.0, 4096, (64, 64, 64))[0],
        "scatter_normal_equations": lambda: torch.cat([
            a.reshape(-1) for a in pose_graph._local_normal_equations(
                graph, cons, 40)]),
        "pose_graph_cg": lambda: pose_graph.optimize_pose_graph_cg(
            graph, cons, n_iterations=2, n_cg=10).poses_t,
    }


@pytest.mark.parametrize("site", ["voxel_moments", "voxel_downsample",
                                  "voxel_downsample_batch",
                                  "voxel_downsample_dense",
                                  "scatter_normal_equations",
                                  "pose_graph_cg"])
def test_scatter_site_gives_the_same_bits_twice(cuda, site):
    fn = _scatter_calls(cuda)[site]
    first = fn()
    for _ in range(3):
        assert torch.equal(fn(), first)


def test_batched_full_extraction_lanes_equal_lone_calls(cuda):
    """The full extraction of three kitti-width scans: one K1 launch for
    the batch, every lane's labels and compacted features those of its
    lone call."""
    cfg = kitti_hdl64().extraction
    images = _lanes(3, cuda)
    before = extraction_cuda.label_and_columns_cuda.launches
    got = tex.extract_features(images, cfg)
    assert extraction_cuda.label_and_columns_cuda.launches == before + 1
    for b in range(3):
        one = tex.extract_features(
            type(images)(*(a[b] for a in images)), cfg)
        for name, g, w in zip(one._fields, got, one):
            assert torch.equal(g[b], w), (b, name)


@pytest.mark.parametrize("branch", ["full_geometry", "feature_refit",
                                    "feature_frozen"])
def test_localize_scans_branches_on_the_card_match_lone_runs(cuda, branch):
    """Four lanes of the bench scene at kitti widths through the full
    extraction over GeometryMaps or over FeatureMaps (refitting every
    iteration or once per round): each lane's status and iterations those
    of its lone ``localize_scan`` on the card, its pose within 1e-4; one
    K1 launch for the batch."""
    from lidar_feature_extraction_tpu_torch.parallel.distributed import (
        make_batched_localizer)
    from lidar_feature_extraction_tpu_torch.pipeline import localization
    from lidar_feature_extraction_tpu_torch.utils.synthetic import (
        keyframe_copies)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(kitti_hdl64(), compact_extraction=False)
    if branch != "full_geometry":
        cfg = dataclasses.replace(cfg, registration=dataclasses.replace(
            cfg.registration, refit_per_iteration=branch == "feature_refit"))
    B = 4
    images = _lanes(B, cuda)
    one = localization.RangeImage(*(a[0] for a in images))
    f = tex.extract_features(one, cfg.extraction)
    rng = np.random.default_rng(0)
    bench_scan(rng, 64, 2304)             # the map's draws follow the scan's
    clouds = [torch.as_tensor(keyframe_copies(rng, c[v].cpu().numpy()),
                              dtype=torch.float32, device=cuda)
              for c, v in ((f.edge_xyz, f.edge_valid),
                           (f.surface_xyz, f.surface_valid))]
    ones = [torch.ones(len(c), dtype=torch.bool, device=cuda) for c in clouds]
    build = (localization.build_geometry_maps if branch == "full_geometry"
             else localization.build_feature_maps)
    maps = build(clouds[0], ones[0], clouds[1], ones[1], cfg)
    prng = np.random.default_rng(9)
    yaw = np.radians(1.0) * prng.normal(size=B)
    d = prng.normal(size=(B, 3)) * [1.0, 1.0, 0.0]
    q = torch.as_tensor(np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw,
                                  np.sin(yaw / 2)], -1), dtype=torch.float32,
                        device=cuda)
    t = torch.as_tensor(np.float32([0.3, -0.2, 0.05]) + np.float32(
        [0.1, 0.3, 0.6, 0.9])[:, None] * d
        / np.linalg.norm(d, axis=-1, keepdims=True), dtype=torch.float32,
        device=cuda)
    before = extraction_cuda.label_and_columns_cuda.launches
    got, feats = make_batched_localizer(cfg)(maps, images, Pose(q, t))
    assert extraction_cuda.label_and_columns_cuda.launches == before + 1
    assert feats.labels.shape == images.mask.shape
    for b in range(B):
        lone, _ = localization.localize_scan(
            maps, localization.RangeImage(*(a[b] for a in images)),
            Pose(q[b], t[b]), cfg)
        assert (int(got.status[b]), int(got.iterations[b])) == (
            int(lone.status), int(lone.iterations)), b
        assert float((got.pose.t[b] - lone.pose.t).abs().max()) <= 1e-4
        assert float((got.pose.q[b] - lone.pose.q).abs().max()) <= 1e-4


def test_hash_map_on_the_card_matches_the_cpu(cuda):
    from lidar_feature_extraction_tpu_torch.ops import voxel_map

    rng = np.random.default_rng(5)
    pts = np.float32(rng.uniform(-40, 40, (60000, 3)))
    mask = rng.random(60000) < 0.95
    queries = np.float32(rng.uniform(-38, 38, (2, 3000, 3)))
    out = []
    for dev in (cuda, torch.device("cpu")):
        m = voxel_map.build_voxel_map(torch.as_tensor(pts, device=dev),
                                      torch.as_tensor(mask, device=dev),
                                      1.0, 1 << 16, 8)
        out.append((m, voxel_map.knn(m, torch.as_tensor(queries, device=dev),
                                     15)))
    (gm, (gn, gsq, gv)), (wm, (wn, wsq, wv)) = out
    for name in ("keys", "points", "n_pts"):
        assert torch.equal(getattr(gm, name).cpu(), getattr(wm, name)), name
    assert torch.equal(gv.cpu(), wv) and torch.equal(gn.cpu(), wn)
    assert int(wv.sum()) > 1000
    np.testing.assert_allclose(gsq.cpu()[wv].numpy(), wsq[wv].numpy(),
                               rtol=1e-6, atol=0)


# ---- the host-stepped localizer and the exact medians --------------------

@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_host_localizer_on_the_card_equals_localize_scan(cuda, compact):
    """HostLocalizer.localize on the card over GeometryMaps: status,
    iterations and pose those of ``localize_scan`` bit for bit (the same
    device steps, the reference's host loop control), one K1 launch per
    scan."""
    from lidar_feature_extraction_tpu_torch.pipeline import localization
    from lidar_feature_extraction_tpu_torch.utils.synthetic import (
        keyframe_copies)

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(kitti_hdl64(), compact_extraction=compact)
    images = _lanes(3, cuda)
    one = localization.RangeImage(*(a[0] for a in images))
    f = tex.extract_features(one, cfg.extraction)
    rng = np.random.default_rng(0)
    bench_scan(rng, 64, 2304)             # the map's draws follow the scan's
    clouds = [torch.as_tensor(keyframe_copies(rng, c[v].cpu().numpy()),
                              dtype=torch.float32, device=cuda)
              for c, v in ((f.edge_xyz, f.edge_valid),
                           (f.surface_xyz, f.surface_valid))]
    ones = [torch.ones(len(c), dtype=torch.bool, device=cuda) for c in clouds]
    maps = localization.build_geometry_maps(clouds[0], ones[0], clouds[1],
                                            ones[1], cfg)
    host = localization.HostLocalizer(maps, cfg)
    prng = np.random.default_rng(7)
    for b in range(3):
        yaw = np.radians(1.0) * prng.normal()
        d = prng.normal(size=3)
        prior = Pose(torch.tensor([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                                  dtype=torch.float32, device=cuda),
                     torch.as_tensor(np.float32([0.3, -0.2, 0.05])
                                     + np.float32(0.2 * d / np.linalg.norm(d)),
                                     device=cuda))
        image = localization.RangeImage(*(a[b] for a in images))
        before = extraction_cuda.label_and_columns_cuda.launches
        got, _ = host.localize(image, prior)
        assert extraction_cuda.label_and_columns_cuda.launches == before + 1
        want, _ = localization.localize_scan(maps, image, prior, cfg)
        assert got.status.device.type == "cuda"
        assert (int(got.status), int(got.iterations)) == (
            int(want.status), int(want.iterations)), b
        assert torch.equal(got.pose.t, want.pose.t), b
        assert torch.equal(got.pose.q, want.pose.q), b


@pytest.mark.parametrize("name", ["masked_median", "masked_mad",
                                  "masked_scale"])
def test_exact_medians_on_the_card_equal_the_cpu(cuda, name):
    """The sort-based statistics over lanes with odd, even and no valid
    values: the card's bits are the CPU's."""
    from lidar_feature_extraction_tpu_torch.core import stats

    rng = np.random.default_rng(3)
    v = torch.as_tensor(rng.exponential(size=(5, 999)).astype(np.float32))
    m = torch.as_tensor(rng.random((5, 999)) < 0.5)
    m[2] = False
    m[3] = torch.arange(999) < 10
    m[4] = torch.arange(999) < 11
    fn = getattr(stats, name)
    want = fn(v, m)
    got = fn(v.to(cuda), m.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got[2]) and not torch.isnan(got[[0, 1, 3, 4]]).any()


@pytest.mark.parametrize("m", [7, 1000, 7991, 10243, 81920])
def test_normal_equations_kernel_matches_plain_version(cuda, m):
    """csrc/normal_equations.cu against ``_xla_dot.normal_equations_plain``
    on the card, bit for bit, for a batch of 3 read through strides and
    for its lanes alone (ROADMAP §C21). At 81,920 rows a lane's sums are
    too many for shared memory, and its fold reads them from L2."""
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
    from lidar_feature_extraction_tpu_torch.ops.normal_equations_cuda import (
        normal_equations_cuda)

    g = torch.Generator().manual_seed(m)
    j = torch.randn(3, m, 7, generator=g)
    w = torch.rand(3, m, 1, generator=g) * (torch.rand(3, m, 1, generator=g)
                                            < 0.9)
    r = torch.randn(3, m, generator=g)
    j = j.to(cuda)
    args = ((j != 0) * j, j * w.to(cuda),
            j.transpose(1, 2).contiguous().transpose(1, 2),
            (w[..., 0] * r).to(cuda))
    got = normal_equations_cuda(*args)
    want = xd.normal_equations_plain(*args)
    for k in range(3):
        lone = normal_equations_cuda(*(a[k] for a in args))
        for g_, w_, l_ in zip(got, want, lone):
            assert torch.equal(g_[k].view(torch.int32),
                               w_[k].contiguous().view(torch.int32))
            assert torch.equal(l_.view(torch.int32),
                               g_[k].contiguous().view(torch.int32))


def _ne_args(m, batch, device, layout):
    """Seeded (jv, jw, j, wr) of ``batch`` lanes of ``m`` rows: row-major
    ("contiguous"), j column-major ("strided", read one float at a time),
    or every operand one float into its buffer ("offset")."""
    g = torch.Generator().manual_seed(m)
    j = torch.randn(batch, m, 7, generator=g)
    w = torch.rand(batch, m, 1, generator=g) * (
        torch.rand(batch, m, 1, generator=g) < 0.9)
    r = torch.randn(batch, m, generator=g)
    args = [(j != 0) * j, j * w, j, w[..., 0] * r]
    args = [a.to(device) for a in args]
    if layout == "strided":
        args[2] = args[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "offset":
        for i, a in enumerate(args):
            buf = torch.empty(a.numel() + 1, device=device)
            args[i] = buf[1:].view(a.shape)
            args[i].copy_(a)
    return args


def _assert_kernel_is_plain_and_lanes_lone(args):
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
    from lidar_feature_extraction_tpu_torch.ops.normal_equations_cuda import (
        normal_equations_cuda)

    got = normal_equations_cuda(*args)
    want = xd.normal_equations_plain(*args)
    for k in range(args[0].shape[0]):
        lone = normal_equations_cuda(*(a[k] for a in args))
        for g_, w_, l_ in zip(got, want, lone):
            assert torch.equal(g_[k].view(torch.int32),
                               w_[k].contiguous().view(torch.int32))
            assert torch.equal(l_.view(torch.int32),
                               g_[k].contiguous().view(torch.int32))


@pytest.mark.parametrize("m", [1, 7, 49, 50, 64, 65, 100, 352, 353, 2047,
                               4095, 4096])
def test_normal_equations_kernel_small_rows_match_plain_version(cuda, m):
    """The gradient's loops under 4,096 rows (ROADMAP §C22: one product,
    the scalar chain, the vector loop of 2 and 4 registers unrolled
    whole or not, the epilogues) and the tiled loop from 4,096, on
    row-major operands read 16 bytes at a time."""
    _assert_kernel_is_plain_and_lanes_lone(_ne_args(m, 2, cuda, "contiguous"))


@pytest.mark.parametrize("layout", ["contiguous", "strided", "offset"])
def test_normal_equations_kernel_reads_any_layout(cuda, layout):
    """At 385 rows the second oneDNN half starts on row 193, off a 16-byte
    boundary: each layout's staged copies bit-equal to the plain
    version."""
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd

    m = 385
    assert any(lo * 28 % 16 for blk in xd.contraction_tree(m)[1]
               for lo, _ in blk)
    _assert_kernel_is_plain_and_lanes_lone(_ne_args(m, 3, cuda, layout))


def test_normal_equations_kernel_equals_the_record(cuda):
    """The kernel on the drive record's seeded problems (under and over
    4,096 rows) and the cut-width scenes' first updates gives the JAX
    package's bits (tests/data/torch_reference_drive.npz)."""
    import reference_cases as rc
    from lidar_feature_extraction_tpu_torch.ops.normal_equations_cuda import (
        normal_equations_cuda)

    arrays, manifest = rc.load_drive()
    for m in (*rc.NE_SMALL_ROWS, *rc.NE_ROWS):
        got = normal_equations_cuda(*(torch.as_tensor(a, device=cuda)
                                      for a in rc.ne_problem(m)))
        for g_, key in zip(got, "DAb"):
            want = arrays[f"normal_equations.{m}.{key}"]
            assert np.array_equal(g_.cpu().numpy().view(np.int32),
                                  want.view(np.int32)), (m, key)
    for scene in rc.CUT_SCENES:
        got = rc.cut_normal_equations(
            *(arrays[f"cut.{scene}.{k}"] for k in (
                "jac_rows", "res_rows", "valid", "weights")),
            manifest["cut_updates"][scene]["shape"], device="cuda")
        for g_, key in zip(got, "DAb"):
            assert np.array_equal(
                g_.cpu().numpy().view(np.int32),
                arrays[f"cut.{scene}.{key}"].view(np.int32)), (scene, key)


@pytest.mark.parametrize("layout", chip_smoke.FMA_LAYOUTS)
def test_fma_f32_kernel_matches_plain_version(cuda, layout):
    """csrc/fma_f32.cu against ``_xla_f32._fma_plain`` on the card, bit for
    bit (a NaN against a NaN), on chip_smoke's layouts: contiguous sizes
    around a float4's multiple, views off 16-byte alignment, a scalar or
    one broadcast element ``a``, [8192, 1] against [8192, 3], transposed
    and strided views, 8 dimensions that coalesce, empty operands (no
    launch)."""
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
    from lidar_feature_extraction_tpu_torch.ops.fma_cuda import fma_f32_cuda

    a, b, c = chip_smoke.fma_layout(layout, cuda)
    before = fma_f32_cuda.launches
    got = fma_f32_cuda(a, b, c)
    launched = fma_f32_cuda.launches - before
    want = xf._fma_plain(a, b, c)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous()
    assert gk.differing(got, want) == 0
    assert launched == int(want.numel() > 0)


def test_fma_f32_kernel_matches_plain_version_on_the_smoke_triples(cuda):
    """chip_smoke's ``fma_operands``: a million random triples of every
    magnitude, then signed zeros, subnormals, infinities, NaN, exact
    cancellations and halfway sums; also through ``xf.fma``, the port's
    call, which launches the kernel once."""
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
    from lidar_feature_extraction_tpu_torch.ops.fma_cuda import fma_f32_cuda

    a, b, c = chip_smoke.fma_operands(cuda)
    want = xf._fma_plain(a, b, c)
    assert gk.differing(fma_f32_cuda(a, b, c), want) == 0
    before = fma_f32_cuda.launches
    got = xf.fma(a, b, c)
    assert fma_f32_cuda.launches - before == 1
    assert gk.differing(got, want) == 0


def test_fma_f32_refuses_what_it_cannot_take(cuda):
    """A CPU tensor raises in the wrapper, a float64 CUDA tensor and
    shapes that do not broadcast in the operator; nothing falls back to
    the plain version."""
    from lidar_feature_extraction_tpu_torch.ops.fma_cuda import fma_f32_cuda

    x = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        fma_f32_cuda(x.cpu(), x.cpu(), x.cpu())
    with pytest.raises(RuntimeError, match="float32"):
        fma_f32_cuda(x, x.double(), x)
    with pytest.raises(RuntimeError, match="broadcast"):
        fma_f32_cuda(x, x, torch.ones(3, device=cuda))


# Past 32-bit indices and not a multiple of 4: 8 GiB an operand.
WIDE = (1 << 31) + 5


def _fma_matches_plain_in_slices(got, a, b, c, rows):
    """``got`` against ``_xla_f32._fma_plain`` bit for bit, ``rows`` rows
    of the first dimension at a time (the plain version's float64
    temporaries of the whole would not fit); ``a`` is a scalar or
    broadcasts along the first dimension where it has one row."""
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf

    n = got.shape[0]
    for lo in range(0, n, rows):
        part = slice(lo, lo + rows)
        a_part = a[part] if isinstance(a, torch.Tensor) and \
            a.shape[0] == n else a
        want = xf._fma_plain(a_part, b[part], c[part])
        assert gk.differing(got[part], want) == 0, lo


@pytest.mark.parametrize("layout", ["contiguous", "offset_b", "scalar_a",
                                    "scalar_a_offset_b", "element_a",
                                    "element_a_offset_b"])
def test_fma_f32_kernel_past_32_bit_indices(cuda, layout):
    """``WIDE`` elements of one dimension take the streaming kernel with
    64-bit indices: every operand 16-byte aligned (float4 loads and a
    scalar tail) or ``b`` one element off (scalar loads), with ``a``
    contiguous, a scalar or one broadcast element; bit for bit against
    the plain version."""
    from lidar_feature_extraction_tpu_torch.ops.fma_cuda import fma_f32_cuda

    g = torch.Generator(device=cuda).manual_seed(31)
    b = torch.randn(WIDE + 1, device=cuda, generator=g)
    b = b[1:] if layout.endswith("offset_b") else b[:WIDE]
    c = torch.randn(WIDE, device=cuda, generator=g)
    if layout.startswith("scalar_a"):
        a = -1.5
    elif layout.startswith("element_a"):
        a = torch.randn(1, device=cuda, generator=g)
    else:
        a = torch.randn(WIDE, device=cuda, generator=g)
    got = fma_f32_cuda(a, b, c)
    assert got.shape == (WIDE,)
    _fma_matches_plain_in_slices(got, a, b, c, 1 << 26)


def test_fma_f32_kernel_past_32_bit_indices_with_a_broadcast_column(cuda):
    """A row block's layout (``a`` [rows, 1] against [rows, 3]) over more
    than 2^31 elements takes the strided kernel with 64-bit indices and
    a 64-bit divider; bit for bit against the plain version."""
    from lidar_feature_extraction_tpu_torch.ops.fma_cuda import fma_f32_cuda

    rows = -(-WIDE // 3)
    g = torch.Generator(device=cuda).manual_seed(32)
    a = torch.randn(rows, 1, device=cuda, generator=g)
    b = torch.randn(rows, 3, device=cuda, generator=g)
    c = torch.randn(rows, 3, device=cuda, generator=g)
    got = fma_f32_cuda(a, b, c)
    assert got.shape == (rows, 3)
    _fma_matches_plain_in_slices(got, a, b, c, 1 << 24)


@pytest.mark.parametrize("a_shape", [(3, 7, 5), (1, 7, 1)])
def test_fma_f32_kernel_past_32_bit_offsets(cuda, a_shape):
    """A [3, 7, 5] view whose rows lie 2^30 elements apart in one 8 GiB
    buffer (its last offset past 2^31) against a [3, 7, 5] or a
    broadcast [1, 7, 1] ``a``: the strided kernel with 64-bit offsets and
    two 64-bit dividers (its inner dimensions do not merge); bit for bit
    against the plain version."""
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
    from lidar_feature_extraction_tpu_torch.ops.fma_cuda import fma_f32_cuda

    g = torch.Generator(device=cuda).manual_seed(33)
    buf = torch.randn(2 * (1 << 30) + 7 * 8, device=cuda, generator=g)
    b = buf.as_strided((3, 7, 5), (1 << 30, 8, 1))
    a = torch.randn(a_shape, device=cuda, generator=g)
    c = torch.randn(3, 7, 5, device=cuda, generator=g)
    got = fma_f32_cuda(a, b, c)
    assert gk.differing(got, xf._fma_plain(a, b, c)) == 0


def _gn_kernel_args(m, batch, device):
    import gn_kernels_check as gk

    return [torch.as_tensor(a, device=device)
            for a in gk.gn_update_case(m, batch)]


@pytest.mark.parametrize("batch", [1, 8, 32, 132, 133])
@pytest.mark.parametrize("m", [2047, 10240, 14336])
def test_gn_update_kernel_matches_plain_version(cuda, m, batch):
    """csrc/gn_update.cu against ``_xla_dot.gn_update_plain`` on the card,
    bit for bit (a NaN against a NaN), on gn_kernels_check's seeded normal
    equations (the edge cases in a batch's first eight lanes), each lane
    equal to its lone launch."""
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
    from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
        gn_update_cuda)

    args = _gn_kernel_args(m, batch, cuda)
    got = gn_update_cuda(*args, gk.TAU)
    zero = dict.fromkeys(gk.GN_OUTPUTS, 0)
    assert gk.compare(got, xd.gn_update_plain(*args, gk.TAU),
                      gk.GN_OUTPUTS) == zero
    for lane in range(batch):
        lone = gn_update_cuda(*(a[lane] for a in args), gk.TAU)
        assert gk.compare([g[lane] for g in got], lone,
                          gk.GN_OUTPUTS) == zero, lane


def test_gn_update_kernel_reads_strided_operands(cuda):
    """D, A and b as the normal_equations operator returns them (views of
    one [B, 105] buffer) and q, t as column views: read through their
    strides, the same bits as contiguous copies."""
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
        gn_update_cuda)

    D, A, b, q, t = _gn_kernel_args(10240, 8, cuda)
    buf = torch.cat([D.flatten(1), A.flatten(1), b], dim=1)
    pose = torch.cat([q, t], dim=1).t().contiguous().t()
    views = (buf[:, :49].view(8, 7, 7), buf[:, 49:98].view(8, 7, 7),
             buf[:, 98:], pose[:, :4], pose[:, 4:])
    assert not any(v.is_contiguous() for v in views)
    want = gn_update_cuda(D, A, b, q, t, gk.TAU)
    assert gk.compare(gn_update_cuda(*views, gk.TAU), want,
                      gk.GN_OUTPUTS) == dict.fromkeys(gk.GN_OUTPUTS, 0)


@pytest.mark.parametrize("medians", [False, True], ids=["step", "loop"])
@pytest.mark.parametrize("n,batch", [(n, b) for n in (1, 33, 2047, 10240,
                                                      14336, 81920)
                                     for b in (1, 8, 32)]
                         + [(131073, 1), (65537, 8), (32769, 16),
                            (32769, 32)])
def test_robust_weights_kernel_matches_plain_version(cuda, n, batch,
                                                     medians):
    """csrc/robust_weights.cu against ``stats.robust_weights_plain`` on the
    card, bit for bit (a NaN against a NaN), on gn_kernels_check's seeded
    errors (the edge cases in a batch's first eight lanes, lane 7 on the
    first round's thresholds; the last four sizes one error past what
    their launch's cluster holds in shared memory, gk.RW_CLUSTER_CASES),
    each lane equal to its lone launch."""
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.core import stats
    from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
        robust_weights_cuda)

    errors, valid, shape = gk.robust_weights_case(n, batch)
    errors = torch.as_tensor(errors, device=cuda)
    valid = torch.as_tensor(valid, device=cuda)
    got = robust_weights_cuda(errors, valid, shape, gk.HUBER_K, medians)
    want = stats.robust_weights_plain(errors, valid, shape, gk.HUBER_K,
                                      medians)
    zero = dict.fromkeys(gk.RW_OUTPUTS, 0)
    assert gk.compare(got, want, gk.RW_OUTPUTS) == zero
    for lane in range(batch):
        lone = robust_weights_cuda(errors[lane], valid[lane], shape,
                                   gk.HUBER_K, medians)
        assert gk.compare([None if g is None else g[lane] for g in got],
                          lone, gk.RW_OUTPUTS) == zero, lane


def test_gn_iteration_on_the_card_launches_each_kernel_once(cuda):
    """A float32 GN iteration on CUDA tensors is one launch each of
    robust_weights, normal_equations and gn_update (the fused loop's too,
    with the block medians), with the CPU's bits; a float64 CUDA tensor is
    refused by both new kernels."""
    from lidar_feature_extraction_tpu_torch.core.pose import Pose as P
    from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
    from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
        gn_update_cuda, robust_weights_cuda)
    from lidar_feature_extraction_tpu_torch.ops.normal_equations_cuda import (
        normal_equations_cuda)

    rng = np.random.default_rng(5)
    n = 300
    cpu = gn.Problem(
        jac_rows=torch.as_tensor(np.float32(rng.normal(size=(n, 7)))),
        res_rows=torch.as_tensor(np.float32(rng.normal(size=n) * 0.1)),
        errors=torch.as_tensor(np.float32(rng.exponential(size=n))),
        valid=torch.as_tensor(rng.random(n) < 0.9), shape=((100, 1),
                                                          (200, 1)))
    card = gn.Problem(*(x.to(cuda) for x in cpu[:4]), shape=cpu.shape)
    pose = P(torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3))
    counters = (robust_weights_cuda, normal_equations_cuda, gn_update_cuda)
    before = [c.launches for c in counters]
    got = gn.run_gauss_newton(lambda p: card, P(pose.q.to(cuda),
                                                 pose.t.to(cuda)), 3)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == [int(got.iterations)] * 3
    want = gn.run_gauss_newton(lambda p: cpu, pose, 3)
    for g, w in ((got.pose.q, want.pose.q), (got.pose.t, want.pose.t),
                 (got.error, want.error), (got.scale, want.scale),
                 (got.hessian, want.hessian),
                 (got.block_errors, want.block_errors)):
        assert torch.equal(g.cpu().contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32))
    assert int(got.status) == int(want.status)
    with pytest.raises(RuntimeError, match="float32"):
        robust_weights_cuda(card.errors.double(), card.valid, card.shape)
    with pytest.raises(RuntimeError, match="float32"):
        gn_update_cuda(*(torch.zeros(s, dtype=torch.float64, device=cuda)
                         for s in ((7, 7), (7, 7), (7,), (4,), (3,))), 0.1)


# ---- lu_solve: the pose graph's dense float32 solve -----------------------

def _bits_equal_nan(got, want):
    """Bit for bit, a NaN equal to any NaN (the payload is the card's)."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(got)
    return torch.equal(nan, torch.isnan(want)) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32))


# The plain version runs on a CPU copy (its chains in numpy there).
_LU_CASES = [("random", 2), ("random", 3), ("random", 17),
             *((kind, n) for n in (48, 96, 192, 384, 768)
               for kind in ("spd", "random")),
             ("ties", 96), ("singular", 96), ("ties", 384),
             ("singular", 768)]


@pytest.mark.parametrize("kind,n", _LU_CASES,
                         ids=[f"{k}-{n}" for k, n in _LU_CASES])
def test_lu_solve_kernel_matches_plain_version(cuda, kind, n):
    from lidar_feature_extraction_tpu_torch.ops import lu_cuda

    if n < 6:
        rng = np.random.default_rng(n)
        a = torch.as_tensor(np.float32(rng.normal(size=(n, n))), device=cuda)
        b = torch.as_tensor(np.float32(rng.normal(size=n)), device=cuda)
    else:
        a, b = chip_smoke.lu_system(n, kind, cuda)
    before = lu_cuda.lu_solve_cuda.launches
    got = lu_cuda.lu_solve_cuda(a, b)
    assert lu_cuda.lu_solve_cuda.launches == before + 1
    assert _bits_equal_nan(got, lu_cuda.lu_solve_plain(a.cpu(), b.cpu()))
    # Several right-hand sides at once, each column as alone.
    rhs = torch.stack([b, 2 * b, -b], dim=1)
    cols = lu_cuda.lu_solve_cuda(a, rhs)
    assert _bits_equal_nan(cols, lu_cuda.lu_solve_plain(a.cpu(), rhs.cpu()))
    assert _bits_equal_nan(cols[:, 0], got)


def test_lu_solve_kernel_singular_and_batched(cuda):
    from lidar_feature_extraction_tpu_torch.ops import lu_cuda

    a, b = chip_smoke.lu_system(48, "spd", cuda)
    singular = a.clone()
    singular[:, 7] = 0.0                    # a zero pivot: no scaling
    nan = a.clone()
    nan[3, 3] = float("nan")
    systems = torch.stack([a, singular, nan, a + 1.0])
    rhs = torch.stack([b, b, b, -b])
    batch = lu_cuda.lu_solve_cuda(systems, rhs)
    for k in range(len(systems)):
        lone = lu_cuda.lu_solve_cuda(systems[k], rhs[k])
        assert _bits_equal_nan(batch[k], lone)
        assert _bits_equal_nan(lone, lu_cuda.lu_solve_plain(
            systems[k].cpu(), rhs[k].cpu()))
    with pytest.raises(ValueError, match="float32"):
        lu_cuda.lu_solve_cuda(a.double(), b.double())
    with pytest.raises(ValueError, match="CUDA"):
        lu_cuda.lu_solve_cuda(a.cpu(), b.cpu())


def test_pose_graph_float32_solve_launches_lu_solve(cuda):
    """The dense float32 pose graph on the card: one lu_solve launch per
    Gauss-Newton iteration, and the result of the plain solve's path on
    the card bit for bit."""
    from lidar_feature_extraction_tpu_torch.ops import lu_cuda
    from lidar_feature_extraction_tpu_torch.parallel import pose_graph as tpg

    graph, cons = chip_smoke.seeded_graph(cuda)
    before = lu_cuda.lu_solve_cuda.launches
    got = tpg.optimize_pose_graph(graph, cons, n_iterations=3,
                                  robust_delta=0.5)
    torch.cuda.synchronize()
    assert lu_cuda.lu_solve_cuda.launches == before + 3
    plain = lu_cuda.solve
    try:
        lu_cuda.solve = lu_cuda.lu_solve_plain
        want = tpg.optimize_pose_graph(graph, cons, n_iterations=3,
                                       robust_delta=0.5)
    finally:
        lu_cuda.solve = plain
    for g, w in zip(got, want):
        assert _bits_equal_nan(g, w)


def test_graph_linearizations_on_the_card_match_the_cpu(cuda):
    """The pose and IMU graphs' torch.func linearizations in float32 on
    the card against the CPU's (plain torch arithmetic both: the float32
    forms have no derivative on the card). Tolerance: 1e-5 of each
    Jacobian's largest entry (sin, cos and atan2 of two libraries)."""
    from lidar_feature_extraction_tpu_torch.parallel import imu_graph as tig
    from lidar_feature_extraction_tpu_torch.parallel import pose_graph as tpg

    rng = np.random.default_rng(9)
    m = 16
    q = rng.normal(size=(2, m, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(scale=10.0, size=(2, m, 3))
    v = rng.normal(size=(2, m, 3))
    dq = q[1] + rng.normal(scale=0.01, size=(m, 4))
    dq /= np.linalg.norm(dq, axis=-1, keepdims=True)
    pose_args = [np.float32(a) for a in (q[0], t[0], q[1], t[1], dq,
                                         t[1] - t[0])]
    imu_args = [np.float32(a) for a in (q[0], t[0], v[0], q[1], t[1], v[1],
                                        dq, v[1] - v[0], t[1] - t[0],
                                        np.full(m, 0.1))]
    for fn, args in ((tpg._linearize, pose_args),
                     (tig._linearize_imu, imu_args)):
        card = fn(*(torch.as_tensor(a, device=cuda) for a in args))
        cpu = fn(*map(torch.as_tensor, args))
        for g, w in zip(card, cpu):
            scale = float(w.abs().max())
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                       atol=1e-5 * scale)
