"""Kernel K1 and the normal equations' kernel on the card against their
plain PyTorch versions, and the paths
that run it (full extraction, one closed-loop scan, the odometry step,
IMU preintegration, the pose-graph and IMU-graph solvers, a short
mapping run with a loop closure, K1 at vlp16's widths against the CPU
and the full-width reference record, the chunked front end's one launch
per block, the batched localizer on every branch, the voxel-hash map)
against the CPU, their lone runs or the per-scan pipeline; and every
float scatter-add of the port giving the same bits on two calls (ROADMAP
§C16).

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


@pytest.mark.parametrize("m", [7, 1000, 7991, 10243])
def test_normal_equations_kernel_matches_plain_version(cuda, m):
    """csrc/normal_equations.cu against ``_xla_dot.normal_equations_plain``
    on the card, bit for bit, for a batch of 3 read through strides and
    for its lanes alone (ROADMAP §C21)."""
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
