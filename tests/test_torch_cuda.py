"""Kernel K1 on the card against its plain PyTorch version, and the paths
that run it (full extraction, one closed-loop scan) against the CPU.

Needs a CUDA device and ``nvcc``; every test here is marked ``gpu`` and
skips elsewhere. The file imports neither JAX nor the JAX package, so on
a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

Tolerances: labels, curvature and compaction columns bit-equal (both
round every operation as written, in the same order); the full
extraction on the card equal to it on the CPU; one closed-loop scan on
the card within 1e-4 of it on the CPU, with the same GN status and
iterations (sums run in another order on the card).
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
    and equals the plain path on the CPU: labels and the compacted edge
    and surface points exactly; the curvature as |acc| = sqrt(c) to
    within 4 * padding ulp of the largest range, because the CPU build
    of torch may contract ``x*x + y*y`` into an FMA where the card (and
    K1) round each operation."""
    xyz, count, cfg = _case(case)
    mask = np.arange(xyz.shape[1])[None, :] < count[:, None]
    before = extraction_cuda.label_and_columns_cuda.launches
    got = tex.extract_features(range_image_from_numpy(xyz, mask, count,
                                                      device=cuda), cfg)
    assert extraction_cuda.label_and_columns_cuda.launches == before + 1
    want = tex.extract_features(range_image_from_numpy(xyz, mask, count,
                                                       device="cpu"), cfg)
    for name in set(want._fields) - {"curvature"}:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    rng_max = float(np.linalg.norm(xyz[..., :2], axis=-1)[mask].max())
    atol = 4 * cfg.padding * float(np.spacing(np.float32(rng_max)))
    assert float((got.curvature.cpu().sqrt() - want.curvature.sqrt())
                 .abs().max()) <= atol


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
