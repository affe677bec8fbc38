"""Kernel K1 on the card against its plain PyTorch version.

Needs a CUDA device and ``nvcc``; every test here is marked ``gpu`` and
skips elsewhere. The file imports neither JAX nor the JAX package, so on
a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

Tolerances: labels, curvature and compaction columns bit-equal (both
round every operation as written, in the same order).
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
