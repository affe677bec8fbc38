"""Kernel K1 on the card against its plain PyTorch version.

Needs a CUDA device and ``nvcc``; every test here is marked ``gpu`` and
skips elsewhere. The file imports neither JAX nor the JAX package, so on
a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m gpu

Tolerances: labels and compaction columns bit-equal; curvature bit-equal
too (both round every operation as written, in the same order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lidar_feature_extraction_tpu_torch.config import (  # noqa: E402
    ExtractionConfig, kitti_hdl64)
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
         "round_cap_hit")


def _case(name):
    """(xyz [R, P, 3] float32, count [R], ExtractionConfig) of a case."""
    rng = np.random.default_rng(0)
    kitti = kitti_hdl64().extraction
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
