"""Port parity of the voxel-hash point map (``ops/voxel_map.py``): the
table build and the 27-voxel kNN against the JAX package's
``build_voxel_map`` / ``knn`` on the same seeded inputs, the reference's
own checks of the map (tests/test_registration_ops.py ``TestVoxelMap``,
tests/test_voxel_grid.py) run on the port, and the hash map behind
``lookup_knn`` and the residuals.

The cases are the reference tests' inputs, in float64 (the reference's
tests run with x64). Tolerances: table keys, slot points, occupancies,
neighbours and validity exactly (integer hashing, a stable sort and
copies); squared distances within 1e-6 relative (XLA:CPU contracts the
difference-square-sum into fused multiply-adds, torch rounds every
operation). The residual rows through the hash map and through the dense
grid exactly (the same candidates in the same order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import to_np  # noqa: E402
from lidar_feature_extraction_tpu.ops import voxel_map as jvm  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import residuals as tres  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import voxel_grid as tvg  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import voxel_map as tvm  # noqa: E402

jax.config.update("jax_enable_x64", True)   # as the reference's tests
SQ_RTOL = 1e-6


def _uniform(seed, lo, hi, n, nq, qlo, qhi):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, size=(n, 3))
    return pts, np.ones(n, bool), rng.uniform(qlo, qhi, size=(nq, 3))


# name -> (points, mask, queries, voxel_size, capacity, slots,
# max_probes, k): the reference tests' inputs.
CASES = {
    # test_registration_ops.py:77 knn_matches_bruteforce_within_neighborhood
    "bruteforce": lambda: (*_uniform(0, -20, 20, 5000, 64, -18, 18),
                           2.0, 1 << 14, 16, 16, 5),
    # :101 knn_exact_when_dense_slots
    "dense_slots": lambda: (*_uniform(1, 0, 10, 800, 32, 1, 9),
                            2.5, 1 << 12, 64, 16, 4),
    # :117 mask_respected
    "mask": lambda: (np.array([[0.0, 0, 0], [5, 5, 5]]),
                     np.array([True, False]), np.array([[5.0, 5, 5]]),
                     1.0, 64, 4, 16, 1),
    # :125 capacity_overflow_drops_not_corrupts (queries: the points)
    "overflow": lambda: (lambda p, m, _: (p, m, p[:64]))(
        *_uniform(2, -50, 50, 2000, 0, 0, 1)) + (1.0, 256, 2, 8, 3),
    # test_voxel_grid.py:24 grid_knn_matches_hash_knn
    "grid_knn": lambda: (*_uniform(0, -20, 20, 3000, 128, -18, 18),
                         2.0, 1 << 14, 16, 16, 8),
    # test_voxel_grid.py:73 hash_candidates_match_grid_candidates
    "grid_candidates": lambda: (*_uniform(4, -15, 15, 1500, 32, -12, 12),
                                2.0, 1 << 14, 16, 16, 5),
}


@pytest.fixture(scope="module")
def maps():
    """Per case: the inputs, the reference's map and kNN, the port's."""
    out = {}
    for name, make in CASES.items():
        pts, mask, q, vs, cap, slots, probes, k = make()
        jmap = jvm.build_voxel_map(jnp.asarray(pts), jnp.asarray(mask), vs,
                                   cap, slots, probes)
        tmap = tvm.build_voxel_map(torch.as_tensor(pts),
                                   torch.as_tensor(mask), vs, cap, slots,
                                   probes)
        out[name] = dict(
            pts=pts, q=q, vs=vs, slots=slots, k=k, jmap=jmap, tmap=tmap,
            want=jvm.knn(jmap, jnp.asarray(q), k, probes),
            got=tvm.knn(tmap, torch.as_tensor(q), k, probes))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_voxel_map_matches_reference(maps, name):
    """Keys bucket for bucket, slot points, occupancies exactly."""
    c = maps[name]
    for field in ("keys", "points", "n_pts", "origin"):
        np.testing.assert_array_equal(to_np(getattr(c["tmap"], field)),
                                      np.asarray(getattr(c["jmap"], field)),
                                      err_msg=field)
    assert c["tmap"].keys.dtype == torch.int32
    assert c["tmap"].n_pts.dtype == torch.int32


@pytest.mark.parametrize("name", sorted(CASES))
def test_knn_matches_reference(maps, name):
    """The same neighbours in the same order, validity exactly, squared
    distances within 1e-6 relative."""
    c = maps[name]
    (gn, gsq, gv), (wn, wsq, wv) = c["got"], c["want"]
    np.testing.assert_array_equal(to_np(gv), np.asarray(wv))
    np.testing.assert_array_equal(to_np(gn), np.asarray(wn))
    v = np.asarray(wv)
    np.testing.assert_allclose(to_np(gsq)[v], np.asarray(wsq)[v],
                               rtol=SQ_RTOL, atol=0)
    assert np.isinf(to_np(gsq)[~v]).all()


def test_knn_neighbours_are_map_points_in_ascending_order(maps):
    """The reference's bruteforce case on the port: every valid neighbour
    is a map point at its reported distance, distances ascend."""
    c = maps["bruteforce"]
    nbrs, sq, valid = map(to_np, c["got"])
    for i, q in enumerate(c["q"]):
        for j in np.flatnonzero(valid[i]):
            assert np.sum((c["pts"] - nbrs[i, j]) ** 2, axis=-1).min() \
                < 1e-12
            np.testing.assert_allclose(np.sum((nbrs[i, j] - q) ** 2),
                                       sq[i, j], rtol=1e-9)
        assert (np.diff(sq[i, valid[i]]) >= -1e-12).all()


def test_knn_is_exact_within_a_voxel_with_dense_slots(maps):
    c = maps["dense_slots"]
    _, sq, valid = map(to_np, c["got"])
    for i, q in enumerate(c["q"]):
        d = np.linalg.norm(c["pts"] - q, axis=-1)
        want = np.sort(d[d <= c["vs"]])[:c["k"]]
        got = np.sqrt(sq[i][valid[i]])
        m = min(len(want), len(got))
        assert m >= 1
        np.testing.assert_allclose(got[:m], want[:m], rtol=1e-9)


def test_masked_point_is_not_found(maps):
    assert not bool(maps["mask"]["got"][2][0, 0])


def test_capacity_overflow_keeps_the_table_consistent(maps):
    m = maps["overflow"]["tmap"]
    assert int(m.n_pts.max()) <= 2
    occ = to_np(m.keys)[to_np(m.keys) != tvm._EMPTY]
    assert len(np.unique(occ)) == len(occ) > 0


def _grid(pts, vs, slots):
    origin, dims = tvg.grid_for_bounds(pts.min(0), pts.max(0), vs)
    return tvg.build_voxel_grid(torch.as_tensor(pts),
                                torch.ones(len(pts), dtype=torch.bool), vs,
                                origin, dims, slots)


@pytest.mark.parametrize("name", ["grid_knn", "grid_candidates"])
def test_hash_map_knn_equals_dense_grid_knn(maps, name):
    """The hash map's candidates and kNN against the port's dense grid
    over the same points: the same validity and squared distances."""
    c = maps[name]
    grid = _grid(c["pts"], c["vs"], c["slots"])
    q = torch.as_tensor(c["q"])
    cand, ok = tvm.neighborhood_candidates(c["tmap"], q)
    via_cand = tvg.topk_from_candidates(cand, ok, q, c["k"])
    want = tvg.knn(grid, q, c["k"])
    for got in (c["got"], via_cand):
        assert torch.equal(got[2], want[2])
        assert torch.equal(got[1][got[2]], want[1][want[2]])


def test_residuals_through_the_hash_map_equal_the_dense_grids():
    """``lookup_knn`` dispatches on the hash map: the edge and surface
    rows of a scan through it equal those through the dense grid, and a
    batch of queries [B, Q, 3] gives each lane its lone rows."""
    rng = np.random.default_rng(6)
    pts = rng.uniform(-10, 10, size=(4000, 3))
    hmap = tvm.build_voxel_map(torch.as_tensor(pts),
                               torch.ones(4000, dtype=torch.bool), 1.5,
                               1 << 13, 16)
    grid = _grid(pts, 1.5, 16)
    scan = torch.as_tensor(rng.uniform(-8, 8, size=(2, 300, 3)))
    valid = torch.ones(2, 300, dtype=torch.bool)
    yaw = 0.05
    q = torch.tensor([[np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                      [1.0, 0, 0, 0]], dtype=torch.float64)
    t = torch.tensor([[0.1, -0.2, 0.05], [0.0, 0.3, 0.0]],
                     dtype=torch.float64)
    for fn in (tres.edge_residuals, tres.surface_residuals):
        got = fn(hmap, scan, valid, Pose(q, t), 5)
        want = fn(grid, scan, valid, Pose(q, t), 5)
        assert int(got.valid.sum()) > 100
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for b in range(2):
            lone = fn(hmap, scan[b], valid[b], Pose(q[b], t[b]), 5)
            for a, lane in zip(lone, got):
                assert torch.equal(a, lane[b])
