"""Port parity of the faithful (kNN) registration path: voxel
downsampling, dense voxel grids, kNN, the small solves and line/plane
fits, and registration against point maps and precomputed-geometry maps
with the surface downsample, on the street scene cut to 16 x 576.

Tolerances:
- ``voxel_downsample``: validity exact, centroids rtol 1e-6 (the same
  sums, possibly in another order);
- ``build_voxel_grid``: points and occupancy exact (values are moved,
  not computed);
- ``knn``: neighbour sets and their order exact, squared distances
  rtol 1e-6;
- ``solve3x3_sym`` and the fits: rtol 1e-5 on well-conditioned inputs
  (Jacobians with an absolute floor of 1e-5 of their largest entry);
- registration: Gauss-Newton status and iteration count equal, pose
  within 1e-4 (translation, m) and 1e-4 (quaternion components).
  The kNN registrations run with the maps and the prior in float64:
  the reference's float32 plane fit X w = -1 solves normal equations
  whose condition number grows with the square of a neighbourhood's
  distance from the origin over its size, so in float32 its fits of
  far neighbourhoods are rounding noise, different in every
  implementation. In float64 both agree to the tolerance above.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import np32, t32, to_np  # noqa: E402
from lidar_feature_extraction_tpu.config import (  # noqa: E402
    kitti_hdl64 as j_kitti)
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.core.scan import (  # noqa: E402
    RangeImage as JImage)
from lidar_feature_extraction_tpu.ops import downsample as jds  # noqa: E402
from lidar_feature_extraction_tpu.ops import residuals as jres  # noqa: E402
from lidar_feature_extraction_tpu.ops import smallalg as jsa  # noqa: E402
from lidar_feature_extraction_tpu.ops import voxel_grid as jvg  # noqa: E402
from lidar_feature_extraction_tpu.ops.extraction import (  # noqa: E402
    extract_features as j_extract)
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    localization as jloc)
from lidar_feature_extraction_tpu_torch.config import (  # noqa: E402
    kitti_hdl64 as t_kitti)
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.interop import (  # noqa: E402
    feature_maps_from_numpy, range_image_from_numpy)
from lidar_feature_extraction_tpu_torch.ops import downsample as tds  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import residuals as tres  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import smallalg as tsa  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import voxel_grid as tvg  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops.extraction import (  # noqa: E402
    extract_features as t_extract)
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    localization as tloc)
from lidar_feature_extraction_tpu_torch.utils.synthetic import (  # noqa: E402
    street_scan, street_world, to_world)

# The float64 references need x64 (the whole suite runs with it on:
# test_extraction turns it on at import, as test_ekf does).
jax.config.update("jax_enable_x64", True)

R, P = 16, 576
T_ATOL = 1e-4
Q_ATOL = 1e-4


def _cloud(rng, n=3000):
    """Points in clusters a few metres across (so voxels hold several),
    with a random mask; float32."""
    centers = rng.uniform(-6, 6, size=(40, 3))
    pts = centers[rng.integers(0, 40, n)] + rng.normal(scale=0.4,
                                                       size=(n, 3))
    return np32(pts), rng.random(n) < 0.9


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("capacity", [64, 2048])
def test_voxel_downsample_matches_reference(dense, capacity):
    rng = np.random.default_rng(capacity)
    xyz, mask = _cloud(rng)
    if dense:
        kw = dict(grid_dims=(40, 40, 40))
        want = jds.voxel_downsample_dense(jnp.asarray(xyz), jnp.asarray(mask),
                                          0.7, capacity, **kw)
        got = tds.voxel_downsample_dense(t32(xyz), torch.as_tensor(mask),
                                         0.7, capacity, **kw)
    else:
        want = jds.voxel_downsample(jnp.asarray(xyz), jnp.asarray(mask), 0.7,
                                    capacity)
        got = tds.voxel_downsample(t32(xyz), torch.as_tensor(mask), 0.7,
                                   capacity)
    np.testing.assert_array_equal(to_np(got[1]), np.asarray(want[1]))
    # 64 slots overflow (voxels dropped); 2048 do not.
    assert (int(np.asarray(want[1]).sum()) == capacity) == (capacity == 64)
    np.testing.assert_allclose(to_np(got[0]), np32(want[0]), rtol=1e-6,
                               atol=1e-6)


def _grid_args(xyz, mask, voxel, slots):
    lo, hi = xyz[mask].min(0), xyz[mask].max(0)
    origin, dims = jvg.grid_for_bounds(lo, hi, voxel)
    return (voxel, origin, dims, slots)


@pytest.mark.parametrize("slots", [2, 8])
def test_build_voxel_grid_is_exact(slots):
    xyz, mask = _cloud(np.random.default_rng(slots))
    args = _grid_args(xyz, mask, 1.0, slots)
    want = jvg.build_voxel_grid(jnp.asarray(xyz), jnp.asarray(mask), *args)
    got = tvg.build_voxel_grid(t32(xyz), torch.as_tensor(mask), *args)
    cap = want.capacity     # the dump row is not part of the contract
    np.testing.assert_array_equal(to_np(got.n_pts)[:cap],
                                  np.asarray(want.n_pts)[:cap])
    np.testing.assert_array_equal(to_np(got.points)[:cap],
                                  np32(want.points)[:cap])
    assert got.dims == tuple(int(d) for d in want.dims)


@pytest.mark.parametrize("k", [5, 15])
def test_knn_neighbours_and_order_are_exact(k):
    """Queries on and between map points: many ties (masked candidates
    at +inf, duplicated points) that the order must break like
    lax.top_k, by the lower candidate index."""
    rng = np.random.default_rng(k)
    xyz, mask = _cloud(rng)
    xyz[100:150] = xyz[50:100]                  # exact duplicates
    args = _grid_args(xyz, mask, 1.0, 8)
    jg = jvg.build_voxel_grid(jnp.asarray(xyz), jnp.asarray(mask), *args)
    tg = tvg.build_voxel_grid(t32(xyz), torch.as_tensor(mask), *args)
    q = np32(np.concatenate([xyz[:200], xyz[:200] + rng.normal(
        scale=0.3, size=(200, 3)), rng.uniform(-30, 30, size=(20, 3))]))
    want = jvg.knn(jg, jnp.asarray(q), k)
    got = tvg.knn(tg, t32(q), k)
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(to_np(got[0]), np32(want[0]))
    v = np.asarray(want[2])
    np.testing.assert_allclose(to_np(got[1])[v], np32(want[1])[v],
                               rtol=1e-6, atol=1e-12)
    assert np.all(np.isinf(to_np(got[1])[~v]))
    assert v.any() and (~v).any()


def _spd(rng, n):
    a = rng.normal(size=(n, 3, 3))
    return np32(a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(3)), \
        np32(rng.normal(size=(n, 3)))


def test_solve3x3_sym_matches_reference():
    a, b = _spd(np.random.default_rng(0), 256)
    want = np32(jsa.solve3x3_sym(jnp.asarray(a), jnp.asarray(b)))
    got = to_np(tsa.solve3x3_sym(t32(a), t32(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _neighbourhoods(rng, n=128, k=15):
    """Noisy line and plane patches near the origin with a few invalid
    neighbours: (line_nbrs, plane_nbrs, valid, scan points)."""
    t = rng.uniform(-1, 1, size=(n, k, 1))
    d = rng.normal(size=(n, 1, 3))
    c = rng.uniform(-3, 3, size=(n, 1, 3))
    line = c + t * d + rng.normal(scale=0.01, size=(n, k, 3))
    uv = rng.uniform(-1, 1, size=(n, k, 2))
    plane = np.concatenate([uv, -1.5 + 0.1 * uv[..., :1]
                            + rng.normal(scale=0.01, size=(n, k, 1))], -1)
    valid = rng.random((n, k)) < 0.85
    valid[:4, :] = False                       # starved neighbourhoods
    pts = c[:, 0] + rng.normal(scale=0.1, size=(n, 3))
    return np32(line), np32(plane), valid, np32(pts)


_Q, _T = np32([0.99, 0.02, -0.03, 0.1]), np32([0.3, -0.2, 0.05])
_Q = np32(_Q / np.linalg.norm(_Q))


@pytest.mark.parametrize("name", ["masked_mean_and_cov", "fit_plane",
                                  "edge_rows_from_neighbors",
                                  "surface_rows_from_neighbors"])
def test_fit_matches_reference(name):
    line, plane, valid, pts = _neighbourhoods(np.random.default_rng(1))
    nb = line if name.startswith(("edge", "masked")) else plane
    jpose, tpose = _MOVED
    jargs, targs = [jnp.asarray(nb), jnp.asarray(valid)], \
        [t32(nb), torch.as_tensor(valid)]
    if "rows" in name:
        sv = np.ones(len(pts), bool)
        sv[5] = False
        jargs += [jnp.asarray(pts), jnp.asarray(sv), jpose, 5]
        targs += [t32(pts), torch.as_tensor(sv), tpose, 5]
    want = getattr(jres, name)(*jargs)
    got = getattr(tres, name)(*targs)
    if "rows" in name:
        _assert_rows_close(got, want, name.startswith("edge"))
        return
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np32(w), rtol=1e-5, atol=1e-5)


def _grid_and_queries(kind):
    """A map of line (edge) or plane (surface) points in both
    implementations' voxel grids, and query points near it."""
    if kind == "edge":
        rng = np.random.default_rng(2)
        nb = _neighbourhoods(rng)[0].reshape(-1, 3)
    else:
        # A sparse tilted plane whose neighbourhoods are wide against
        # their distance from the origin: X w = -1 stays well
        # conditioned (see the module docstring).
        rng = np.random.default_rng(3)
        uv = rng.uniform(-1, 1, size=(50, 2))
        nb = np32(np.concatenate([uv, -0.3 + 0.1 * uv[:, :1] + rng.normal(
            scale=0.01, size=(50, 1))], -1))
    m = np.ones(len(nb), bool)
    args = _grid_args(nb, m, 1.0, 8)
    jg = jvg.build_voxel_grid(jnp.asarray(nb), jnp.asarray(m), *args)
    tg = tvg.build_voxel_grid(t32(nb), torch.as_tensor(m), *args)
    step = 15 if kind == "edge" else 1
    q = np32(nb[::step] + rng.normal(scale=0.05, size=(len(nb[::step]), 3)))
    return jg, tg, q, np.ones(len(q), bool)


def _assert_rows_close(got, want, edge: bool):
    """Residual blocks equal to rtol 1e-5; an edge row may come with the
    opposite sign of the line's direction, which flips its residual and
    Jacobian together."""
    if edge:
        s = np.sign(np.sum(np32(want.residual) * to_np(got.residual), -1))
        s = np.where(s == 0, 1.0, s)
        got = got._replace(residual=got.residual * t32(s)[:, None],
                           jacobian=got.jacobian * t32(s)[:, None, None])
    np.testing.assert_array_equal(to_np(got.valid), np.asarray(want.valid))
    np.testing.assert_allclose(to_np(got.residual), np32(want.residual),
                               rtol=1e-5, atol=1e-5)
    # A Jacobian entry sums products of terms up to ~10: a small entry
    # carries their rounding, hence the floor of 1e-5 of the largest.
    jac = np32(want.jacobian)
    np.testing.assert_allclose(to_np(got.jacobian), jac, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(jac).max()))


_MOVED = (JPose(jnp.asarray(_Q), jnp.asarray(_T)), Pose(t32(_Q), t32(_T)))


@pytest.mark.parametrize("kind", ["edge", "surface"])
def test_fitted_geometry_rows_match_reference(kind):
    """Candidates from a grid, top-k, fit, then the per-iteration rows."""
    jg, tg, q, sv = _grid_and_queries(kind)
    jpose = JPose(jnp.asarray([1.0, 0, 0, 0], jnp.float32),
                  jnp.zeros(3, jnp.float32))
    tpose = Pose.identity(device="cpu")
    jc = jvg.neighborhood_candidates(jg, jnp.asarray(q))
    tc = tvg.neighborhood_candidates(tg, t32(q))
    jfit = getattr(jres, f"fit_{kind}_geometry")(
        *jc, jnp.asarray(q), jnp.asarray(sv), jpose, 8)
    tfit = getattr(tres, f"fit_{kind}_geometry")(
        *tc, t32(q), torch.as_tensor(sv), tpose, 8)
    np.testing.assert_array_equal(to_np(tfit.valid), np.asarray(jfit.valid))
    want = getattr(jres, f"{kind}_rows_from_geometry")(jfit, jnp.asarray(q),
                                                       _MOVED[0])
    got = getattr(tres, f"{kind}_rows_from_geometry")(tfit, t32(q),
                                                      _MOVED[1])
    _assert_rows_close(got, want, kind == "edge")


@pytest.mark.parametrize("kind", ["edge", "surface"])
def test_full_search_residuals_match_reference(kind):
    """kNN against the grid at a moved pose, then the rows."""
    jg, tg, q, sv = _grid_and_queries(kind)
    want = getattr(jres, f"{kind}_residuals")(
        jg, jnp.asarray(q), jnp.asarray(sv), _MOVED[0], 8)
    got = getattr(tres, f"{kind}_residuals")(
        tg, t32(q), torch.as_tensor(sv), _MOVED[1], 8)
    _assert_rows_close(got, want, kind == "edge")


def test_lookup_knn_dispatches_on_the_dense_grid():
    xyz, mask = _cloud(np.random.default_rng(3), 200)
    g = tvg.build_voxel_grid(t32(xyz), torch.as_tensor(mask),
                             *_grid_args(xyz, mask, 1.0, 4))
    got = tres.lookup_knn(g, t32(xyz[:10]), 3)
    want = tvg.knn(g, t32(xyz[:10]), 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(NotImplementedError,
                       match="DenseVoxelGrid and VoxelHashMap"):
        tres.lookup_knn(object(), t32(xyz[:10]), 3)


# --- registration on the street scene ---

def _cfgs(refit: bool):
    """kitti_hdl64 cut to 16 x 576, faithful variant (full extraction,
    point maps) with the given refit mode."""
    def cut(c):
        return dataclasses.replace(
            c, compact_extraction=False,
            extraction=dataclasses.replace(c.extraction, n_rings=R,
                                           max_points_per_ring=P),
            registration=dataclasses.replace(c.registration,
                                             refit_per_iteration=refit))
    return cut(j_kitti()), cut(t_kitti())


@pytest.fixture(scope="module")
def street():
    """The scan at the identity, the map clouds from 7 keyframes (each
    implementation's own extraction; equal), and the scan's features."""
    rng = np.random.default_rng(1)
    world = street_world(rng)
    jcfg, tcfg = _cfgs(False)
    mask, count = np.ones((R, P), bool), np.full(R, P, np.int32)
    edges, surfs, scan0 = [], [], None
    for k in range(7):
        o = (0.0, 0.0) if k == 0 else tuple(rng.uniform(-3, 3, 2) * [1, .3])
        yaw = 0.0 if k == 0 else float(rng.uniform(-0.05, 0.05))
        xyz = street_scan(world, rng, R, P, o, yaw)
        scan0 = xyz if k == 0 else scan0
        fj = j_extract(JImage(jnp.asarray(xyz), jnp.asarray(mask),
                              jnp.asarray(count)), jcfg.extraction)
        ft = t_extract(range_image_from_numpy(xyz, mask, count, "cpu"),
                       tcfg.extraction)
        for name in fj._fields:
            np.testing.assert_array_equal(to_np(getattr(ft, name)),
                                          np.asarray(getattr(fj, name)))
        edges.append(to_world(np32(fj.edge_xyz)[np.asarray(fj.edge_valid)],
                              o, yaw))
        surfs.append(to_world(np32(fj.surface_xyz)[
            np.asarray(fj.surface_valid)], o, yaw))
    return dict(scan=scan0, mask=mask, count=count,
                edge=np.concatenate(edges), surf=np.concatenate(surfs))


def _maps(street, cfgs, dtype):
    """The reference's maps of the street clouds in ``dtype``, and the
    port's built from the same clouds (checked equal to them)."""
    jcfg, tcfg = cfgs
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    e, s = street["edge"], street["surf"]
    jm = jloc.build_feature_maps(jnp.asarray(e, jd), jnp.ones(len(e), bool),
                                 jnp.asarray(s, jd), jnp.ones(len(s), bool),
                                 jcfg)
    tm = tloc.build_feature_maps(
        torch.as_tensor(e, dtype=dtype), torch.ones(len(e), dtype=torch.bool),
        torch.as_tensor(s, dtype=dtype), torch.ones(len(s), dtype=torch.bool),
        tcfg)
    for g in ("edge", "surface"):
        a, b = getattr(jm, g), getattr(tm, g)
        np.testing.assert_array_equal(to_np(b.points)[:a.capacity],
                                      np.asarray(a.points)[:a.capacity])
        np.testing.assert_array_equal(to_np(b.n_pts)[:a.capacity],
                                      np.asarray(a.n_pts)[:a.capacity])
    return jm, tm


def _features(street, cfgs):
    jcfg, _ = cfgs
    img = JImage(*(jnp.asarray(street[k]) for k in ("scan", "mask", "count")))
    f = j_extract(img, jcfg.extraction)
    return ((f.edge_xyz, f.edge_valid, f.surface_xyz, f.surface_valid),
            (t32(f.edge_xyz), torch.as_tensor(np.array(f.edge_valid)),
             t32(f.surface_xyz), torch.as_tensor(np.array(f.surface_valid))))


def _priors(dtype, noisy):
    q = np.array([1.0, 0.0, 0.0, 0.0])
    t = np.array([0.3, -0.2, 0.05])
    if noisy:
        rng = np.random.default_rng(7)
        d = rng.normal(size=3)
        t = t + 0.2 * d / np.linalg.norm(d)
        yaw = np.radians(1.0) * rng.normal()
        q = np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)])
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (JPose(jnp.asarray(q, jd), jnp.asarray(t, jd)),
            Pose(torch.as_tensor(q, dtype=dtype),
                 torch.as_tensor(t, dtype=dtype)))


def _assert_same_result(got, want):
    assert int(got.status) == int(want.status)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(to_np(got.pose.t), np.asarray(want.pose.t),
                               rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(to_np(got.pose.q), np.asarray(want.pose.q),
                               rtol=0, atol=Q_ATOL)


@pytest.mark.parametrize("refit, noisy", [(False, False), (False, True),
                                          (True, False)])
def test_register_scan_matches_reference(street, refit, noisy):
    cfgs = _cfgs(refit)
    jm, tm = _maps(street, cfgs, torch.float64)
    jf, tf = _features(street, cfgs)
    jp, tp = _priors(torch.float64, noisy)
    want = jloc.register_scan(jm, *jf, jp, cfgs[0])
    got = tloc.register_scan(tm, *tf, tp, cfgs[1])
    _assert_same_result(got, want)
    if not noisy:
        assert float(np.linalg.norm(to_np(got.pose.t))) < 0.1


def test_register_scan_on_carried_feature_maps(street):
    """The reference's own float32 maps carried across as numpy are the
    port's maps, and register the same."""
    cfgs = _cfgs(False)
    jm, tm = _maps(street, cfgs, torch.float32)
    maps = feature_maps_from_numpy(
        *(np.asarray(getattr(jm.edge, f)) for f in ("points", "n_pts",
                                                    "voxel_size", "origin")),
        jm.edge.dims,
        *(np.asarray(getattr(jm.surface, f)) for f in ("points", "n_pts",
                                                       "voxel_size",
                                                       "origin")),
        jm.surface.dims, device="cpu")
    assert maps.edge.dims == tm.edge.dims
    assert maps.surface.dims == tm.surface.dims
    _, tf = _features(street, cfgs)
    tp = _priors(torch.float32, False)[1]
    want = tloc.register_scan(tm, *tf, tp, cfgs[1])
    got = tloc.register_scan(maps, *tf, tp, cfgs[1])
    assert int(got.status) == int(want.status)
    assert torch.equal(got.pose.t, want.pose.t)


@pytest.mark.parametrize("noisy", [False, True])
def test_register_scan_geometry_with_surface_downsample(street, noisy):
    cfgs = _cfgs(False)
    jcfg, tcfg = cfgs
    e, s = street["edge"], street["surf"]
    jm = jloc.build_geometry_maps(
        jnp.asarray(np32(e)), jnp.ones(len(e), bool), jnp.asarray(np32(s)),
        jnp.ones(len(s), bool), jcfg)
    tm = tloc.build_geometry_maps(
        t32(e), torch.ones(len(e), dtype=torch.bool), t32(s),
        torch.ones(len(s), dtype=torch.bool), tcfg)
    jf, tf = _features(street, cfgs)
    jp, tp = _priors(torch.float32, noisy)
    want = jloc.register_scan_geometry(jm, *jf, jp, jcfg)
    got = tloc.register_scan_geometry(tm, *tf, tp, tcfg)
    _assert_same_result(got, want)


def test_localize_scan_and_host_localizer_full_extraction(street):
    """localize_scan's full-extraction branches for both map types are
    the port's extraction (equal to the reference's, see the fixture)
    followed by its registration (equal to the reference's, see the
    tests above); HostLocalizer gives the same results."""
    _, tcfg = _cfgs(False)
    tm = tloc.build_feature_maps(
        torch.as_tensor(street["edge"]),
        torch.ones(len(street["edge"]), dtype=torch.bool),
        torch.as_tensor(street["surf"]),
        torch.ones(len(street["surf"]), dtype=torch.bool), tcfg)
    tp = _priors(torch.float64, False)[1]
    img = range_image_from_numpy(street["scan"], street["mask"],
                                 street["count"], "cpu")
    got, feats = tloc.localize_scan(tm, img, tp, tcfg)
    want = tloc.register_scan(tm, feats.edge_xyz, feats.edge_valid,
                              feats.surface_xyz, feats.surface_valid, tp,
                              tcfg)
    assert int(got.status) == int(want.status)
    assert torch.equal(got.pose.t, want.pose.t)
    host = tloc.HostLocalizer(tm, tcfg)
    again, _ = host.localize(img, tp)
    reg = host.register(feats.edge_xyz, feats.edge_valid, feats.surface_xyz,
                        feats.surface_valid, tp)
    for r in (again, reg):
        assert int(r.status) == int(got.status)
        assert torch.equal(r.pose.t, got.pose.t)

    gm = tloc.build_geometry_maps(
        t32(street["edge"]), torch.ones(len(street["edge"]), dtype=torch.bool),
        t32(street["surf"]), torch.ones(len(street["surf"]), dtype=torch.bool),
        tcfg)
    tp32 = _priors(torch.float32, False)[1]
    got_g, _ = tloc.localize_scan(gm, img, tp32, tcfg)
    want_g = tloc.register_scan_geometry(
        gm, feats.edge_xyz, feats.edge_valid, feats.surface_xyz,
        feats.surface_valid, tp32, tcfg)
    assert int(got_g.status) == int(want_g.status)
    assert torch.equal(got_g.pose.t, want_g.pose.t)
    host_g = tloc.HostLocalizer(gm._replace(fused=None), tcfg)
    assert torch.equal(host_g.localize(img, tp32)[0].pose.t, got_g.pose.t)
