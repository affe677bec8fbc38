"""Port parity of the batched localizer: B scans through one extraction
and one lock-step Gauss-Newton loop, against the reference's
``jax.vmap(localize_scan)`` (the function its ``make_batched_localizer``
shards over a mesh) and against the port's own ``localize_scan`` run on
each lane alone, on every branch: the compact extraction and the full
one over ``GeometryMaps``, and the full extraction over ``FeatureMaps``
(kNN rounds, refitting every iteration or once per round).

The scene is test_torch_localization's bench scene (kitti_hdl64 cut to
8 rings x 256 points, a map of 7 noisy keyframe copies of the scan's
features), B = 3 lanes: the scan, it moved by a few centimetres, and it
turned by a degree, each with its own prior error, so that the lanes
stop at different iterations and the finished lanes' carries must stay
frozen while the others run on. The JAX reference is computed once per
module; the port registers against the reference's own maps.

Tolerances: Gauss-Newton status and iteration count per lane equal;
labels, compaction columns and the selected feature points exactly (the
one-hot compaction copies points); the pose within 1e-4 m and 1e-4 in
each quaternion component (float32 normal equations summed in another
order). The ``FeatureMaps`` cases run in float64 on both sides, as the
faithful path's parity tests do (the reference's float32 plane fit is
ill-conditioned far from the origin, ROADMAP §C8); their lanes have
their own prior errors, so that in the refitting case one lane runs the
second search round and the others do not. Against its lone run a lane
of the branches is held bit for bit. The batched statistics, small
solves and the voxel downsample equal stacked single calls bit for bit
(elementwise arithmetic, exact integer counts, and each lane's sums in
its own rows).
"""

import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_enable_x64", True)   # as in-suite (test_extraction)

from torch_parity import np32, t32, to_np  # noqa: E402
from lidar_feature_extraction_tpu.config import (  # noqa: E402
    kitti_hdl64 as j_kitti)
from lidar_feature_extraction_tpu.core import quaternion as jq  # noqa: E402
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.core.scan import (  # noqa: E402
    RangeImage as JImage)
from lidar_feature_extraction_tpu.ops import extraction as jex  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    localization as jloc)
from lidar_feature_extraction_tpu_torch.config import (  # noqa: E402
    kitti_hdl64 as t_kitti)
from lidar_feature_extraction_tpu_torch.core import stats as tstats  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.scan import (  # noqa: E402
    stack_range_images)
from lidar_feature_extraction_tpu_torch.interop import (  # noqa: E402
    feature_maps_from_numpy, geometry_maps_from_numpy, pose_from_numpy,
    poses_from_numpy, range_image_from_numpy, range_images_from_numpy)
from lidar_feature_extraction_tpu_torch.ops import extraction as tex  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops.downsample import (  # noqa: E402
    voxel_downsample)
from lidar_feature_extraction_tpu_torch.ops import smallalg as tsa  # noqa: E402
from lidar_feature_extraction_tpu_torch.parallel.distributed import (  # noqa: E402
    make_batched_localizer)
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    localization as tloc)
from lidar_feature_extraction_tpu_torch.utils.synthetic import (  # noqa: E402
    bench_scan, keyframe_copies)

R, P, B = 8, 256, 3
T_ATOL = 1e-4
Q_ATOL = 1e-4


def _cut(cfg):
    ex = dataclasses.replace(cfg.extraction, n_rings=R, max_points_per_ring=P,
                             max_edges=512, max_surfaces=2048)
    return dataclasses.replace(cfg, extraction=ex)


JCFG, TCFG = _cut(j_kitti()), _cut(t_kitti())


def _yaw_q(yaw):
    return np32([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def _lanes(xyz):
    """B scans (the scan, moved, turned) and their priors (the bench's
    best-case prior with a per-lane error), float32 numpy."""
    turn = np32(jq.quat_to_matrix(jnp.asarray(_yaw_q(np.radians(1.0)))))
    scans = np32([xyz, xyz + np32([0.04, -0.03, 0.0]), xyz @ turn.T])
    q = np32([_yaw_q(0.0), _yaw_q(np.radians(0.5)), _yaw_q(np.radians(-1.0))])
    t = np32([[0.3, -0.2, 0.05], [0.35, -0.1, 0.0], [0.2, -0.3, 0.1]])
    return scans, q, t


@pytest.fixture(scope="module")
def case():
    """The scene, its JAX map, the lanes, and the reference's vmapped
    results (computed once)."""
    rng = np.random.default_rng(0)
    xyz = bench_scan(rng, R, P)
    mask = np.ones((R, P), bool)
    count = np.full(R, P, np.int32)
    f = jex.extract_features(JImage(jnp.asarray(xyz), jnp.asarray(mask),
                                    jnp.asarray(count)), JCFG.extraction)
    e = np32(f.edge_xyz)[np.asarray(f.edge_valid)]
    s = np32(f.surface_xyz)[np.asarray(f.surface_valid)]
    edge_pts, surf_pts = np32(keyframe_copies(rng, e)), np32(
        keyframe_copies(rng, s))
    jmaps = jloc.build_geometry_maps(
        jnp.asarray(edge_pts), jnp.ones(len(edge_pts), bool),
        jnp.asarray(surf_pts), jnp.ones(len(surf_pts), bool), JCFG)
    scans, q, t = _lanes(xyz)
    masks, counts = np.stack([mask] * B), np.stack([count] * B)
    batched = jax.vmap(partial(jloc.localize_scan, cfg=JCFG),
                       in_axes=(None, 0, 0))
    want, want_feats = batched(
        jmaps, JImage(jnp.asarray(scans), jnp.asarray(masks),
                      jnp.asarray(counts)),
        JPose(jnp.asarray(q), jnp.asarray(t)))
    ex = JCFG.extraction

    def lane_columns(x):
        labels, _ = jex.label_range_image(
            JImage(x, jnp.asarray(mask), jnp.asarray(count)), ex)
        key = jex._voxel_run_key(x, JCFG.registration.surface_downsample_leaf)
        col, _, _, _ = jex.compact_columns(labels, jnp.asarray(mask), key,
                                           ex.edges_per_ring,
                                           ex.surface_runs_per_ring)
        return labels, col

    want_labels, want_col = jax.vmap(lane_columns)(jnp.asarray(scans))
    maps = geometry_maps_from_numpy(
        np32(jmaps.edge.rec), np32(jmaps.edge.voxel_size),
        np32(jmaps.edge.origin), jmaps.edge.dims, np32(jmaps.surface.rec),
        np32(jmaps.surface.voxel_size), np32(jmaps.surface.origin),
        jmaps.surface.dims, device="cpu")
    got, got_feats = make_batched_localizer(TCFG, device="cpu")(
        maps, range_images_from_numpy(scans, masks, counts, "cpu"),
        poses_from_numpy(q, t, "cpu"))
    return dict(xyz=xyz, rng=rng, scans=scans, mask=mask, count=count, q=q,
                t=t, jmaps=jmaps, maps=maps, want=want, want_feats=want_feats,
                want_labels=want_labels, want_col=want_col, got=got,
                got_feats=got_feats)


def _assert_lane(got_status, got_it, got_q, got_t, want_status, want_it,
                 want_q, want_t):
    assert int(got_status) == int(want_status)
    assert int(got_it) == int(want_it)
    np.testing.assert_allclose(to_np(got_t), np32(want_t), rtol=0,
                               atol=T_ATOL)
    np.testing.assert_allclose(to_np(got_q), np32(want_q), rtol=0,
                               atol=Q_ATOL)


def test_batched_localizer_matches_vmapped_reference(case):
    got, want = case["got"], case["want"]
    iters = np.asarray(want.iterations).tolist()
    assert len(set(iters)) > 1, f"the lanes stop together: {iters}"
    assert got.status.shape == got.iterations.shape == (B,)
    for b in range(B):
        _assert_lane(got.status[b], got.iterations[b], got.pose.q[b],
                     got.pose.t[b], want.status[b], want.iterations[b],
                     want.pose.q[b], want.pose.t[b])


def test_batched_features_match_vmapped_reference(case):
    got, want = case["got_feats"], case["want_feats"]
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    for name in ("edge_valid", "surface_valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    for name in ("edge_xyz", "surface_xyz"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np32(getattr(want, name)))
    assert got.edge_xyz.shape == (B, R * TCFG.extraction.edges_per_ring, 3)


def test_batched_labels_and_columns_match_reference(case):
    """K1's plain version on the [B * R, P] planes of the batch: labels
    and columns equal the reference's lane by lane and B single calls."""
    ex = TCFG.extraction
    leaf = TCFG.registration.surface_downsample_leaf
    planes = [t32(case["scans"][..., i].reshape(B * R, P)) for i in range(3)]
    count = torch.as_tensor(np.tile(case["count"], B))
    labels, _, col = tex.label_and_columns_plain(
        *planes, count, ex, leaf, ex.edges_per_ring, ex.surface_runs_per_ring)
    np.testing.assert_array_equal(to_np(labels).reshape(B, R, P),
                                  np.asarray(case["want_labels"]))
    np.testing.assert_array_equal(to_np(col).reshape(B, R, P),
                                  np.asarray(case["want_col"]))
    for b in range(B):
        one = tex.label_and_columns_plain(
            *[p[b * R:(b + 1) * R] for p in planes], count[:R], ex, leaf,
            ex.edges_per_ring, ex.surface_runs_per_ring)
        assert torch.equal(one[0], labels[b * R:(b + 1) * R])
        assert torch.equal(one[2], col[b * R:(b + 1) * R])


def test_batched_localizer_matches_lone_runs(case):
    got = case["got"]
    for b in range(B):
        img = range_image_from_numpy(case["scans"][b], case["mask"],
                                     case["count"], "cpu")
        lone, _ = tloc.localize_scan(case["maps"], img, pose_from_numpy(
            case["q"][b], case["t"][b], "cpu"), TCFG)
        _assert_lane(got.status[b], got.iterations[b], got.pose.q[b],
                     got.pose.t[b], lone.status, lone.iterations, lone.pose.q,
                     lone.pose.t)


def test_stack_range_images_matches_stacked_numpy(case):
    imgs = [range_image_from_numpy(x, case["mask"], case["count"], "cpu")
            for x in case["scans"]]
    stacked = stack_range_images(imgs)
    direct = range_images_from_numpy(case["scans"], np.stack([case["mask"]]
                                                             * B),
                                     np.stack([case["count"]] * B), "cpu")
    for a, b in zip(stacked, direct):
        assert torch.equal(a, b)


# ---- the full-extraction and FeatureMaps branches ----------------------

# The FeatureMaps lanes' prior errors on top of the lanes' priors: lane 1
# moves past the candidate refresh distance (0.5 m) in the first round
# and runs the second, the others stay within it.
_FEATURE_PRIOR_DT = np.float64([[0.0, 0.0, 0.0], [0.4, 0.0, 0.0],
                                [-0.5, -0.4, 0.1]])


def _branch_cfgs(refit):
    """(reference, port) configs: the full extraction, over FeatureMaps
    refitting every iteration (True) or once per round (False) when
    ``refit`` is not None."""
    def full(cfg):
        cfg = dataclasses.replace(cfg, compact_extraction=False)
        if refit is None:
            return cfg
        return dataclasses.replace(cfg, registration=dataclasses.replace(
            cfg.registration, refit_per_iteration=refit))
    return full(JCFG), full(TCFG)


_BRANCHES = {"full_geometry": None, "feature_refit": True,
             "feature_frozen": False}


@pytest.fixture(scope="module")
def branches(case):
    """Per branch: the reference's vmapped results, the port's batch (and
    which lanes ran a second search round in it) and the port's lone
    runs. The FeatureMaps cases in float64: scans, priors, and maps
    built by the reference from the bench map's clouds."""
    mask, count = case["mask"], case["count"]
    masks, counts = np.stack([mask] * B), np.stack([count] * B)
    jmaps_f = None
    out = {}
    for name, refit in _BRANCHES.items():
        jcfg, tcfg = _branch_cfgs(refit)
        if refit is None:
            scans, q, t = case["scans"], case["q"], case["t"]
            jmaps, maps = case["jmaps"], case["maps"]
        else:
            scans = case["scans"].astype(np.float64)
            q = case["q"].astype(np.float64)
            t = case["t"] + _FEATURE_PRIOR_DT
            if jmaps_f is None:
                jmaps_f = _feature_maps(case["xyz"], jcfg)
                g = [jmaps_f.edge, jmaps_f.surface]
                maps_f = _f64(feature_maps_from_numpy(*[
                    a for m in g for a in (np.asarray(m.points),
                                           np.asarray(m.n_pts),
                                           np.asarray(m.voxel_size),
                                           np.asarray(m.origin), m.dims)],
                    device="cpu"))
            jmaps, maps = jmaps_f, maps_f
        want, want_feats = jax.vmap(partial(jloc.localize_scan, cfg=jcfg),
                                    in_axes=(None, 0, 0))(
            jmaps, JImage(jnp.asarray(scans), jnp.asarray(masks),
                          jnp.asarray(counts)),
            JPose(jnp.asarray(q), jnp.asarray(t)))
        reruns = []
        select = tloc._select_scans

        def recording(take, new, old):
            reruns.append(take.tolist())
            return select(take, new, old)

        tloc._select_scans = recording
        try:
            got, got_feats = make_batched_localizer(tcfg, device="cpu")(
                maps, _like(range_images_from_numpy(scans, masks, counts,
                                                    "cpu"), scans),
                _like(poses_from_numpy(q, t, "cpu"), scans))
        finally:
            tloc._select_scans = select
        lone = [tloc.localize_scan(
            maps, _like(range_image_from_numpy(scans[b], mask, count, "cpu"),
                        scans),
            _like(pose_from_numpy(q[b], t[b], "cpu"), scans), tcfg)[0]
            for b in range(B)]
        out[name] = dict(want=want, want_feats=want_feats, got=got,
                         got_feats=got_feats, lone=lone, reruns=reruns)
    return out


def _f64(tree):
    """A NamedTuple (nested) with its float tensors in float64."""
    return type(tree)(*(
        a.double() if isinstance(a, torch.Tensor) and a.is_floating_point()
        else _f64(a) if isinstance(a, tuple) and hasattr(a, "_fields")
        else a for a in tree))


def _like(tree, scans):
    """``tree`` in the scans' precision (the interop builds float32)."""
    return _f64(tree) if scans.dtype == np.float64 else tree


def _feature_maps(xyz, jcfg):
    """The reference's FeatureMaps (float64) of the bench map: the scan's
    full-extraction features at the fixture's 7 noisy keyframe copies."""
    rng = np.random.default_rng(0)
    bench_scan(rng, R, P)                 # the map's draws follow the scan's
    f = jex.extract_features(JImage(
        jnp.asarray(xyz), jnp.ones((R, P), bool), jnp.full(R, P, jnp.int32)),
        jcfg.extraction)
    e = np.asarray(f.edge_xyz)[np.asarray(f.edge_valid)]
    s = np.asarray(f.surface_xyz)[np.asarray(f.surface_valid)]
    edge, surf = (np.float64(keyframe_copies(rng, a)) for a in (e, s))
    return jloc.build_feature_maps(
        jnp.asarray(edge), jnp.ones(len(edge), bool), jnp.asarray(surf),
        jnp.ones(len(surf), bool), jcfg)


@pytest.mark.parametrize("name", sorted(_BRANCHES))
def test_branch_matches_vmapped_reference(branches, name):
    """Status, iterations and pose of every lane as the reference's
    ``jax.vmap(localize_scan)``, labels and the compacted features
    exactly, and lanes that stop at different iterations."""
    c = branches[name]
    got, want = c["got"], c["want"]
    iters = np.asarray(want.iterations).tolist()
    assert len(set(iters)) > 1, f"the lanes stop together: {iters}"
    assert got.status.shape == got.iterations.shape == (B,)
    for b in range(B):
        _assert_lane(got.status[b], got.iterations[b], got.pose.q[b],
                     got.pose.t[b], want.status[b], want.iterations[b],
                     want.pose.q[b], want.pose.t[b])
    gf, wf = c["got_feats"], c["want_feats"]
    np.testing.assert_array_equal(to_np(gf.labels), np.asarray(wf.labels))
    for field in ("edge_xyz", "edge_valid", "surface_xyz", "surface_valid"):
        np.testing.assert_array_equal(to_np(getattr(gf, field)),
                                      np.asarray(getattr(wf, field)))
    assert gf.surface_xyz.shape == (B, TCFG.extraction.max_surfaces, 3)


@pytest.mark.parametrize("name", sorted(_BRANCHES))
def test_branch_lanes_equal_lone_runs(branches, name):
    """Each lane of the batch is its lone ``localize_scan`` bit for bit:
    status, iterations, pose, error and scale."""
    c = branches[name]
    got = c["got"]
    for b, lone in enumerate(c["lone"]):
        assert (int(got.status[b]), int(got.iterations[b])) == (
            int(lone.status), int(lone.iterations)), b
        for field in ("error", "scale"):
            assert torch.equal(getattr(got, field)[b], getattr(lone, field))
        assert torch.equal(got.pose.t[b], lone.pose.t), b
        assert torch.equal(got.pose.q[b], lone.pose.q), b


def test_feature_maps_lanes_decide_their_own_rounds(branches):
    """Refitting every iteration, lane 1 moves past the refresh distance
    and runs the second search round while lanes 0 and 2 keep their
    first round's result; with the fits frozen per round every lane ends
    the first round at an abort and runs the second."""
    assert branches["feature_refit"]["reruns"] == [[False, True, False]]
    assert branches["feature_frozen"]["reruns"] == [[True, True, True]]


def test_batched_voxel_downsample_equals_stacked_lone_calls():
    """Each cloud of a batch downsamples in its own rows: the lanes'
    centroids, validity and order are those of lone calls, bit for bit,
    including a lane that overflows the capacity and an empty one."""
    rng = np.random.default_rng(5)
    xyz = torch.as_tensor(np32(rng.uniform(-6, 6, size=(4, 700, 3))))
    mask = torch.as_tensor(rng.random((4, 700)) < 0.8)
    xyz[1] *= 4.0                         # more voxels than the capacity
    mask[3] = False
    pts, valid = voxel_downsample(xyz, mask, 1.0, 400)
    assert pts.shape == (4, 400, 3) and valid.shape == (4, 400)
    for b in range(4):
        lone_pts, lone_valid = voxel_downsample(xyz[b], mask[b], 1.0, 400)
        assert torch.equal(pts[b], lone_pts) and torch.equal(valid[b],
                                                             lone_valid)
    assert bool(valid[1].all()) and not bool(valid[3].any())


def _psd(rng, n, lead):
    a = rng.normal(size=lead + (n, n + 2))
    return np32(a @ np.swapaxes(a, -1, -2) + 0.05 * np.eye(n))


_BATCHED = {
    "_wide_median": lambda rng: (
        (tstats._wide_median,),
        (np32(rng.exponential(size=(4, 300))), rng.random((4, 300)) < 0.6)),
    "masked_scale_bisect": lambda rng: (
        (tstats.masked_scale_bisect,),
        (np32(rng.normal(size=(4, 257))), rng.random((4, 257)) < 0.8)),
    "cholesky_solve": lambda rng: (
        (tsa.cholesky_solve,), (_psd(rng, 6, (4,)),
                                np32(rng.normal(size=(4, 6))))),
    "min_eigval_below": lambda rng: (
        (lambda a: tsa.min_eigval_below(a, 0.5),), (_psd(rng, 7, (4,)),)),
}


@pytest.mark.parametrize("name", sorted(_BATCHED))
def test_batched_small_ops_equal_stacked_single_calls(name):
    rng = np.random.default_rng(3)
    (fn,), args = _BATCHED[name](rng)
    args = [torch.as_tensor(a) for a in args]
    if name.endswith("median") or name == "masked_scale_bisect":
        args[1][2] = False          # one lane with nothing valid
    batched = fn(*args)
    single = torch.stack([fn(*[a[b] for a in args]) for b in range(4)])
    assert batched.shape == single.shape
    assert torch.equal(batched, single) or (
        torch.isnan(batched).equal(torch.isnan(single))
        and torch.equal(batched.nan_to_num(), single.nan_to_num()))
