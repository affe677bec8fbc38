"""Port parity of the scan-to-map localization step, kitti_hdl64
settings cut to few rings: the bench scene (8 rings x 256 points, a map
of 7 noisy keyframe copies of the scan's features) and a street scene
ray-cast from 7 keyframes of one world (16 x 576), where the true pose
(identity) is recoverable.

Tolerances: Gauss-Newton status and iteration count equal, and the
final pose equal bit for bit: the float32 normal equations of these
problems (under 4,096 rows) are summed in the reference's order since
ROADMAP §C22 (before, the pose was held within 1e-4). On the street
scene the port's pose is within 0.1 m of the truth.

The reference is jitted here, on the machine that runs the test, so the
exact pose presumes a CPU on which XLA:CPU sums as it did on the machine
that wrote the drive record (its thread count, L1 size and vector
width; PERF.md §7). ``test_torch_xla_dot.py`` says whether it does: its
record tests hold the port's forms machine-independently, and its live
ones (``test_gradient_loops_meet_at_the_reference_edge``) fail on a CPU
that sums otherwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_parity import np32, t32, to_np  # noqa: E402
from lidar_feature_extraction_tpu.config import (  # noqa: E402
    kitti_hdl64 as j_kitti)
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.core.quaternion import (  # noqa: E402
    exp_so3 as j_exp, quat_multiply as j_qmul)
from lidar_feature_extraction_tpu.core.scan import (  # noqa: E402
    RangeImage as JImage)
from lidar_feature_extraction_tpu.ops.extraction import (  # noqa: E402
    extract_features as j_extract, extract_features_compact as j_compact)
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    localization as jloc)
from lidar_feature_extraction_tpu_torch.config import (  # noqa: E402
    kitti_hdl64 as t_kitti)
from lidar_feature_extraction_tpu_torch.interop import (  # noqa: E402
    geometry_maps_from_numpy, pose_from_numpy, range_image_from_numpy)
from lidar_feature_extraction_tpu_torch.ops.extraction import (  # noqa: E402
    extract_features as t_extract)
from lidar_feature_extraction_tpu_torch.ops.gauss_newton import (  # noqa: E402
    EMPTY_INPUT)
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    localization as tloc)
from lidar_feature_extraction_tpu_torch.utils.synthetic import (  # noqa: E402
    bench_scan, keyframe_copies, street_scan, street_world, to_world)

R, P = 8, 256
T_ATOL = 0.0
Q_ATOL = 0.0


def _cut(cfg):
    """kitti_hdl64 cut to 8 x 256 and small capacities."""
    ex = dataclasses.replace(cfg.extraction, n_rings=R, max_points_per_ring=P,
                             max_edges=512, max_surfaces=2048)
    return dataclasses.replace(cfg, extraction=ex)


JCFG, TCFG = _cut(j_kitti()), _cut(t_kitti())


def _prior(noisy: bool):
    """The bench's best-case prior, or it with a 0.2 m + ~1 degree error
    drawn with numpy; (q, t) as float32 numpy."""
    q = np32([1.0, 0.0, 0.0, 0.0])
    t = np32([0.3, -0.2, 0.05])
    if noisy:
        rng = np.random.default_rng(7)
        d = rng.normal(size=3)
        t = np32(t + 0.2 * d / np.linalg.norm(d))
        yaw = np.radians(1.0) * rng.normal()
        q = np32(j_qmul(jnp.asarray(q), j_exp(jnp.asarray(np32([0, 0, yaw])))))
    return q, t


@pytest.fixture(scope="module")
def scene():
    """Scan, its JAX map and features, and the JAX map's point clouds."""
    rng = np.random.default_rng(0)
    xyz = bench_scan(rng, R, P)
    mask = np.ones((R, P), bool)
    count = np.full(R, P, np.int32)
    jimg = JImage(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(count))
    f = j_extract(jimg, JCFG.extraction)
    e = np32(f.edge_xyz)[np.asarray(f.edge_valid)]
    s = np32(f.surface_xyz)[np.asarray(f.surface_valid)]
    edge_pts, surf_pts = keyframe_copies(rng, e), keyframe_copies(rng, s)
    jmaps = jloc.build_geometry_maps(
        jnp.asarray(np32(edge_pts)), jnp.ones(len(edge_pts), bool),
        jnp.asarray(np32(surf_pts)), jnp.ones(len(surf_pts), bool), JCFG)
    return dict(xyz=xyz, mask=mask, count=count, jimg=jimg, jmaps=jmaps,
                edge_pts=np32(edge_pts), surf_pts=np32(surf_pts))


def _assert_same_result(got, want):
    assert int(got.status) == int(want.status)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(to_np(got.pose.t), np32(want.pose.t),
                               rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(to_np(got.pose.q), np32(want.pose.q),
                               rtol=0, atol=Q_ATOL)


@pytest.mark.parametrize("noisy", [False, True])
def test_register_scan_geometry_on_carried_maps(scene, noisy):
    q, t = _prior(noisy)
    ex = JCFG.extraction
    kw = dict(surface_leaf=JCFG.registration.surface_downsample_leaf,
              edges_per_ring=ex.edges_per_ring,
              surface_runs_per_ring=ex.surface_runs_per_ring)
    f = j_compact(scene["jimg"], ex, **kw)
    want = jloc.register_scan_geometry(
        scene["jmaps"], f.edge_xyz, f.edge_valid, f.surface_xyz,
        f.surface_valid, JPose(jnp.asarray(q), jnp.asarray(t)), JCFG,
        pre_downsampled=True)

    jm = scene["jmaps"]
    maps = geometry_maps_from_numpy(
        np32(jm.edge.rec), np32(jm.edge.voxel_size), np32(jm.edge.origin),
        jm.edge.dims, np32(jm.surface.rec), np32(jm.surface.voxel_size),
        np32(jm.surface.origin), jm.surface.dims, device="cpu")
    got = tloc.register_scan_geometry(
        maps, t32(f.edge_xyz), torch.as_tensor(np.array(f.edge_valid)),
        t32(f.surface_xyz), torch.as_tensor(np.array(f.surface_valid)),
        pose_from_numpy(q, t, "cpu"), TCFG, pre_downsampled=True)
    _assert_same_result(got, want)


@pytest.mark.parametrize("noisy", [False, True])
def test_localize_scan_whole_slice(scene, noisy):
    """The port builds its own map from the same point clouds (its own
    extraction made them equal to the reference's) and localizes."""
    q, t = _prior(noisy)
    want, _ = jloc.localize_scan(scene["jmaps"], scene["jimg"],
                                 JPose(jnp.asarray(q), jnp.asarray(t)), JCFG)

    img = range_image_from_numpy(scene["xyz"], scene["mask"], scene["count"],
                                 "cpu")
    maps = tloc.build_geometry_maps(
        t32(scene["edge_pts"]), torch.ones(len(scene["edge_pts"]),
                                           dtype=torch.bool),
        t32(scene["surf_pts"]), torch.ones(len(scene["surf_pts"]),
                                           dtype=torch.bool), TCFG)
    got, feats = tloc.localize_scan(maps, img, pose_from_numpy(q, t, "cpu"),
                                    TCFG)
    assert bool(feats.edge_valid.any()) and bool(feats.surface_valid.any())
    _assert_same_result(got, want)


def test_localize_scan_street_scene_recovers_the_pose():
    """Map and scan both extracted by each implementation itself; the
    pose is recovered to within 0.1 m of the truth (identity)."""
    r, p = 16, 576
    rng = np.random.default_rng(1)
    world = street_world(rng)
    jcfg, tcfg = (dataclasses.replace(c, extraction=dataclasses.replace(
        c.extraction, n_rings=r, max_points_per_ring=p)) for c in
        (j_kitti(), t_kitti()))
    mask, count = np.ones((r, p), bool), np.full(r, p, np.int32)
    clouds = {"j": ([], []), "t": ([], [])}
    for k in range(7):
        o = (0.0, 0.0) if k == 0 else tuple(rng.uniform(-3, 3, 2) * [1, .3])
        yaw = 0.0 if k == 0 else float(rng.uniform(-0.05, 0.05))
        xyz = street_scan(world, rng, r, p, o, yaw)
        scan0 = xyz if k == 0 else scan0
        fj = j_extract(JImage(jnp.asarray(xyz), jnp.asarray(mask),
                              jnp.asarray(count)), jcfg.extraction)
        ft = t_extract(range_image_from_numpy(xyz, mask, count, "cpu"),
                       tcfg.extraction)
        for key, f in (("j", fj), ("t", ft)):
            clouds[key][0].append(to_world(
                np32(to_np(f.edge_xyz))[to_np(f.edge_valid)], o, yaw))
            clouds[key][1].append(to_world(
                np32(to_np(f.surface_xyz))[to_np(f.surface_valid)], o, yaw))
    (je, js), (te, ts) = [[np32(np.concatenate(c)) for c in clouds[key]]
                          for key in ("j", "t")]
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(ts, js)
    q, t = _prior(False)
    jmaps = jloc.build_geometry_maps(
        jnp.asarray(je), jnp.ones(len(je), bool), jnp.asarray(js),
        jnp.ones(len(js), bool), jcfg)
    want, _ = jloc.localize_scan(
        jmaps, JImage(jnp.asarray(scan0), jnp.asarray(mask),
                      jnp.asarray(count)),
        JPose(jnp.asarray(q), jnp.asarray(t)), jcfg)
    tmaps = tloc.build_geometry_maps(
        t32(te), torch.ones(len(te), dtype=torch.bool), t32(ts),
        torch.ones(len(ts), dtype=torch.bool), tcfg)
    got, _ = tloc.localize_scan(
        tmaps, range_image_from_numpy(scan0, mask, count, "cpu"),
        pose_from_numpy(q, t, "cpu"), tcfg)
    _assert_same_result(got, want)
    assert int(got.status) != EMPTY_INPUT
    assert float(np.linalg.norm(to_np(got.pose.t))) < 0.1
