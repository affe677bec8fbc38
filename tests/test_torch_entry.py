"""Port parity of the system's entry points and peripheral modules:
``pipeline/launch.py`` (configuration presets and overlays, PCD maps,
the pipeline constructors), the KITTI and point-layout readers, the
KITTI replay, the trajectory accumulator, the point-to-point alignment
problem and the debug colours, each against its JAX counterpart on the
same inputs.

Tolerances:
- configurations, readers, ring estimates, ground-truth poses, colours
  and the TUM file: exactly (the same numpy or integer arithmetic);
- PCD maps: geometry records as test_torch_geometry holds them (unit
  directions and normals within 1e-4 up to sign, ROADMAP §C4; line
  points and plane offsets within 1e-4 per metre of map extent; counts
  exact), point grids exactly (a stable sort moves the points);
- the KITTI replay (3 ray-cast scans of 8 x 256 written as ``.bin``):
  fused positions within 1e-3 m scan by scan;
- the alignment: status and iterations equal, pose within 1e-5;
- PLY files: byte for byte.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_geometry import _sign_align, _world  # noqa: E402
from torch_parity import np32, t32, to_np  # noqa: E402
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.io import convert as jconv  # noqa: E402
from lidar_feature_extraction_tpu.io import kitti as jkitti  # noqa: E402
from lidar_feature_extraction_tpu.ops import alignment as jalign  # noqa: E402
from lidar_feature_extraction_tpu.ops import color as jcolor  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import launch as jlaunch  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import replay as jreplay  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    trajectory as jtraj)
from lidar_feature_extraction_tpu.utils import profiling as jprof  # noqa: E402
from lidar_feature_extraction_tpu.utils import visualize as jvis  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.io import convert as tconv  # noqa: E402
from lidar_feature_extraction_tpu_torch.io import kitti as tkitti  # noqa: E402
from lidar_feature_extraction_tpu_torch.io.pcd import save_pcd  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import alignment as talign  # noqa: E402
from lidar_feature_extraction_tpu_torch.ops import color as tcolor  # noqa: E402
from lidar_feature_extraction_tpu_torch.parallel.distributed import (  # noqa: E402
    make_batched_localizer)
from lidar_feature_extraction_tpu_torch.pipeline import launch as tlaunch  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    localization as tloc)
from lidar_feature_extraction_tpu_torch.pipeline import replay as treplay  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    trajectory as ttraj)
from lidar_feature_extraction_tpu_torch.utils import profiling as tprof  # noqa: E402
from lidar_feature_extraction_tpu_torch.utils import visualize as tvis  # noqa: E402
from lidar_feature_extraction_tpu_torch.utils import worldsim as tws  # noqa: E402

CPU = "cpu"
REC_ATOL = 1e-4
POS_ATOL = 1e-3


# ---- load_config -------------------------------------------------------

_OVERLAY = {"extraction": {"padding": 3, "nms_rounds": 9},
            "registration": {"max_iterations": 11,
                             "edge_map": {"voxel_size": 1.5}},
            "compact_extraction": False}


@pytest.mark.parametrize("preset", sorted(jlaunch.PRESETS))
@pytest.mark.parametrize("overlay", ["none", "dict", "json", "yaml"])
def test_load_config_matches_reference(tmp_path, preset, overlay):
    kw = {}
    if overlay == "dict":
        kw["overrides"] = _OVERLAY
    elif overlay in ("json", "yaml"):
        path = tmp_path / f"params.{overlay}"
        text = json.dumps(_OVERLAY)
        if overlay == "yaml":
            text = pytest.importorskip("yaml").safe_dump(_OVERLAY)
        path.write_text(text)
        kw["params_file"] = str(path)
    got = tlaunch.load_config(preset, **kw)
    want = jlaunch.load_config(preset, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if overlay != "none":
        assert got.registration.edge_map.voxel_size == 1.5
    assert sorted(tlaunch.PRESETS) == sorted(jlaunch.PRESETS)


@pytest.mark.parametrize("bad", [dict(overrides={"no_such": 1}),
                                 dict(overrides={"extraction":
                                                 {"no_such": 1}}),
                                 dict(preset="no_such_preset")])
def test_load_config_unknown_key_raises(bad):
    for mod in (jlaunch, tlaunch):
        with pytest.raises(KeyError):
            mod.load_config(**bad)


# ---- load_maps ---------------------------------------------------------

@pytest.fixture(scope="module")
def pcd_maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("maps")
    edge, surf = _world(np.random.default_rng(4))
    paths = str(d / "edge.pcd"), str(d / "surface.pcd")
    save_pcd(paths[0], edge)
    save_pcd(paths[1], surf)
    return paths, float(np.abs(np.concatenate([edge, surf])).max())


def test_load_maps_geometry_matches_reference(pcd_maps):
    paths, extent = pcd_maps
    cfg = tlaunch.load_config("default")
    got = tlaunch.load_maps(*paths, cfg, device=CPU)
    want = jlaunch.load_maps(*paths, jlaunch.load_config("default"))
    assert isinstance(got, tloc.GeometryMaps)
    pos_atol = REC_ATOL * extent
    for kind, cnt_col in (("edge", 6), ("surface", 4)):
        g, w = getattr(got, kind), getattr(want, kind)
        assert g.dims == tuple(w.dims)
        np.testing.assert_array_equal(to_np(g.origin), np32(w.origin))
        rec_t, rec_j = to_np(g.rec), np32(w.rec)
        np.testing.assert_array_equal(rec_t[:, cnt_col], rec_j[:, cnt_col])
        occ = rec_j[:, cnt_col] >= 3
        assert occ.sum() > 50
        if kind == "edge":
            np.testing.assert_allclose(rec_t[occ, 0:3], rec_j[occ, 0:3],
                                       atol=pos_atol)
            np.testing.assert_allclose(
                _sign_align(rec_t[occ, 3:6], rec_j[occ, 3:6], -1),
                rec_j[occ, 3:6], atol=REC_ATOL)
        else:
            s = np.sign(np.sum(rec_t[occ, 0:3] * rec_j[occ, 0:3], axis=-1,
                               keepdims=True))
            np.testing.assert_allclose(s * rec_t[occ, 0:3], rec_j[occ, 0:3],
                                       atol=REC_ATOL)
            np.testing.assert_allclose(s[:, 0] * rec_t[occ, 3],
                                       rec_j[occ, 3], atol=pos_atol)


def test_load_maps_points_match_reference(pcd_maps):
    paths, _ = pcd_maps
    got = tlaunch.load_maps(*paths, tlaunch.load_config("default"),
                            geometry=False, device=CPU)
    want = jlaunch.load_maps(*paths, jlaunch.load_config("default"),
                             geometry=False)
    assert isinstance(got, tloc.FeatureMaps)
    for kind in ("edge", "surface"):
        g, w = getattr(got, kind), getattr(want, kind)
        assert g.dims == tuple(w.dims)
        np.testing.assert_array_equal(to_np(g.n_pts), np.asarray(w.n_pts))
        np.testing.assert_array_equal(to_np(g.points), np32(w.points))


def test_launch_constructors_build_on_the_requested_device(pcd_maps):
    cfg = tlaunch.load_config("default")
    loc = tlaunch.launch_localization(*pcd_maps[0], cfg, device=CPU)
    assert loc.device.type == CPU and loc.maps.fused.device.type == CPU
    mapping = tlaunch.launch_mapping(cfg, device=CPU, loop_radius=3.0)
    assert mapping.loop_radius == 3.0 and mapping.device.type == CPU
    assert tlaunch.launch_odometry(cfg, device=CPU).device.type == CPU


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default succeeds")


def _batch_inputs():
    from lidar_feature_extraction_tpu_torch.interop import (
        geometry_maps_from_numpy, poses_from_numpy, range_images_from_numpy)
    rec = np.zeros((5, 8), np.float32)
    maps = geometry_maps_from_numpy(
        rec, np32(0.5), np.zeros(3, np.float32), (2, 2, 1), rec, np32(0.5),
        np.zeros(3, np.float32), (2, 2, 1), device=CPU)
    images = range_images_from_numpy(
        np32(np.ones((2, 4, 16, 3))), np.ones((2, 4, 16), bool),
        np.full((2, 4), 16), device=CPU)
    priors = poses_from_numpy(np32([[1, 0, 0, 0]] * 2), np32(np.zeros((2, 3))),
                              device=CPU)
    return maps, images, priors


_CFG4 = {"extraction": {"n_rings": 4, "max_points_per_ring": 16}}
_DEFAULTS = {
    "load_maps": lambda paths, **kw: tlaunch.load_maps(
        *paths, tlaunch.load_config("default"), **kw).fused,
    "launch_localization": lambda paths, **kw: tlaunch.launch_localization(
        *paths, tlaunch.load_config("default"), **kw).ekf.td.x,
    "launch_mapping": lambda paths, **kw: tlaunch.launch_mapping(
        tlaunch.load_config("default"), **kw).odometry.state.pose_t,
    "launch_odometry": lambda paths, **kw: tlaunch.launch_odometry(
        tlaunch.load_config("default"), **kw).state.pose_t,
    "make_batched_localizer": lambda paths, **kw: make_batched_localizer(
        tlaunch.load_config("kitti_hdl64", overrides=_CFG4), **kw)(
            *_batch_inputs())[0].pose.t,
}


@pytest.mark.parametrize("name", sorted(_DEFAULTS))
def test_entry_point_defaults_to_the_card(no_cuda, pcd_maps, name):
    """Without a card the default device raises (torch's own error)
    instead of quietly running on the CPU; the CPU is there on request."""
    with pytest.raises((AssertionError, RuntimeError)):
        _DEFAULTS[name](pcd_maps[0])
    assert _DEFAULTS[name](pcd_maps[0], device=CPU).device.type == CPU


def test_batched_localizer_refuses_maps_on_another_device():
    maps, images, priors = _batch_inputs()
    cfg = tlaunch.load_config("kitti_hdl64", overrides=_CFG4)
    with pytest.raises(ValueError, match="maps are on cpu"):
        make_batched_localizer(cfg, device="meta")(maps, images, priors)


# ---- io ----------------------------------------------------------------

def _scan(rng, n=500):
    xyz = np32(rng.normal(scale=10.0, size=(n, 3)))
    xyz[:, 2] = np32(rng.uniform(-2.5, 0.5, size=n))
    return xyz, np32(rng.random(n))


def test_velodyne_bin_round_trip_and_sequence(tmp_path):
    rng = np.random.default_rng(0)
    scans = [_scan(rng, n) for n in (300, 417, 5)]
    for i, (xyz, inten) in enumerate(scans):
        tkitti.write_velodyne_bin(str(tmp_path / f"{i:06d}.bin"), xyz, inten)
    (tmp_path / "calib.txt").write_text("not a scan")
    files = tkitti.scan_files(str(tmp_path))
    assert files == jkitti.scan_files(str(tmp_path))
    assert len(files) == 3
    for path, (xyz, inten) in zip(files, scans):
        got = tkitti.read_velodyne_bin(path)
        np.testing.assert_array_equal(got, np.asarray(
            jkitti.read_velodyne_bin(path)))
        np.testing.assert_array_equal(got[:, :3], xyz)
        np.testing.assert_array_equal(got[:, 3], inten)
    got = list(tkitti.iter_scans(str(tmp_path), limit=2))
    want = list(jkitti.iter_scans(str(tmp_path), limit=2))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_rings", [16, 64])
def test_estimate_rings_matches_reference(n_rings):
    xyz, _ = _scan(np.random.default_rng(1), 2000)
    xyz[:4] = np32([[0, 0, 0], [0, 0, 1], [50, 0, 30], [50, 0, -40]])
    got = tkitti.estimate_rings(xyz, n_rings)
    np.testing.assert_array_equal(got, jkitti.estimate_rings(xyz, n_rings))
    assert got.min() >= 0 and got.max() == n_rings - 1


def test_load_poses_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    path = tmp_path / "00.txt"
    np.savetxt(path, rng.normal(size=(7, 12)))
    got = tkitti.load_poses(str(path))
    assert got.shape == (7, 3, 4) and got.dtype == np.float64
    np.testing.assert_array_equal(got, jkitti.load_poses(str(path)))


def _structured(rng, fields):
    arr = np.zeros(64, np.dtype(fields))
    for name, _ in fields:
        arr[name] = rng.uniform(-20, 20, size=64).astype(arr[name].dtype)
    arr["x"][:3] = 0
    arr["y"][:3] = 0
    arr["z"][:3] = 0
    arr["x"][3] = np.nan
    return arr


_LAYOUTS = {
    "xyz": [("x", "f4"), ("y", "f4"), ("z", "f4")],
    "xyz_intensity_ring": [("x", "f4"), ("y", "f4"), ("z", "f4"),
                           ("intensity", "f4"), ("ring", "u2")],
    "xyz_reflectivity_channel": [("x", "f8"), ("y", "f8"), ("z", "f8"),
                                 ("reflectivity", "u1"),
                                 ("channel", "i4")],
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_from_structured_matches_reference(layout):
    arr = _structured(np.random.default_rng(3), _LAYOUTS[layout])
    got, want = tconv.from_structured(arr, 32), jconv.from_structured(arr, 32)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not got.valid[:4].any() and got.valid[4:].all()


@pytest.mark.parametrize("point_step", [3, 4, 5])
def test_from_raw_f32_matches_reference(point_step):
    data = np32(np.random.default_rng(4).normal(scale=8.0,
                                                 size=(100, point_step)))
    data[5, :3] = 0.0
    got = tconv.from_raw_f32(data.ravel(), point_step)
    want = jconv.from_raw_f32(data.ravel(), point_step)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not got.valid[5]


def test_from_structured_without_xyz_raises():
    arr = np.zeros(3, np.dtype([("a", "f4")]))
    for mod in (jconv, tconv):
        with pytest.raises(ValueError):
            mod.from_structured(arr)


# ---- KITTI replay ------------------------------------------------------

def test_run_kitti_localization_matches_reference(tmp_path):
    """Three ray-cast 8 x 256 scans along the straight drive written as
    ``.bin`` files, maps as PCD, kitti_hdl64 cut to 8 rings."""
    rng = np.random.default_rng(0)
    world = tws.make_world(rng, n_poles=30, extent=20.0)
    edges, surfs = tws.world_maps(world, rng, n_ground=6000)
    for i in range(3):
        pts, _ = tws.raycast_scan(world, tws.straight_drive(i), rng,
                                  n_rings=8, n_az=256, elev_deg=(2.0, -24.8))
        tkitti.write_velodyne_bin(str(tmp_path / f"{i:06d}.bin"), pts)
    paths = str(tmp_path / "edge.pcd"), str(tmp_path / "surface.pcd")
    save_pcd(paths[0], np32(edges))
    save_pcd(paths[1], np32(surfs))
    over = {"extraction": {"n_rings": 8, "max_points_per_ring": 256,
                           "max_edges": 512, "max_surfaces": 2048}}
    jcfg = jlaunch.load_config("kitti_hdl64", overrides=over)
    tcfg = tlaunch.load_config("kitti_hdl64", overrides=over)
    want = jreplay.run_kitti_localization(
        str(tmp_path), jlaunch.load_maps(*paths, jcfg), jcfg)
    got = treplay.run_kitti_localization(
        str(tmp_path), tlaunch.load_maps(*paths, tcfg, device=CPU), tcfg,
        device=CPU)
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, np32(want), rtol=0, atol=POS_ATOL)


# ---- trajectory ----------------------------------------------------------

def test_path_accumulator_and_tum_file_match_reference(tmp_path):
    rng = np.random.default_rng(5)
    q = np32(rng.normal(size=(6, 4)))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = np32(rng.normal(size=(6, 3)))
    got, want = ttraj.PathAccumulator(), jtraj.PathAccumulator()
    for k in range(6):
        stamp = None if k % 2 else 0.1 * k
        got.append(Pose(t32(q[k]), t32(t[k])), stamp)
        want.append(JPose(jnp.asarray(q[k]), jnp.asarray(t[k])), stamp)
    assert len(got) == len(want) == 6
    for name in ("positions", "quaternions", "stamps"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    got.save_tum(str(tmp_path / "got.txt"))
    want.save_tum(str(tmp_path / "want.txt"))
    assert (tmp_path / "got.txt").read_text() == \
        (tmp_path / "want.txt").read_text()
    empty = ttraj.PathAccumulator()
    assert empty.positions.shape == (0, 3)
    assert empty.quaternions.shape == (0, 4)


def test_map_viewer_transform_matches_reference():
    pts = np32(np.random.default_rng(6).normal(size=(500, 3)) + 4.0)
    valid = np.arange(500) % 3 > 0
    for args in ((pts,), (pts, valid), (pts[:0],)):
        want = jtraj.map_viewer_transform(*args)
        got = ttraj.map_viewer_transform(*[torch.as_tensor(a) for a in args])
        np.testing.assert_array_equal(got, want)


# ---- alignment and colour ----------------------------------------------

def test_alignment_problem_through_gauss_newton_matches_reference():
    rng = np.random.default_rng(7)
    src = np32(rng.uniform(-5, 5, size=(200, 3)))
    yaw = 0.2
    rot = np32([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                [0, 0, 1]])
    dst = np32(src @ rot.T + [0.5, -0.3, 0.1]
               + rng.normal(scale=0.01, size=src.shape))
    valid = rng.random(200) < 0.9
    q0, t0 = np32([1, 0, 0, 0]), np32([0, 0, 0])
    want = jalign.align_points(jnp.asarray(src), jnp.asarray(dst),
                               jnp.asarray(valid),
                               JPose(jnp.asarray(q0), jnp.asarray(t0)))
    got = talign.align_points(t32(src), t32(dst), torch.as_tensor(valid),
                              Pose(t32(q0), t32(t0)))
    assert int(got.status) == int(want.status)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(to_np(got.pose.q), np32(want.pose.q),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(to_np(got.pose.t), np32(want.pose.t),
                               rtol=0, atol=1e-5)
    block = talign.alignment_block(t32(src), t32(dst),
                                   torch.as_tensor(valid),
                                   Pose(t32(q0), t32(t0)))
    jblock = jalign.alignment_block(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(valid),
                                    JPose(jnp.asarray(q0), jnp.asarray(t0)))
    np.testing.assert_allclose(to_np(block.jacobian), np32(jblock.jacobian),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(block.residual), np32(jblock.residual),
                               rtol=0, atol=1e-6)


def test_color_by_label_matches_reference():
    labels = np.arange(-2, 10, dtype=np.int32).reshape(3, 4)
    got = tcolor.color_by_label(torch.as_tensor(labels))
    assert got.dtype == torch.uint8 and got.shape == (3, 4, 3)
    np.testing.assert_array_equal(to_np(got), np.asarray(
        jcolor.color_by_label(jnp.asarray(labels))))
    xyz = np32(np.random.default_rng(8).normal(size=(3, 4, 3)))
    mask = labels > 0
    for a, b in zip(tcolor.labeled_cloud(t32(xyz), torch.as_tensor(mask),
                                         torch.as_tensor(labels)),
                    jcolor.labeled_cloud(jnp.asarray(xyz), jnp.asarray(mask),
                                         jnp.asarray(labels))):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


@pytest.mark.parametrize("limits", [(None, None), (0.5, 3.0)])
def test_color_by_value_matches_reference(limits):
    values = np32(np.random.default_rng(9).uniform(-1, 5, size=(8, 32)))
    got = tcolor.color_by_value(t32(values), *limits)
    want = jcolor.color_by_value(jnp.asarray(values), *limits)
    assert got.dtype == torch.uint8 and got.shape == (8, 32, 3)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_write_velodyne_bin_writes_kitti_records(tmp_path):
    """The port's ``.bin`` writer: float32 (x, y, z, intensity) records,
    intensity zero when none is given."""
    xyz, _ = _scan(np.random.default_rng(10), 50)
    path = str(tmp_path / "000000.bin")
    tkitti.write_velodyne_bin(path, xyz)
    raw = np.fromfile(path, np.float32)
    assert os.path.getsize(path) == 50 * 16
    np.testing.assert_array_equal(raw.reshape(-1, 4)[:, :3], xyz)
    assert not raw.reshape(-1, 4)[:, 3].any()


# ---- stage timer, trace, PLY exports ----------------------------------

def test_stage_timer_reports_as_the_reference():
    """test_misc.py's StageTimer case on both timers: the same stages,
    counts and report fields; ``block_on`` takes a tree of tensors."""
    reports = []
    for timer in (jprof.StageTimer(), tprof.StageTimer()):
        with timer.stage("a"):
            sum(range(1000))
        with timer.stage("a", block_on=None):
            pass
        with timer.stage("b", block_on=(torch.ones(3),
                                         {"x": [torch.zeros(2)]})):
            pass
        reports.append(timer.report())
    want, got = reports
    assert got["a"]["count"] == 2 and got["a"]["total_s"] > 0
    assert {k: sorted(v) for k, v in got.items()} == {
        k: sorted(v) for k, v in want.items()}
    assert [got[k]["count"] for k in sorted(got)] == [
        want[k]["count"] for k in sorted(want)]


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "trace")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert path.startswith(str(tmp_path)) and len(events) > 0


def _ply_inputs():
    rng = np.random.default_rng(8)
    xyz = np32(rng.normal(size=(4, 16, 3)))
    mask = rng.random((4, 16)) < 0.7
    labels = rng.integers(0, 8, size=(4, 16)).astype(np.int32)
    return xyz, mask, labels


# name -> write(module, path, xyz, mask, labels)
_PLY = {
    "save_ply": lambda m, path, xyz, mask, labels: m.save_ply(
        path, xyz.reshape(-1, 3)),
    "save_ply_rgb": lambda m, path, xyz, mask, labels: m.save_ply(
        path, xyz.reshape(-1, 3),
        np.uint8(np.arange(xyz.size).reshape(-1, 3) % 256)),
    "export_labeled_scan": lambda m, path, xyz, mask, labels:
        m.export_labeled_scan(path, xyz, mask, labels),
    "export_trajectory": lambda m, path, xyz, mask, labels:
        m.export_trajectory(path, xyz[0], color=(1, 2, 3)),
}


@pytest.mark.parametrize("name", sorted(_PLY))
def test_ply_writers_match_reference(tmp_path, name):
    """The port's PLY files are the reference's byte for byte (the
    labelled scan from torch tensors on the port's side)."""
    xyz, mask, labels = _ply_inputs()
    out = []
    for tag, module, args in (
            ("want", jvis, (xyz, mask, labels)),
            ("got", tvis, (torch.as_tensor(xyz), torch.as_tensor(mask),
                           torch.as_tensor(labels))
             if name == "export_labeled_scan" else (xyz, mask, labels))):
        path = str(tmp_path / f"{tag}.ply")
        _PLY[name](module, path, *args)
        with open(path, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1]
    assert out[1].startswith(b"ply\nformat binary_little_endian 1.0\n")


def kitti_drive_reference_ate() -> float:
    """The JAX package's ``run_kitti_localization`` ATE-RMSE on
    chip_smoke.py's ``kitti`` phase input (eval_ate.py's 20-scan drive,
    made by the port's worldsim, written as a KITTI sequence with PCD
    maps by chip_smoke's ``write_kitti_drive``), the limit that phase
    holds the card to. A one-off on the CPU, not part of the suite:

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_entry.py
    """
    import tempfile

    import chip_smoke
    from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse

    edges, surfs, scans, gt, *_ = chip_smoke.drive_inputs()
    with tempfile.TemporaryDirectory() as root:
        seq, edge, surf = chip_smoke.write_kitti_drive(root, edges, surfs,
                                                       scans)
        cfg = jlaunch.load_config("kitti_hdl64")
        fused = jreplay.run_kitti_localization(
            seq, jlaunch.load_maps(edge, surf, cfg), cfg)
    return ate_rmse(np.asarray(fused), gt, align=False)


if __name__ == "__main__":
    print(json.dumps({"kitti_drive_reference_ate_m":
                      kitti_drive_reference_ate()}))

