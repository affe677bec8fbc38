"""Port parity of the closed loop (localization + time-delay EKF, the
prior of each registration coming from the filter), the drive simulator
and the trajectory evaluation.

The drive is test_production_parity's: seed 0, 10 ray-cast scans of
16 x 512, vehicle twists, made by the reference's worldsim, replayed
through the reference's and the port's FusedLocalizationPipeline with
its production and faithful configurations.

Tolerances (since ROADMAP §C20 the port computes the reference's float32
maps, residual rows, fits and transcendental functions, so the loops
agree to rounding: measured 1.8e-7 m production, 7.2e-7 m faithful in
float32, 3.9e-10 m in float64, ATE within 1.7e-7 m):
- production path (float32, as it runs) and faithful path in float32
  (as it runs) and in float64 (maps and filter state): measured
  positions within 1e-5 m scan by scan, every GN status and iteration
  count equal, ATE within 1e-5 m of the reference's;
- the port's production ATE at most 1.2x its faithful ATE (the
  acceptance rule of test_production_parity);
- worldsim copy: the same points per scan, ring ids, points, maps and
  ground truth exactly;
- evaluation copy: equal to the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_production_parity import _configs  # noqa: E402
from torch_parity import port_config  # noqa: E402
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    localization as jloc)
from lidar_feature_extraction_tpu.pipeline.replay import (  # noqa: E402
    FusedLocalizationPipeline as JPipeline)
from lidar_feature_extraction_tpu.utils import evaluation as jeval  # noqa: E402
from lidar_feature_extraction_tpu.utils import worldsim as jws  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    localization as tloc)
from lidar_feature_extraction_tpu_torch.pipeline.replay import (  # noqa: E402
    FusedLocalizationPipeline)
from lidar_feature_extraction_tpu_torch.utils import evaluation as teval  # noqa: E402
from lidar_feature_extraction_tpu_torch.utils import worldsim as tws  # noqa: E402

jax.config.update("jax_enable_x64", True)

POS_ATOL = 1e-5
ATE_ATOL = 1e-5


def _replay(pipeline, scans, twists):
    """(measured positions [N, 3], [(status, iterations)])."""
    pos, gn = [], []
    for i, (pts, ring) in enumerate(scans):
        r = pipeline.process_scan(pts, ring, stamp=0.1 * i, twist=twists[i])
        pos.append(np.asarray(r.measured_pose.t))    # JAX or CPU tensor
        gn.append((r.gn_status, r.gn_iterations))
    return np.stack(pos), gn


@pytest.fixture(scope="module")
def drive():
    rng = np.random.default_rng(0)
    faithful, production = _configs()
    world = jws.make_world(rng)
    edges, surfs = jws.world_maps(world, rng)
    scans, gt = jws.make_scan_sequence(world, rng, n_scans=10, n_rings=16,
                                       n_az=512)
    twists = jws.synth_twists(len(scans), rng=rng)
    runs = {}
    for name, cfg, jbuild, tbuild, dtypes in (
            ("production", production, jloc.build_geometry_maps,
             tloc.build_geometry_maps, [(jnp.float32, torch.float32)]),
            ("faithful", faithful, jloc.build_feature_maps,
             tloc.build_feature_maps, [(jnp.float32, torch.float32),
                                       (jnp.float64, torch.float64)])):
        pcfg = port_config(cfg)
        for jd, td in dtypes:
            jm = jbuild(jnp.asarray(edges, jd), jnp.ones(len(edges), bool),
                        jnp.asarray(surfs, jd), jnp.ones(len(surfs), bool),
                        cfg)
            tm = tbuild(torch.as_tensor(edges, dtype=td),
                        torch.ones(len(edges), dtype=torch.bool),
                        torch.as_tensor(surfs, dtype=td),
                        torch.ones(len(surfs), dtype=torch.bool), pcfg)
            want = _replay(JPipeline(jm, cfg, initial_pose=JPose.identity(jd),
                                     dtype=jd), scans, twists)
            got = _replay(FusedLocalizationPipeline(
                tm, pcfg, initial_pose=Pose.identity(td, "cpu"), dtype=td,
                device="cpu"), scans, twists)
            runs[name, str(td).split(".")[-1]] = (want, got, tm, pcfg)
    return dict(gt=gt, scans=scans, twists=twists, runs=runs)


def _ate(est, gt):
    return jeval.ate_rmse(est, gt, align=False)


@pytest.mark.parametrize("name, dtype", [("production", "float32"),
                                         ("faithful", "float32"),
                                         ("faithful", "float64")])
def test_closed_loop_matches_reference_scan_by_scan(drive, name, dtype):
    (want_pos, want_gn), (got_pos, got_gn), _, _ = drive["runs"][name, dtype]
    np.testing.assert_allclose(got_pos, want_pos, rtol=0, atol=POS_ATOL)
    assert got_gn == want_gn
    assert abs(_ate(got_pos, drive["gt"]) - _ate(want_pos, drive["gt"])) \
        <= ATE_ATOL


def test_closed_loop_faithful_float32_ate_matches_reference(drive):
    (want_pos, _), (got_pos, _), _, _ = drive["runs"]["faithful", "float32"]
    gt = drive["gt"]
    assert _ate(got_pos, gt) < 1.5
    assert abs(_ate(got_pos, gt) - _ate(want_pos, gt)) <= ATE_ATOL


def test_production_within_1p2x_of_faithful_in_the_port(drive):
    runs = drive["runs"]
    prod = _ate(runs["production", "float32"][1][0], drive["gt"])
    faith = _ate(runs["faithful", "float32"][1][0], drive["gt"])
    assert prod < 1.5 and faith < 1.5
    assert prod <= 1.2 * faith, (prod, faith)


def test_run_drive_replays_the_closed_loop(drive):
    (_, (got_pos, _), tm, pcfg) = drive["runs"]["production", "float32"]
    est = tws.run_drive(tm, pcfg, drive["scans"], twists=drive["twists"],
                        device="cpu")
    np.testing.assert_array_equal(est, got_pos)


def test_worldsim_copy_gives_the_reference_drive(drive):
    rng = np.random.default_rng(0)
    world = tws.make_world(rng)
    edges, surfs = tws.world_maps(world, rng)
    scans, gt = tws.make_scan_sequence(world, rng, n_scans=10, n_rings=16,
                                       n_az=512)
    twists = tws.synth_twists(len(scans), rng=rng)

    ref = np.random.default_rng(0)
    jworld = jws.make_world(ref)
    jedges, jsurfs = jws.world_maps(jworld, ref)
    np.testing.assert_array_equal(world.poles_xy, jworld.poles_xy)
    np.testing.assert_array_equal(edges, jedges)
    np.testing.assert_array_equal(surfs, jsurfs)
    np.testing.assert_array_equal(gt, drive["gt"])
    for (pts, ring), (jpts, jring) in zip(scans, drive["scans"]):
        assert len(pts) == len(jpts)
        np.testing.assert_array_equal(ring, jring)
        np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(twists, drive["twists"])


def test_worldsim_trajectories_match_reference():
    for i in (0, 3, 17):
        for got, want in ((tws.straight_drive(i), jws.straight_drive(i)),
                          (tws.circle_pose(i, 40, 10.0),
                           jws.circle_pose(i, 40, 10.0))):
            np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q),
                                       rtol=0, atol=1e-7)
            np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


def test_evaluation_copy_matches_reference():
    rng = np.random.default_rng(3)
    gt = np.cumsum(rng.normal(size=(30, 3)), axis=0)
    est = gt @ np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    est = est + rng.normal(scale=0.05, size=gt.shape) + 2.0
    for align in (False, True):
        assert teval.ate_rmse(est, gt, align) == jeval.ate_rmse(est, gt, align)
    for a, b in zip(teval.umeyama_alignment(est, gt, True),
                    jeval.umeyama_alignment(est, gt, True)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        teval.relative_translation_errors(est, gt, 2),
        jeval.relative_translation_errors(est, gt, 2))
