"""Port parity at full width, held to the committed reference record
(``tests/data/torch_reference_fullwidth.npz``, written by
``tests/torch_reference_record.py --write``; its cases, inputs and rules
are ``reference_cases.py``'s): bench.py's scene and a street scene under
``kitti_hdl64()`` (64 x 2304, compact extraction, GeometryMaps) and
``vlp16()`` (16 x 1856, full extraction, FeatureMaps), five priors each.

- The record equals what the JAX package computes now, bit for bit
  (labels, curvature, features, statuses, iterations, poses, errors,
  scales), and so does its manifest: a rerun of ``--write`` changes
  nothing.
- The port's labels and curvature (CPU, float32) equal the record's bit
  for bit, and so do the features ``localize_scan`` registers: the port
  computes the float32 range, neighbour cosine and curvature with the
  fused multiply-adds of the reference's jitted code (ROADMAP §C6,
  §C18). In float64 the labels are bit-equal as well.
- Registration fed the reference's own features: status and iterations
  equal, the pose within 1e-5 m and 1e-5 per quaternion component,
  under ``kitti_hdl64`` in float32 and under ``vlp16`` in float64 (the
  kNN path's float32 plane fit is ill-conditioned, ROADMAP §C8).
- ``localize_scan`` end to end: status and iterations equal, the pose
  within 1e-4 of the record, under both presets; under ``kitti_hdl64``
  the first Gauss-Newton iteration likewise. The ``vlp16`` float32 run
  meets it since the kNN fits compute the reference's contracted float32
  forms (ROADMAP §C19); its float64 run is held to the reference's
  float64 run within 1e-5.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_reference_record as trr  # noqa: E402
import reference_cases as rc  # noqa: E402
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    launch, localization as tloc)

CPU_ATOL = 1e-5
KITTI = [c for c in rc.CASES if c.startswith("kitti_hdl64/")]


@pytest.fixture(scope="module")
def committed():
    return rc.load()


@pytest.fixture(scope="module")
def fresh():
    """The record as the JAX package (and the port's labels) give it
    now."""
    return trr.build_record()


@pytest.fixture(scope="module")
def port(committed):
    """The port's runs on the CPU, per case: its labels and features
    (from localize_scan), localize_scan, the registration fed the
    record's features and, under kitti_hdl64, localize_scan stopped after
    one iteration; under vlp16 the registration and localize_scan in
    float64."""
    arrays, _ = committed
    out = {}
    for case in rc.CASES:
        cfg = launch.load_config(rc.split(case)[0])
        rec = rc.case_arrays(arrays, case)
        dtype = torch.float32 if cfg.compact_extraction else torch.float64
        maps = rc.port_maps(case, rec["labels"], cfg, "cpu")
        runs = [tloc.localize_scan(maps, rc.port_image(case, cfg, "cpu"), p,
                                   cfg) for p in rc.port_poses("cpu")]
        got = {"features": runs[0][1],
               "localize": rc.results_arrays([r for r, _ in runs])}
        if dtype != torch.float32:
            maps = rc.port_maps(case, rec["labels"], cfg, "cpu", dtype)
        poses = rc.port_poses("cpu", dtype)
        got["register"] = rc.register_on_features(
            maps, rc.ref_features_tensors(rec, "cpu", dtype), poses, cfg)
        if cfg.compact_extraction:
            img, second = rc.port_image(case, cfg, "cpu"), "one_iteration"
            cfg = rc.one_iteration(cfg)
        else:
            img, second = rc.port_image(case, cfg, "cpu", dtype), "localize64"
        got[second] = rc.results_arrays([tloc.localize_scan(
            maps, img, p, cfg)[0] for p in poses])
        out[case] = got
    return out


def _assert_results(got, rec, run, want_run, t_atol, q_atol):
    np.testing.assert_array_equal(got["status"], rec[f"{want_run}_status"],
                                  err_msg=f"{run}: status")
    np.testing.assert_array_equal(got["iterations"],
                                  rec[f"{want_run}_iterations"],
                                  err_msg=f"{run}: iterations")
    np.testing.assert_allclose(got["t"], rec[f"{want_run}_t"], rtol=0,
                               atol=t_atol, err_msg=f"{run}: t")
    np.testing.assert_allclose(got["q"], rec[f"{want_run}_q"], rtol=0,
                               atol=q_atol, err_msg=f"{run}: q")


def test_record_equals_a_fresh_computation(fresh, committed):
    """Arrays bit for bit and the manifest (package versions aside): a
    rerun of ``--write`` would change nothing."""
    assert trr.differences(*fresh, *committed) == []


def test_record_is_small_and_names_its_cases(committed):
    arrays, manifest = committed
    assert os.path.getsize(rc.RECORD) < 4 * 2 ** 20
    assert tuple(manifest["cases"]) == rc.CASES
    for case, m in manifest["cases"].items():
        labels = rc.case_arrays(arrays, case)["labels"]
        assert labels.dtype == np.int8 and list(labels.shape) == m["shape"]
        assert trr.labels_sha256(labels) == m["labels_sha256"]


@pytest.mark.parametrize("case", rc.CASES)
def test_port_labels_and_curvature_equal_the_record(committed, port, case):
    """The port's labels and curvature from localize_scan equal the
    record's bit for bit, and so do the features it registers (the
    compact ones under kitti_hdl64, the full ones under vlp16)."""
    rec = rc.case_arrays(committed[0], case)
    feats = port[case]["features"]
    np.testing.assert_array_equal(feats.labels.numpy(), rec["labels"])
    assert feats.curvature.dtype == torch.float32
    np.testing.assert_array_equal(feats.curvature.numpy().view(np.int32),
                                  rec["curvature"].view(np.int32))
    for name in ("edge_xyz", "edge_valid", "surface_xyz", "surface_valid"):
        np.testing.assert_array_equal(getattr(feats, name).numpy(),
                                      rec[name], err_msg=name)


@pytest.mark.parametrize("case", rc.CASES)
def test_registration_on_reference_features(committed, port, case):
    """kitti_hdl64 in float32 against the record's localize_scan (which
    registered these very features); vlp16 in float64 against the
    reference's float64 run."""
    rec = rc.case_arrays(committed[0], case)
    want = "localize" if case in KITTI else "localize64"
    _assert_results(port[case]["register"], rec, "register", want,
                    CPU_ATOL, CPU_ATOL)


@pytest.mark.parametrize("case", rc.CASES)
def test_localize_scan_end_to_end(committed, port, case):
    rec = rc.case_arrays(committed[0], case)
    got = port[case]
    if case in KITTI:
        _assert_results(got["localize"], rec, "localize", "localize",
                        rc.T_ATOL, rc.Q_ATOL)
        _assert_results(got["one_iteration"], rec, "one_iteration",
                        "one_iteration", rc.T_ATOL, rc.Q_ATOL)
        return
    # vlp16: float64 is held to the reference's float64 run, float32 to
    # the record as under kitti_hdl64 (ROADMAP §C19).
    _assert_results(got["localize64"], rec, "localize64", "localize64",
                    CPU_ATOL, CPU_ATOL)
    _assert_results(got["localize"], rec, "localize", "localize",
                    rc.T_ATOL, rc.Q_ATOL)


@pytest.mark.parametrize("scene", rc.SCENES)
def test_float64_labels_equal_the_reference(scene):
    """In float64 the reference contracts too and the port does not
    (ROADMAP §C6); the full-width kitti_hdl64 labels are bit-equal all
    the same."""
    import jax.numpy as jnp

    case = f"kitti_hdl64/{scene}"
    cfg = trr.ref_config("kitti_hdl64")
    ex = cfg.extraction
    xyz, _ = rc.scene_scan(scene, ex.n_rings, ex.max_points_per_ring)
    want = trr.jex.extract_features(trr.ref_image(np.float64(xyz)), ex)
    assert want.curvature.dtype == jnp.float64
    got, curv = trr.port_labels(case, np.float64)
    assert curv.dtype == np.float64
    np.testing.assert_array_equal(got, np.asarray(want.labels))
