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
- The port's labels (CPU, float32) equal the record's except at the
  listed lanes, each a neighbour swap of the rule in ``reference_cases``
  (the two packages order a near-tie of curvatures differently: XLA:CPU
  contracts the range's ``x * x + y * y`` into an FMA, the port rounds
  twice, ROADMAP §C6, §C18). In float64 there is no difference at all.
- Registration fed the reference's own features: status and iterations
  equal, the pose within 1e-5 m and 1e-5 per quaternion component,
  under ``kitti_hdl64`` in float32 and under ``vlp16`` in float64 (the
  kNN path's float32 plane fit is ill-conditioned, ROADMAP §C8).
- ``localize_scan`` end to end: status and iterations equal, the pose
  within 1e-4 of the record, or ``SWAP_T_ATOL`` where the case lists
  swaps; the first Gauss-Newton iteration likewise. Under ``vlp16`` the
  features equal the record's bit for bit, the float64 run is held to
  the reference's float64 run within 1e-5, and the float32 run only
  within ``KNN_F32_T_ATOL``.
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
    ties = [c["tie_ulps"] for m in manifest["cases"].values()
            for c in m["swaps"]]
    assert ties and max(ties) == manifest["tie_ulps_max"]
    assert manifest["tie_ulps_bound"] <= 4


@pytest.mark.parametrize("case", rc.CASES)
def test_port_labels_differ_only_by_listed_swaps(committed, port, case):
    """The port's labels from localize_scan equal the record's except at
    the listed lanes, where they are the listed ones; each cluster passes
    the swap rule within the record's ulp bound."""
    arrays, manifest = committed
    rec = rc.case_arrays(arrays, case)
    m = manifest["cases"][case]
    got = port[case]["features"].labels.numpy()
    listed = rc.listed_lanes(m)
    differ = {(int(r), int(i)) for r, i in np.argwhere(got != rec["labels"])}
    assert differ == set(listed)
    assert all(got[r, i] == lab for (r, i), lab in listed.items())
    xyz, _ = rc.scene_scan(m["scene"], *m["shape"])
    swaps = rc.label_swaps(rec["labels"], got, rec["curvature"],
                           port[case]["features"].curvature.numpy(), xyz,
                           m["padding"], manifest["tie_ulps_bound"])
    assert swaps == m["swaps"]


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
    arrays, manifest = committed
    rec = rc.case_arrays(arrays, case)
    got = port[case]
    if case in KITTI:
        t_atol = rc.SWAP_T_ATOL if manifest["cases"][case]["swaps"] \
            else rc.T_ATOL
        _assert_results(got["localize"], rec, "localize", "localize",
                        t_atol, rc.Q_ATOL)
        _assert_results(got["one_iteration"], rec, "one_iteration",
                        "one_iteration", t_atol, rc.Q_ATOL)
        return
    # vlp16: the features are the record's; float64 is held tightly.
    feats = got["features"]
    for name in ("edge_xyz", "edge_valid", "surface_xyz", "surface_valid"):
        np.testing.assert_array_equal(getattr(feats, name).numpy(),
                                      rec[name], err_msg=name)
    _assert_results(got["localize64"], rec, "localize64", "localize64",
                    CPU_ATOL, CPU_ATOL)
    np.testing.assert_allclose(got["localize"]["t"], rec["localize_t"],
                               rtol=0, atol=rc.KNN_F32_T_ATOL)


def test_swap_cases_move_the_pose_as_recorded(committed, port):
    """Where labels swap, the end-to-end pose parts from the record by
    more than 1e-4 on some prior (the reason ``SWAP_T_ATOL`` exists),
    while the registration fed the reference's features stays within
    1e-5 on every prior."""
    arrays, manifest = committed
    parted = []
    for case in KITTI:
        assert manifest["cases"][case]["swaps"]
        rec = rc.case_arrays(arrays, case)
        got = port[case]
        dt = np.abs(got["localize"]["t"] - rec["localize_t"]).max()
        parted.append(dt > rc.T_ATOL)
        assert np.abs(got["register"]["t"] - rec["localize_t"]).max() \
            <= CPU_ATOL
    assert any(parted)


@pytest.mark.parametrize("scene", rc.SCENES)
def test_float64_labels_equal_the_reference(scene):
    """In float64 neither package contracts anything that matters: the
    full-width kitti_hdl64 labels are bit-equal."""
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
