"""The full-width reference record of the port's main path: its cases,
their inputs and the rule that the port's label differences from the
JAX package must pass. numpy and torch only (no JAX): ``chip_smoke.py``
reads the record on the card, ``tests/torch_reference_record.py`` writes
it from the JAX package on the CPU, and ``tests/test_torch_fullwidth.py``
holds both packages to it.

A case is one scene under one preset of ``pipeline/launch.py`` at the
preset's full width:

- ``kitti_hdl64``: 64 x 2304, the compact extraction over
  ``GeometryMaps``; ``vlp16``: 16 x 1856, the full extraction over
  ``FeatureMaps`` (the kNN rounds);
- scenes: bench.py's scan (``bench_scan``, numpy seed 0) and a street
  canyon (``street_world`` from numpy seed 0) scanned at the identity
  (``street_scan`` from numpy seed 1);
- priors: bench.py's best case t = (0.3, -0.2, 0.05), and it with a
  0.2 m offset in a random direction and a yaw of N(0, 1 degree) drawn
  from numpy seeds 7-10;
- maps: the features that the reference's labels select from the scan
  (the full extraction's, ``compact_by_mask`` in scan order), copied to
  7 noisy keyframe poses (``keyframe_copies``, drawing on from the
  scene's generator after its scan, edges first), and one far anchor
  point that gives every case of a preset grids of one shape
  (``GRID_EXTENT``). Each package builds its own maps from these
  clouds.

The record holds, per case, what the JAX package computes: labels and
curvature, the features ``localize_scan`` registers, and the status,
iterations, pose, error and scale of ``localize_scan`` for every prior
(it registers exactly the recorded features, so these are also the
results of the registration fed them). The port computes the
extraction's float32 arithmetic as the reference's jitted code does,
fused multiply-adds included (ROADMAP §C18), so its labels and
curvature equal the record's bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np

PRESETS = ("kitti_hdl64", "vlp16")
SCENES = ("bench", "street")
CASES = tuple(f"{preset}/{scene}" for preset in PRESETS for scene in SCENES)
NOISY_SEEDS = (7, 8, 9, 10)
BEST_T = (0.3, -0.2, 0.05)

HERE = os.path.dirname(os.path.abspath(__file__))
RECORD = os.path.join(HERE, "tests", "data", "torch_reference_fullwidth.npz")
MANIFEST = os.path.join(HERE, "tests", "data",
                        "torch_reference_fullwidth.json")

# Every map cloud ends with one anchor point this far above its low
# corner snapped to the map's voxel lattice. The grid's origin (the
# snapped low corner) stays where the cloud puts it, and its shape
# becomes the same for every case of a preset (the extent over the voxel
# size, plus margins), so the reference compiles each of its programs
# once per preset, not once per scene. The extent holds every scene's
# cloud (the street's walls span 123 m in x), and the anchor lies
# beyond the reach of any map voxel a scan point looks up.
GRID_EXTENT = np.array([128.0, 48.0, 16.0])

# Label codes, as the package's PointLabel enum.
EDGE, SURFACE = 1, 3

# Registration fed the reference's own features (kitti_hdl64 in float32,
# vlp16 in float64), and localize_scan end to end under both presets in
# float32: status and iterations equal, the pose within these of the
# record (metres; per quaternion component). The float32 normal equations
# are summed in another order. The vlp16 float32 run meets them because
# its kNN fits compute the reference's contracted float32 forms (ROADMAP
# §C19): its plane fit is ill-conditioned, so one-rounding-per-operation
# fits end centimetres away, with other statuses.
T_ATOL = Q_ATOL = 1e-4


def split(case: str) -> tuple[str, str]:
    preset, scene = case.split("/")
    return preset, scene


def scene_scan(scene: str, n_rings: int, n_points: int):
    """(float32 [R, P, 3] scan, the generator after its draws)."""
    from lidar_feature_extraction_tpu_torch.utils.synthetic import (
        bench_scan, street_scan, street_world)

    if scene == "bench":
        rng = np.random.default_rng(0)
        return bench_scan(rng, n_rings, n_points), rng
    world = street_world(np.random.default_rng(0))
    rng = np.random.default_rng(1)
    return street_scan(world, rng, n_rings, n_points), rng


def priors() -> tuple[np.ndarray, np.ndarray]:
    """q [5, 4] (wxyz) and t [5, 3], float32: the best case, then the
    noisy priors of numpy seeds 7-10."""
    qs, ts = [np.array([1.0, 0.0, 0.0, 0.0])], [np.array(BEST_T)]
    for seed in NOISY_SEEDS:
        rng = np.random.default_rng(seed)
        d = rng.normal(size=3)
        yaw = np.radians(1.0) * rng.normal()
        ts.append(np.array(BEST_T) + 0.2 * d / np.linalg.norm(d))
        qs.append(np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]))
    return np.float32(qs), np.float32(ts)


def selected_points(xyz: np.ndarray, take: np.ndarray,
                    capacity: int) -> np.ndarray:
    """The points of [R, P, 3] where ``take``, in scan order, at most
    ``capacity`` (the full extraction's ``compact_by_mask``)."""
    return xyz.reshape(-1, 3)[take.reshape(-1)][:capacity]


def map_clouds(xyz: np.ndarray, labels: np.ndarray, rng,
               cfg) -> tuple[np.ndarray, np.ndarray]:
    """float32 edge and surface map clouds: the features ``labels``
    select (at most ``max_edges`` / ``max_surfaces``), at 7 noisy
    keyframe copies drawn from ``rng``, each with its grid anchor."""
    from lidar_feature_extraction_tpu_torch.utils.synthetic import (
        keyframe_copies)

    ex, reg = cfg.extraction, cfg.registration
    out = []
    for code, cap, voxel in ((EDGE, ex.max_edges, reg.edge_map.voxel_size),
                             (SURFACE, ex.max_surfaces,
                              reg.surface_map.voxel_size)):
        pts = keyframe_copies(rng, selected_points(xyz, labels == code, cap))
        anchor = np.floor(pts.min(axis=0) / voxel) * voxel + GRID_EXTENT
        out.append(np.float32(np.concatenate([pts, anchor[None]])))
    return tuple(out)


def load(path: str = RECORD, manifest: str = MANIFEST):
    """(arrays by name, the manifest) of the committed record."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    with open(manifest) as f:
        return arrays, json.load(f)


def case_arrays(arrays: dict, case: str) -> dict:
    """The record's arrays of one case, by their short names."""
    prefix = case.replace("/", ".") + "."
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def port_image(case: str, cfg, device, dtype=None):
    """The case's scan as the port's range image on ``device``, in
    ``dtype`` (float32 by default)."""
    import torch

    from lidar_feature_extraction_tpu_torch.core.scan import RangeImage

    ex = cfg.extraction
    R, P = ex.n_rings, ex.max_points_per_ring
    xyz, _ = scene_scan(split(case)[1], R, P)
    return RangeImage(
        torch.as_tensor(xyz, dtype=dtype or torch.float32, device=device),
        torch.ones((R, P), dtype=torch.bool, device=device),
        torch.full((R,), P, dtype=torch.int32, device=device))


def port_maps(case: str, labels, cfg, device, dtype=None):
    """The port's maps of a case, built from the map clouds of the
    record's labels: GeometryMaps for the compact path, else FeatureMaps;
    every float field in ``dtype`` (float32 by default)."""
    import torch

    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        build_feature_maps, build_geometry_maps)

    ex = cfg.extraction
    xyz, rng = scene_scan(split(case)[1], ex.n_rings, ex.max_points_per_ring)
    edge, surf = map_clouds(xyz, labels, rng, cfg)
    dtype = dtype or torch.float32
    build = build_geometry_maps if cfg.compact_extraction \
        else build_feature_maps
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    ones = lambda a: torch.ones(len(a), dtype=torch.bool,  # noqa: E731
                                device=device)
    maps = build(as_t(edge), ones(edge), as_t(surf), ones(surf), cfg)

    def cast(tree):
        return type(tree)(*(
            a.to(dtype) if isinstance(a, torch.Tensor)
            and a.is_floating_point()
            else cast(a) if isinstance(a, tuple) and hasattr(a, "_fields")
            else a for a in tree))

    return cast(maps)


def port_poses(device, dtype=None) -> list:
    import torch

    from lidar_feature_extraction_tpu_torch.core.pose import Pose

    qs, ts = priors()
    return [Pose(torch.as_tensor(q, dtype=dtype or torch.float32,
                                 device=device),
                 torch.as_tensor(t, dtype=dtype or torch.float32,
                                 device=device)) for q, t in zip(qs, ts)]


def one_iteration(cfg):
    """``cfg`` with Gauss-Newton stopped after one iteration."""
    return dataclasses.replace(cfg, registration=dataclasses.replace(
        cfg.registration, max_iterations=1))


def results_arrays(results) -> dict:
    """Gauss-Newton results of the priors (either package's) as stacked
    numpy arrays, by the record's field names."""
    def stack(get):
        return np.stack([np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                         for a in map(get, results)])

    return {"status": np.int32([int(r.status) for r in results]),
            "iterations": np.int32([int(r.iterations) for r in results]),
            "q": stack(lambda r: r.pose.q), "t": stack(lambda r: r.pose.t),
            "error": stack(lambda r: r.error),
            "scale": stack(lambda r: r.scale)}


def ref_features_tensors(rec: dict, device, dtype=None) -> tuple:
    """The record's features as tensors: edge xyz, valid, surface xyz,
    valid."""
    import torch

    f = lambda k: torch.as_tensor(rec[k], dtype=dtype or torch.float32,  # noqa: E731
                                  device=device)
    b = lambda k: torch.as_tensor(rec[k], device=device)  # noqa: E731
    return (f("edge_xyz"), b("edge_valid"), f("surface_xyz"),
            b("surface_valid"))


def register_on_features(maps, feats: tuple, poses: list, cfg) -> dict:
    """The registration ``localize_scan`` runs, fed ``feats``, from every
    prior: ``register_scan_geometry`` pre-downsampled (compact path) or
    ``register_scan``."""
    from lidar_feature_extraction_tpu_torch.pipeline import localization

    if cfg.compact_extraction:
        return results_arrays([localization.register_scan_geometry(
            maps, *feats, p, cfg, pre_downsampled=True) for p in poses])
    return results_arrays([localization.register_scan(maps, *feats, p, cfg)
                           for p in poses])


# --- eval_ate.py's closed-loop drive (ROADMAP §C20) ---------------------
#
# The second record, ``tests/data/torch_reference_drive.npz`` and its
# manifest, holds what the JAX package's ``FusedLocalizationPipeline``
# computes over eval_ate.py's 20-scan drive (numpy seed 0: 50 poles over
# 35 m, 30,000 ground map points, 64 x 2048 ray-cast scans with vehicle
# twists) under ``kitti_hdl64()`` (production: compact extraction,
# GeometryMaps) and its faithful variant (full extraction, FeatureMaps,
# a refit every iteration): per scan the prior the EKF gave, the Gauss-
# Newton status, iterations, error and scale, and the measured and fused
# poses; and, at one scan's prior per drive, the first iteration's
# per-correspondence errors, valid mask and scale with digests of its
# Jacobian and residual rows. The inputs are the port's worldsim draws,
# held to the record by a digest.

DRIVE_RECORD = os.path.join(HERE, "tests", "data",
                            "torch_reference_drive.npz")
DRIVE_MANIFEST = os.path.join(HERE, "tests", "data",
                              "torch_reference_drive.json")
DRIVES = ("production", "faithful")
DRIVE_SCANS = 20
# The scan at whose prior each drive's first Gauss-Newton problem is
# recorded: where the two packages parted before §C20.
DRIVE_PROBE = {"production": 4, "faithful": 10}
# Measured and fused positions against the record (metres). Since ROADMAP
# §C21 the port's drives equal the record bit for bit on the CPU and the
# card; 1e-6 m is the tolerance the repair was held to.
DRIVE_T_ATOL = 1e-6


# The normal equations held to the JAX package's (ROADMAP §C21): seeded
# problems of these row counts (XLA:CPU's contraction unsharded, sharded
# in 6 blocks, in 8, and the faithful and production drives' rows; all at
# least 4096 rows, where XLA keeps the gradient's tiled matrix-vector
# loop), their D = jv^T j, A = jw^T j and b = j^T wr, and the ±2^40 probe
# pairs of each, whose sums fingerprint the summation tree; and Huber
# weights (XLA's float32 rsqrt) of seeded squared errors.
NE_ROWS = (4099, 7991, 8198, 10240, 14336)
NE_PROBE_PAIRS = 24
HUBER_SAMPLES = 4096


def ne_problem(m: int) -> tuple:
    """(jv, jw, j, wr) float32 of the seeded problem with ``m`` rows:
    ``j`` normal, 90% of the rows valid, exponential weights, normal
    residuals."""
    rng = np.random.default_rng(m)
    j = np.float32(rng.normal(size=(m, 7)))
    valid = np.float32(rng.random(m) < 0.9)
    w = np.float32(rng.exponential(size=m)) * valid
    r = np.float32(rng.normal(size=m))
    return (np.float32(j * valid[:, None]), np.float32(j * w[:, None]), j,
            np.float32(w * r))


def ne_probe_pairs(m: int) -> np.ndarray:
    """[NE_PROBE_PAIRS, 2] rows (p < q) of the probe: neighbours, pairs a
    block size apart, the ends, and seeded ones."""
    rng = np.random.default_rng(1000 + m)
    fixed = [(0, 1), (0, m - 1), (m - 2, m - 1), (0, 320), (319, 320),
             (0, m // 2), (m // 4, 3 * m // 4), (7, 608)]
    pairs = [(p, q) for p, q in fixed if p < q < m]
    while len(pairs) < NE_PROBE_PAIRS:
        p, q = sorted(int(x) for x in rng.choice(m, 2, replace=False))
        pairs.append((p, q))
    return np.int64(pairs)


def probe_operands(m: int, p: int, q: int) -> tuple:
    """The probe's ``a`` (all ones, rows p and q +2^40 and -2^40) and
    ``b`` (all ones), [m, 7] float32: entry (i, j) of ``a.T @ b`` counts
    the rows added after rows p and q met."""
    a = np.ones((m, 7), np.float32)
    a[p], a[q] = 2.0 ** 40, -2.0 ** 40
    return a, np.ones((m, 7), np.float32)


def huber_inputs() -> np.ndarray:
    """Seeded float32 squared errors over twelve decades, for the Huber
    weights."""
    rng = np.random.default_rng(5)
    return np.float32(rng.exponential(size=HUBER_SAMPLES)
                      * 10.0 ** rng.uniform(-3, 9, HUBER_SAMPLES))


def drive_config(name: str, production):
    """The drive's configuration (either package's ``PipelineConfig``):
    ``production`` itself, or its faithful variant."""
    if name == "production":
        return production
    return dataclasses.replace(
        production, compact_extraction=False,
        registration=dataclasses.replace(production.registration,
                                         refit_per_iteration=True))


def drive_inputs():
    """eval_ate.py's draws, made by the port's worldsim: (edge map
    cloud, surface map cloud, scans [(points, ring ids)], ground-truth
    positions, twists), then the world and the generator, which
    eval_ate.py's SLAM drives go on drawing from."""
    from lidar_feature_extraction_tpu_torch.utils import worldsim

    rng = np.random.default_rng(0)
    world = worldsim.make_world(rng, n_poles=50, extent=35.0)
    edges, surfs = worldsim.world_maps(world, rng, n_ground=30000)
    scans, gt = worldsim.make_scan_sequence(
        world, rng, n_scans=DRIVE_SCANS, n_rings=64, n_az=2048,
        elev_deg=(2.0, -24.8))
    twists = worldsim.synth_twists(len(scans), rng=rng)
    return edges, surfs, scans, gt, twists, world, rng


def drive_inputs_sha256(edges, surfs, scans, gt, twists) -> str:
    """The digest of the drive's inputs, as the record holds it."""
    h = hashlib.sha256()
    for a in (edges, surfs, gt, twists):
        h.update(np.ascontiguousarray(a, dtype=np.float64).tobytes())
    for pts, ring in scans:
        h.update(np.ascontiguousarray(pts, dtype=np.float64).tobytes())
        h.update(np.ascontiguousarray(ring, dtype=np.int64).tobytes())
    return h.hexdigest()


def rows_sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def load_drive():
    """(arrays by ``<drive>.<name>``, the manifest) of the drive record."""
    return load(DRIVE_RECORD, DRIVE_MANIFEST)


def drive_arrays(arrays: dict, name: str) -> dict:
    """The drive record's arrays of one drive, by their short names."""
    return case_arrays(arrays, name)


def scan_fields(results) -> dict:
    """Per-scan fields of a drive (either package's results: (prior,
    GNResult, measured pose, fused pose) per scan) as the record's
    stacked arrays."""
    def vec(get):
        return np.stack([np.asarray(a.cpu() if hasattr(a, "cpu") else a,
                                    dtype=np.float32)
                         for a in map(get, results)])

    return {"status": np.int32([int(g.status) for _, g, _, _ in results]),
            "iterations": np.int32([int(g.iterations)
                                    for _, g, _, _ in results]),
            "error": vec(lambda r: r[1].error),
            "scale": vec(lambda r: r[1].scale),
            "prior_q": vec(lambda r: r[0].q), "prior_t": vec(lambda r: r[0].t),
            "measured_q": vec(lambda r: r[2].q),
            "measured_t": vec(lambda r: r[2].t),
            "fused_q": vec(lambda r: r[3].q), "fused_t": vec(lambda r: r[3].t)}


def port_drive(maps, cfg, scans, twists, device, n_scans=None,
               ms=None) -> dict:
    """The port's ``FusedLocalizationPipeline`` over the first
    ``n_scans`` of the drive on ``device``: the record's per-scan
    fields. With ``ms`` a list, each scan's host time in milliseconds is
    appended to it (``process_scan`` through ``torch.cuda.synchronize()``
    on a CUDA device)."""
    import time

    import torch

    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.pipeline import replay

    pipeline = replay.FusedLocalizationPipeline(
        maps, cfg, initial_pose=Pose.identity(device=device), device=device)
    steps, results = [], []
    localize = replay.localize_scan

    def recorded(maps_, image, prior, cfg_):
        out = localize(maps_, image, prior, cfg_)
        steps.append((prior, out[0]))
        return out

    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else lambda: None)
    replay.localize_scan = recorded
    try:
        sync()
        for i, (pts, ring) in enumerate(scans[:n_scans]):
            start = time.perf_counter()
            r = pipeline.process_scan(pts, ring, stamp=0.1 * i,
                                      twist=twists[i])
            if ms is not None:
                sync()
                ms.append(1e3 * (time.perf_counter() - start))
            results.append((*steps[-1], r.measured_pose, r.fused_pose))
    finally:
        replay.localize_scan = localize
    return scan_fields(results)


def port_first_problem(maps, image, prior, cfg):
    """The first Gauss-Newton problem ``localize_scan`` builds from
    ``prior`` (the port's): the Problem and its MAD scale."""
    from lidar_feature_extraction_tpu_torch.core import stats
    from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        localize_scan)

    seen = []
    make = gn.make_problem

    def recorded(blocks):
        seen.append(make(blocks))
        return seen[-1]

    gn.make_problem = recorded
    try:
        localize_scan(maps, image, prior, one_iteration(cfg))
    finally:
        gn.make_problem = make
    problem = seen[0]
    return problem, stats.masked_scale_bisect(problem.errors, problem.valid)


def drive_gaps(got: dict, want: dict, n: int) -> dict:
    """How the first ``n`` scans of a drive (``port_drive``'s fields)
    differ from the record's: the scans whose status or iterations
    differ, the first of them, and the largest measured and fused
    position gaps (metres)."""
    differ = [int(i) for i in np.nonzero(
        (got["status"][:n] != want["status"][:n])
        | (got["iterations"][:n] != want["iterations"][:n]))[0]]
    gap = {k: float(np.abs(got[k][:n] - want[k][:n]).max())
           for k in ("measured_t", "fused_t")}
    far = [int(i) for i in np.nonzero(np.abs(
        got["measured_t"][:n] - want["measured_t"][:n]).max(-1)
        > DRIVE_T_ATOL)[0]]
    return {"scans": n, "status_or_iterations_differ": differ,
            "positions_beyond_atol": far,
            "first_scan_that_differs": min(differ + far, default=None),
            "max_measured_t_gap_m": gap["measured_t"],
            "max_fused_t_gap_m": gap["fused_t"]}


def main(argv=None) -> int:
    """Run the port's two drives over the drive record's inputs on a
    device and print, per drive, the record's and the port's ATE and how
    the port's scans differ from the record's (``drive_gaps`` over all
    scans, and the measured position gap of every scan)."""
    import argparse
    import sys

    import torch

    from lidar_feature_extraction_tpu_torch.config import kitti_hdl64
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        build_feature_maps, build_geometry_maps)
    from lidar_feature_extraction_tpu_torch.utils.evaluation import ate_rmse

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    sys.path.insert(0, HERE)
    edges, surfs, scans, gt, twists, _, _ = drive_inputs()
    arrays, manifest = load_drive()
    if drive_inputs_sha256(edges, surfs, scans, gt, twists) \
            != manifest["inputs_sha256"]:
        print("the worldsim draws differ from the record's inputs")
        return 1
    clouds = (torch.as_tensor(edges, dtype=torch.float32, device=dev),
              torch.ones(len(edges), dtype=torch.bool, device=dev),
              torch.as_tensor(surfs, dtype=torch.float32, device=dev),
              torch.ones(len(surfs), dtype=torch.bool, device=dev))
    for name in DRIVES:
        cfg = drive_config(name, kitti_hdl64())
        build = (build_geometry_maps if name == "production"
                 else build_feature_maps)
        got = port_drive(build(*clouds, cfg), cfg, scans, twists, dev)
        want = drive_arrays(arrays, name)
        print(json.dumps({
            "drive": name, "device": str(dev),
            "record_ate_m": manifest["drives"][name]["ate_rmse_m"],
            "port_ate_m": ate_rmse(np.float64(got["measured_t"]), gt,
                                   align=False),
            **drive_gaps(got, want, DRIVE_SCANS),
            "measured_t_gap_per_scan_m": np.abs(
                got["measured_t"] - want["measured_t"]).max(-1).tolist()}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
