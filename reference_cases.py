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
