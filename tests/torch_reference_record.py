"""Write, or check, the full-width reference record of the port's main
path (``tests/data/torch_reference_fullwidth.npz`` and its JSON
manifest): what the JAX package computes on the CPU for every case of
``reference_cases.py``.

    JAX_PLATFORMS=cpu python tests/torch_reference_record.py --write
    JAX_PLATFORMS=cpu python tests/torch_reference_record.py   # compare
    JAX_PLATFORMS=cpu python tests/torch_reference_record.py --drive --write
    JAX_PLATFORMS=cpu python tests/torch_reference_record.py --mapping --write

With ``--drive`` it writes (or checks) the second record,
``tests/data/torch_reference_drive.npz`` and its manifest: eval_ate.py's
closed-loop drive through the JAX package's ``FusedLocalizationPipeline``
under both configurations (``reference_cases.py`` says what it holds),
with the first update's Huber weights and normal equations at each
drive's recorded prior; and what XLA:CPU computes for the normal
equations of seeded problems, for ±2^40 probe pairs and for the Huber
weights (ROADMAP §C21). XLA:CPU runs the normal equations' matrix
products through Eigen, whose summation order depends on the number of
threads it is given, so the drive record is what a machine with the
manifest's ``cpu_count`` writes; the writer raises unless the port's
forms (``core/_xla_dot.py``) give the same bits on the writing machine, and
names their parameters in the manifest (``xla_cpu_contraction``).

With ``--mapping`` it writes (or checks) the third record,
``tests/data/torch_reference_mapping.npz`` and its manifest: the JAX
package's mapper at ``kitti_hdl64()`` widths, bench_odometry.py's
100-frame extracted-feature chain (its jitted ``lax.scan``) and
eval_ate.py's 80-scan ``slam_loop`` drive without IMU
(``reference_cases.py`` says what it holds; ~10 min on 8 cores).

Per case (a scene under ``kitti_hdl64()`` or ``vlp16()`` at full width)
and prior: the reference's labels (int8, and their sha256) and
curvature; the features ``localize_scan`` registers (the compact ones
under ``kitti_hdl64``, the full ones under ``vlp16``) with their valid
masks; the status, iterations, pose, error and scale of
``localize_scan`` (which registers exactly those features, so these are
also the results of ``register_scan_geometry`` pre-downsampled, or of
``register_scan``, fed them); under ``kitti_hdl64`` the same of
``localize_scan`` stopped after one Gauss-Newton iteration, and under
``vlp16`` of ``localize_scan`` in float64 (scan, map clouds and priors:
the kNN path's float32 plane fit is ill-conditioned, ROADMAP §C8). The
manifest names the cases, their shapes, label counts and the labels'
hash, and the package versions.

``jax_enable_x64`` is on, as in the test suite (test_extraction turns it
on at import); inputs are float32 on both sides. The port runs on the
CPU with two threads, as in the parity tests (``port_labels``, which
``tests/test_torch_fullwidth.py`` holds to the record).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
for _p in (_ROOT, _HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_enable_x64", True)   # as in-suite (test_extraction)
torch.set_num_threads(2)                     # as the parity tests

import reference_cases as rc  # noqa: E402
from lidar_feature_extraction_tpu import config as jconfig  # noqa: E402
from lidar_feature_extraction_tpu.core.pose import Pose as JPose  # noqa: E402
from lidar_feature_extraction_tpu.core.scan import (  # noqa: E402
    RangeImage as JImage)
from lidar_feature_extraction_tpu.ops import extraction as jex  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    localization as jloc)
from lidar_feature_extraction_tpu_torch.interop import (  # noqa: E402
    range_image_from_numpy)
from lidar_feature_extraction_tpu_torch.ops.extraction import (  # noqa: E402
    label_range_image)
from lidar_feature_extraction_tpu_torch.pipeline import launch  # noqa: E402


def ref_config(preset: str):
    return getattr(jconfig, preset)()


def ref_image(xyz) -> JImage:
    R, P = xyz.shape[:2]
    return JImage(jnp.asarray(xyz), jnp.ones((R, P), bool),
                  jnp.full(R, P, jnp.int32))


def ref_features(img: JImage, cfg):
    """The features ``localize_scan`` registers under ``cfg``."""
    ex = cfg.extraction
    if cfg.compact_extraction:
        return jex.extract_features_compact(
            img, ex, surface_leaf=cfg.registration.surface_downsample_leaf,
            edges_per_ring=ex.edges_per_ring,
            surface_runs_per_ring=ex.surface_runs_per_ring,
            surface_centroid=ex.compact_surface_centroid)
    return jex.extract_features(img, ex)


def ref_maps(edge, surf, cfg):
    """Each package builds its own maps from the same clouds: the
    reference's here (GeometryMaps for the compact path, else
    FeatureMaps)."""
    build = (jloc.build_geometry_maps if cfg.compact_extraction
             else jloc.build_feature_maps)
    return build(jnp.asarray(edge), jnp.ones(len(edge), bool),
                 jnp.asarray(surf), jnp.ones(len(surf), bool), cfg)


def reference_case(case: str) -> dict:
    """What the JAX package computes for ``case``: arrays by name."""
    preset, scene = rc.split(case)
    cfg = ref_config(preset)
    ex = cfg.extraction
    xyz, rng = rc.scene_scan(scene, ex.n_rings, ex.max_points_per_ring)
    img = ref_image(xyz)
    feats = ref_features(img, cfg)
    labels = np.asarray(feats.labels)
    edge, surf = rc.map_clouds(xyz, labels, rng, cfg)
    maps = ref_maps(edge, surf, cfg)
    qs, ts = rc.priors()
    poses = [JPose(jnp.asarray(q), jnp.asarray(t)) for q, t in zip(qs, ts)]
    out = {"labels": labels.astype(np.int8),
           "curvature": np.asarray(feats.curvature),
           "edge_xyz": np.asarray(feats.edge_xyz),
           "edge_valid": np.asarray(feats.edge_valid),
           "surface_xyz": np.asarray(feats.surface_xyz),
           "surface_valid": np.asarray(feats.surface_valid)}
    # localize_scan registers exactly the features recorded above, so
    # its results are also those of the registration fed them.
    runs = {"localize": [jloc.localize_scan(maps, img, p, cfg)[0]
                         for p in poses]}
    if cfg.compact_extraction:
        runs["one_iteration"] = [jloc.localize_scan(
            maps, img, p, rc.one_iteration(cfg))[0] for p in poses]
    else:
        # The kNN path's float32 plane fit is ill-conditioned (ROADMAP
        # §C8): the whole step again in float64 (scan, clouds, priors).
        maps64 = ref_maps(np.float64(edge), np.float64(surf), cfg)
        img64 = ref_image(np.float64(xyz))
        runs["localize64"] = [jloc.localize_scan(
            maps64, img64, JPose(jnp.asarray(np.float64(q)),
                                 jnp.asarray(np.float64(t))), cfg)[0]
            for q, t in zip(qs, ts)]
    for run, results in runs.items():
        for field, a in rc.results_arrays(results).items():
            out[f"{run}_{field}"] = a
    return out


def port_labels(case: str, dtype=np.float32):
    """The port's labels and curvature (numpy) for ``case`` on the CPU,
    with the scan in ``dtype``."""
    from lidar_feature_extraction_tpu_torch.core.scan import RangeImage

    preset, scene = rc.split(case)
    ex = launch.load_config(preset).extraction
    R, P = ex.n_rings, ex.max_points_per_ring
    xyz, _ = rc.scene_scan(scene, R, P)
    img = range_image_from_numpy(xyz, np.ones((R, P), bool),
                                 np.full(R, P, np.int32), "cpu")
    if dtype != np.float32:
        img = RangeImage(torch.as_tensor(xyz.astype(dtype)), img.mask,
                         img.count)
    labels, curv = label_range_image(img, ex)
    return labels.numpy(), curv.numpy()


def labels_sha256(labels: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        labels, dtype=np.int8).tobytes()).hexdigest()


def case_manifest(case: str, arrays: dict) -> dict:
    """The manifest's entry of ``case``: shape, counts and the labels'
    hash."""
    preset, scene = rc.split(case)
    ex = ref_config(preset).extraction
    return {"preset": preset, "scene": scene,
            "shape": [ex.n_rings, ex.max_points_per_ring],
            "padding": ex.padding, "nms_rounds": ex.nms_rounds,
            "labels_sha256": labels_sha256(arrays["labels"]),
            "edges": int((arrays["labels"] == rc.EDGE).sum()),
            "surfaces": int((arrays["labels"] == rc.SURFACE).sum())}


def build_record() -> tuple[dict, dict]:
    """(arrays by ``<preset>.<scene>.<name>``, manifest) of every case."""
    arrays, cases = {}, {}
    qs, ts = rc.priors()
    arrays["prior_q"], arrays["prior_t"] = qs, ts
    for case in rc.CASES:
        got = reference_case(case)
        cases[case] = case_manifest(case, got)
        for name, a in got.items():
            arrays[f"{case.replace('/', '.')}.{name}"] = a
    manifest = {
        "written_by": "JAX_PLATFORMS=cpu python tests/"
                      "torch_reference_record.py --write",
        "versions": {"jax": jax.__version__, "numpy": np.__version__,
                     "torch": torch.__version__,
                     "python": sys.version.split()[0]},
        "jax_enable_x64": True,
        "priors": "best case t = (0.3, -0.2, 0.05), then numpy seeds "
                  + ", ".join(map(str, rc.NOISY_SEEDS)),
        "runs": {"localize": "localize_scan; it registers the recorded "
                             "features, so these are also the results of "
                             "register_scan_geometry (pre_downsampled) or "
                             "register_scan fed them",
                 "one_iteration": "localize_scan with max_iterations=1 "
                                  "(kitti_hdl64 only)",
                 "localize64": "localize_scan in float64: scan, map "
                               "clouds and priors (vlp16 only, ROADMAP "
                               "§C8)"},
        "cases": cases}
    return arrays, manifest


def differences(arrays: dict, manifest: dict, want_arrays: dict,
                want_manifest: dict) -> list[str]:
    """What differs between a fresh record and the committed one (bit
    for bit; the package versions are not compared)."""
    out = sorted(set(arrays) ^ set(want_arrays))
    for k in sorted(set(arrays) & set(want_arrays)):
        a, b = arrays[k], want_arrays[k]
        if a.dtype != b.dtype or a.shape != b.shape \
                or a.tobytes() != b.tobytes():
            out.append(k)
    strip = lambda m: {k: v for k, v in m.items()  # noqa: E731
                       if k not in ("versions", "cpu_count")}
    if json.loads(json.dumps(strip(manifest))) != strip(want_manifest):
        out.append("manifest")
    return out


def write(arrays: dict, manifest: dict, record: str = rc.RECORD,
          manifest_path: str = rc.MANIFEST) -> None:
    os.makedirs(os.path.dirname(record), exist_ok=True)
    np.savez_compressed(record, **arrays)
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def reference_drive(name: str, inputs) -> tuple[dict, dict]:
    """What the JAX package's ``FusedLocalizationPipeline`` computes over
    eval_ate.py's drive under ``name``: the record's per-scan fields, and
    the first Gauss-Newton problem at the prior of scan
    ``rc.DRIVE_PROBE[name]`` (errors, valid mask, scale, digests of the
    rows). The problem is read from the program the drive runs, the
    jitted ``localize_scan``, traced again with ``jax.debug.callback`` on
    ``make_problem``'s and the MAD scale's outputs; that program must
    give the drive's result bit for bit, or this raises."""
    from lidar_feature_extraction_tpu.core import stats as jstats
    from lidar_feature_extraction_tpu.ops import gauss_newton as jgn
    from lidar_feature_extraction_tpu.ops import smallalg as jsmallalg
    from lidar_feature_extraction_tpu.pipeline.replay import (
        FusedLocalizationPipeline)

    edges, surfs, scans, _, twists = inputs
    cfg = rc.drive_config(name, jconfig.kitti_hdl64())
    build = (jloc.build_geometry_maps if name == "production"
             else jloc.build_feature_maps)
    maps = build(jnp.asarray(edges, jnp.float32),
                 jnp.ones(len(edges), bool),
                 jnp.asarray(surfs, jnp.float32),
                 jnp.ones(len(surfs), bool), cfg)
    pipeline = FusedLocalizationPipeline(maps, cfg,
                                         initial_pose=JPose.identity())
    step, steps, results = pipeline._step, [], []

    def recorded(m, image, prior):
        out = step(m, image, prior)
        steps.append((image, prior, out[0]))
        return out

    pipeline._step = recorded
    for i, (pts, ring) in enumerate(scans):
        r = pipeline.process_scan(pts, ring, stamp=0.1 * i, twist=twists[i])
        results.append((steps[-1][1], steps[-1][2], r.measured_pose,
                        r.fused_pose))

    image, prior, want = steps[rc.DRIVE_PROBE[name]]
    seen = {"problem": [], "scale": []}
    make, scale = jgn.make_problem, jstats.masked_scale_bisect

    def make_cb(blocks):
        p = make(blocks)
        jax.debug.callback(lambda *v: seen["problem"].append(
            [np.asarray(a) for a in v]), p.jac_rows, p.res_rows, p.errors,
            p.valid)
        return p

    def scale_cb(e, v):
        s = scale(e, v)
        jax.debug.callback(lambda x: seen["scale"].append(np.asarray(x)), s)
        return s

    update = jgn.weighted_update
    seen["update"] = []

    def update_cb(q, weights, problem, degeneracy_threshold):
        # The reference's weighted_update, with D, A and b read out.
        w = jnp.where(problem.valid, weights, 0.0)
        vf = problem.valid.astype(problem.jac_rows.dtype)
        w_rows = jgn.rows_from_corr(problem, w)[:, None]
        v_rows = jgn.rows_from_corr(problem, vf)[:, None]
        j = problem.jac_rows
        D = (j * v_rows).T @ j
        A = (j * w_rows).T @ j
        b = j.T @ (w_rows[:, 0] * problem.res_rows)
        M = jgn.make_m(q)
        H = M.T @ A @ M
        dx = -jsmallalg.cholesky_solve(H, M.T @ b)
        degenerate = jsmallalg.min_eigval_below(D, degeneracy_threshold)
        bad = degenerate | ~jnp.all(jnp.isfinite(dx))
        jax.debug.callback(lambda *v: seen["update"].append(
            [np.asarray(a) for a in v]), weights, D, A, b)
        return jnp.where(bad, jnp.zeros_like(dx), dx), H

    jgn.make_problem, jstats.masked_scale_bisect = make_cb, scale_cb
    jgn.weighted_update = update_cb
    try:
        jax.clear_caches()
        got, _ = jax.jit(lambda m, im, p: jloc.localize_scan(
            m, im, p, cfg))(maps, image, prior)
        jax.effects_barrier()
    finally:
        jgn.make_problem, jstats.masked_scale_bisect = make, scale
        jgn.weighted_update = update
        jax.clear_caches()
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in (
        (got.status, want.status), (got.iterations, want.iterations),
        (got.pose.q, want.pose.q), (got.pose.t, want.pose.t),
        (got.error, want.error), (got.scale, want.scale)))
    if not same:
        raise RuntimeError(f"{name}: the traced program with callbacks does "
                           "not give the drive's result")
    jac, res, errors, valid = seen["problem"][0]
    weights, d, a, b = seen["update"][0]
    probe = {"probe_errors": errors, "probe_valid": valid,
             "probe_scale": np.float32(seen["scale"][0]),
             "probe_weights": weights, "probe_D": d, "probe_A": a,
             "probe_b": b}
    digests = {"jac_rows_sha256": rc.rows_sha256(jac),
               "res_rows_sha256": rc.rows_sha256(res),
               "rows": int(jac.shape[0]), "correspondences": int(len(errors))}
    return {**rc.scan_fields(results), **probe}, digests


def reference_drive_inputs():
    """eval_ate.py's draws from the JAX package's worldsim: (edge map
    cloud, surface map cloud, scans, ground truth, twists)."""
    from lidar_feature_extraction_tpu.utils import worldsim

    rng = np.random.default_rng(0)
    world = worldsim.make_world(rng, n_poles=50, extent=35.0)
    edges, surfs = worldsim.world_maps(world, rng, n_ground=30000)
    scans, gt = worldsim.make_scan_sequence(
        world, rng, n_scans=rc.DRIVE_SCANS, n_rings=64, n_az=2048,
        elev_deg=(2.0, -24.8))
    return edges, surfs, scans, gt, worldsim.synth_twists(len(scans),
                                                          rng=rng)


def cut_scene(scene: str):
    """(maps, image, prior, config) of the JAX package's cut-width scene
    ``scene`` of ``rc.CUT_SCENES``: kitti_hdl64 at 8 x 256 with 512 edge
    and 2,048 surface slots on bench.py's scan and its map of 7 noisy
    keyframe copies (``tests/test_torch_localization.py``'s ``scene``),
    or at 16 x 576 on the street scene mapped from 7 keyframes
    (its ``test_localize_scan_street_scene_recovers_the_pose``); the
    prior t = (0.3, -0.2, 0.05)."""
    from lidar_feature_extraction_tpu_torch.utils.synthetic import (
        bench_scan, keyframe_copies, street_scan, street_world, to_world)

    base = jconfig.kitti_hdl64()
    r, p = (8, 256) if scene == "bench" else (16, 576)
    ex = dataclasses.replace(base.extraction, n_rings=r, max_points_per_ring=p)
    if scene == "bench":
        ex = dataclasses.replace(ex, max_edges=512, max_surfaces=2048)
    cfg = dataclasses.replace(base, extraction=ex)
    if scene == "bench":
        rng = np.random.default_rng(0)
        xyz = bench_scan(rng, r, p)
        f = jex.extract_features(ref_image(xyz), ex)
        edge, surf = (keyframe_copies(rng, np.float32(a)[np.asarray(v)])
                      for a, v in ((f.edge_xyz, f.edge_valid),
                                   (f.surface_xyz, f.surface_valid)))
    else:
        rng = np.random.default_rng(1)
        world = street_world(rng)
        edges, surfs = [], []
        for k in range(7):
            o = ((0.0, 0.0) if k == 0
                 else tuple(rng.uniform(-3, 3, 2) * [1, .3]))
            yaw = 0.0 if k == 0 else float(rng.uniform(-0.05, 0.05))
            scan = street_scan(world, rng, r, p, o, yaw)
            xyz = scan if k == 0 else xyz
            f = jex.extract_features(ref_image(scan), ex)
            edges.append(to_world(np.float32(f.edge_xyz)[
                np.asarray(f.edge_valid)], o, yaw))
            surfs.append(to_world(np.float32(f.surface_xyz)[
                np.asarray(f.surface_valid)], o, yaw))
        edge, surf = np.concatenate(edges), np.concatenate(surfs)
    maps = jloc.build_geometry_maps(
        jnp.asarray(np.float32(edge)), jnp.ones(len(edge), bool),
        jnp.asarray(np.float32(surf)), jnp.ones(len(surf), bool), cfg)
    prior = JPose(jnp.asarray(np.float32([1, 0, 0, 0])),
                  jnp.asarray(np.float32(rc.BEST_T)))
    return maps, ref_image(xyz), prior, cfg


def cut_update_record() -> tuple[dict, dict]:
    """The first Gauss-Newton update of the jitted ``localize_scan`` at
    each of ``rc.CUT_SCENES`` (problems under 4,096 rows, ROADMAP §C22):
    its rows, valid mask and Huber weights, and D, A and b as the
    program computes them, read with ``jax.debug.callback`` on an
    instrumented ``weighted_update``; the traced program must give the
    plain one's result bit for bit, and the port's plain normal
    equations the recorded bits, or this raises. Returns the arrays
    (``cut.<scene>.<name>``) and the manifest entry (rows, block
    shape)."""
    from lidar_feature_extraction_tpu.ops import gauss_newton as jgn
    from lidar_feature_extraction_tpu.ops import smallalg as jsmallalg

    arrays, manifest, differ = {}, {}, []
    update = jgn.weighted_update
    for scene in rc.CUT_SCENES:
        maps, image, prior, cfg = cut_scene(scene)
        run = lambda: jax.jit(lambda m, im, p: jloc.localize_scan(  # noqa: E731
            m, im, p, cfg))(maps, image, prior)[0]
        want = run()
        seen = []

        def update_cb(q, weights, problem, degeneracy_threshold):
            # The reference's weighted_update, with its inputs and D, A
            # and b read out.
            w = jnp.where(problem.valid, weights, 0.0)
            vf = problem.valid.astype(problem.jac_rows.dtype)
            w_rows = jgn.rows_from_corr(problem, w)[:, None]
            v_rows = jgn.rows_from_corr(problem, vf)[:, None]
            j = problem.jac_rows
            D = (j * v_rows).T @ j
            A = (j * w_rows).T @ j
            b = j.T @ (w_rows[:, 0] * problem.res_rows)
            M = jgn.make_m(q)
            H = M.T @ A @ M
            dx = -jsmallalg.cholesky_solve(H, M.T @ b)
            degenerate = jsmallalg.min_eigval_below(D, degeneracy_threshold)
            bad = degenerate | ~jnp.all(jnp.isfinite(dx))
            jax.debug.callback(lambda *v: seen.append(
                [np.asarray(a) for a in v]), j, problem.res_rows,
                problem.valid, weights, D, A, b)
            shapes.append(problem.shape)
            return jnp.where(bad, jnp.zeros_like(dx), dx), H

        shapes = []
        jgn.weighted_update = update_cb
        try:
            jax.clear_caches()
            got = run()
            jax.effects_barrier()
        finally:
            jgn.weighted_update = update
            jax.clear_caches()
        if not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in (
                (got.status, want.status), (got.iterations, want.iterations),
                (got.pose.q, want.pose.q), (got.pose.t, want.pose.t),
                (got.error, want.error), (got.scale, want.scale))):
            raise RuntimeError(f"cut {scene}: the traced program with "
                               "callbacks does not give its result")
        names = ("jac_rows", "res_rows", "valid", "weights", "D", "A", "b")
        for name, a in zip(names, seen[0]):
            arrays[f"cut.{scene}.{name}"] = a
        manifest[scene] = {"rows": int(seen[0][0].shape[0]),
                           "shape": [list(map(int, s)) for s in shapes[0]]}
        port = rc.cut_normal_equations(
            *(arrays[f"cut.{scene}.{k}"] for k in names[:4]),
            tuple(map(tuple, manifest[scene]["shape"])))
        for key, g in zip("DAb", port):
            if not np.array_equal(g.numpy().view(np.int32),
                                  arrays[f"cut.{scene}.{key}"].view(
                                      np.int32)):
                differ.append(f"{scene}.{key}")
    if differ:
        raise RuntimeError("the port's normal equations are not the cut "
                           f"programs': {differ}")
    return arrays, manifest


def normal_equations_record() -> tuple[dict, dict]:
    """What XLA:CPU computes for the Gauss-Newton normal equations on this
    machine (ROADMAP §C21, §C22): D = (j v)^T j, A = (j w)^T j and
    b = j^T (w r) of ``rc.ne_inputs(m)`` for each of ``rc.NE_ROWS`` and
    ``rc.NE_SMALL_ROWS`` (the reference's expressions, jitted; the port
    gets ``rc.ne_problem(m)``, the same products rounded to float32), the
    full ``a.T @ b`` of each probe pair at ``rc.NE_ROWS``, and the
    reference's jitted Huber weights of ``rc.huber_inputs()``.
    The port's plain versions must give the same bits, or this raises:
    then the contraction tree of the running machine (its thread count, its
    caches) is not the one ``core/_xla_dot.py`` encodes. Returns the
    arrays and the manifest entry naming the tree's parameters."""
    from lidar_feature_extraction_tpu.core import stats as jstats
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
    from lidar_feature_extraction_tpu_torch.core import stats as tstats

    # The reference's expressions (gauss_newton.py:158-160), w * r inside.
    ne = jax.jit(lambda j, v, w, r: ((j * v[:, None]).T @ j,
                                     (j * w[:, None]).T @ j, j.T @ (w * r)))
    probe = jax.jit(lambda a, b: a.T @ b)
    arrays, differ = {}, []
    for m in (*rc.NE_ROWS, *rc.NE_SMALL_ROWS):
        want = [np.asarray(x) for x in ne(*map(jnp.asarray,
                                               rc.ne_inputs(m)))]
        got = xd.normal_equations_plain(*map(torch.as_tensor,
                                             rc.ne_problem(m)))
        for key, w, g in zip("DAb", want, got):
            arrays[f"normal_equations.{m}.{key}"] = w
            if not np.array_equal(g.numpy().view(np.int32),
                                  w.view(np.int32)):
                differ.append(f"{m}.{key}")
        if m not in rc.NE_ROWS:
            continue
        sums = np.stack([np.asarray(probe(*map(jnp.asarray,
                                               rc.probe_operands(m, p, q))))
                         for p, q in rc.ne_probe_pairs(m)])
        port = np.stack([xd.normal_equations_plain(*map(
            torch.as_tensor, (a, a, b, b[:, 0])))[0].numpy()
            for a, b in (rc.probe_operands(m, p, q)
                         for p, q in rc.ne_probe_pairs(m))])
        arrays[f"normal_equations.{m}.probe"] = sums
        if not np.array_equal(port.view(np.int32), sums.view(np.int32)):
            differ.append(f"{m}.probe")
    e = rc.huber_inputs()
    arrays["huber.weights"] = np.asarray(jax.jit(jstats.huber_derivative)(
        jnp.asarray(e)))
    if not np.array_equal(tstats.huber_derivative(torch.as_tensor(e)).numpy(
    ).view(np.int32), arrays["huber.weights"].view(np.int32)):
        differ.append("huber")
    if differ:
        raise RuntimeError("the port's XLA:CPU forms are not the running "
                           "machine's: "
                           f"{differ}")
    tree = {"threads": xd.XLA_CPU_THREADS, "single_kc": xd.SINGLE_KC,
            "threaded_kc": xd.THREADED_KC, "dnnl_k_block": xd.DNNL_K_BLOCK,
            "shard_above": xd.SHARD_ABOVE, "eight_above": xd.EIGHT_ABOVE,
            "group": xd.GROUP, "packet_entries": xd.PACKET_ENTRIES,
            "rows": list(rc.NE_ROWS), "small_rows": list(rc.NE_SMALL_ROWS),
            "gemv_tiled_from": xd.GEMV_TILED_FROM,
            "gemv_serial_max": xd.GEMV_SERIAL_MAX,
            "gemv_interleave2_max": xd.GEMV_INTERLEAVE2_MAX,
            "gemv_full_unroll": xd.GEMV_FULL_UNROLL}
    return arrays, tree


def build_drive_record() -> tuple[dict, dict]:
    """(arrays by ``<drive>.<name>``, manifest) of both drives, and the
    normal equations' and Huber weights' record."""
    from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse

    inputs = reference_drive_inputs()
    arrays, tree = normal_equations_record()
    cut_arrays, cut_updates = cut_update_record()
    arrays.update(cut_arrays)
    drives = {}
    for name in rc.DRIVES:
        fields, digests = reference_drive(name, inputs)
        for k, a in fields.items():
            arrays[f"{name}.{k}"] = a
        drives[name] = {
            "probe_scan": rc.DRIVE_PROBE[name], **digests,
            "ate_rmse_m": ate_rmse(np.float64(fields["measured_t"]),
                                   inputs[3], align=False),
            "status": fields["status"].tolist(),
            "iterations": fields["iterations"].tolist()}
    manifest = {
        "written_by": "JAX_PLATFORMS=cpu python tests/"
                      "torch_reference_record.py --drive --write",
        "versions": {"jax": jax.__version__, "numpy": np.__version__,
                     "torch": torch.__version__,
                     "python": sys.version.split()[0]},
        "jax_enable_x64": True, "cpu_count": os.cpu_count(),
        "xla_cpu_contraction": tree, "cut_updates": cut_updates,
        "inputs_sha256": rc.drive_inputs_sha256(*inputs),
        "inputs": "eval_ate.py's drive from the JAX package's worldsim: "
                  "numpy seed 0, 50 poles over 35 m, 30000 ground points, "
                  "20 scans of 64 x 2048, twists",
        "drives": drives}
    return arrays, manifest


def reference_odometry_chain() -> tuple[dict, dict]:
    """bench_odometry.py's extracted-feature chain: its frames (numpy
    seed 0, 50 poles over 60 m, 100 ray-cast 64 x 2048 sweeps along
    ``straight_drive`` through the jitted extraction) and its jitted
    ``lax.scan`` of ``geometry_odometry_step`` with the
    constant-velocity prior carried in the program. A copy of the chain
    that also returns each frame's prior, status and rotation must give
    the chain's positions and iterations bit for bit, or this raises."""
    import bench_odometry
    from lidar_feature_extraction_tpu.pipeline import odometry as jodo

    cfg = jconfig.kitti_hdl64()
    frames_np, gt = bench_odometry.make_frames_extracted(
        cfg, np.random.default_rng(0), rc.ODOM_FRAMES)
    frames = tuple(jnp.asarray(a) for a in frames_np)

    def chain(frames, wobble, extra: bool):
        # bench_odometry.py's bench_mode chain; ``extra`` adds outputs.
        e, ev, s, sv = frames
        state0 = jodo.init_geometry_odometry(cfg)

        def body(carry, frame):
            state, prev_q, prev_t = carry
            fe, fev, fs, fsv = frame
            cur = JPose(state.pose_q, state.pose_t)
            prev = JPose(prev_q, prev_t)
            prior = cur.compose(prev.inverse().compose(cur))
            state2, result = jodo.geometry_odometry_step(
                state, fe + wobble[None, :], fev, fs + wobble[None, :],
                fsv, cfg, prior_q=prior.q, prior_t=prior.t)
            out = (result.pose.t, result.iterations)
            if extra:
                out += (result.pose.q, result.status, prior.q, prior.t)
            return (state2, cur.q, cur.t), out

        carry0 = (state0, state0.pose_q, state0.pose_t)
        return jax.lax.scan(body, carry0, (e, ev, s, sv))[1]

    wobble = jnp.zeros(3, jnp.float32)
    ts, iters = jax.jit(lambda f, w: chain(f, w, False))(frames, wobble)
    got = jax.jit(lambda f, w: chain(f, w, True))(frames, wobble)
    if np.asarray(ts).tobytes() != np.asarray(got[0]).tobytes() \
            or np.asarray(iters).tobytes() != np.asarray(got[1]).tobytes():
        raise RuntimeError("the chain with extra outputs departs from "
                           "bench_odometry.py's chain")
    ts_np, q, status, pq, pt = (np.asarray(a) for a in (
        got[0], got[2], got[3], got[4], got[5]))
    arrays = {"odometry.status": np.int32(status),
              "odometry.iterations": np.int32(np.asarray(iters)),
              "odometry.pose_q": np.float32(q),
              "odometry.pose_t": np.float32(ts_np),
              "odometry.prior_q": np.float32(pq),
              "odometry.prior_t": np.float32(pt),
              "odometry.gt_t": np.float32(gt)}
    return arrays, {"frames_sha256": rc.frames_sha256(frames_np),
                    **rc.odometry_metrics(ts_np, gt)}


def reference_slam_loop() -> tuple[dict, dict]:
    """eval_ate.py's ``eval_slam_loop`` without IMU: the JAX package's
    ``run_mapping_drive`` over 80 scans of a 10 m circle, drawing from
    the generator eval_ate.py's drive left (``reference_drive_inputs``),
    with a recording ``MappingPipeline``: each scan's odometry pose and
    features, the keyframes, the constraints and the graph after each
    ``optimize()``."""
    from lidar_feature_extraction_tpu.pipeline import slam as jslam
    from lidar_feature_extraction_tpu.utils import worldsim
    from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse

    rng = np.random.default_rng(0)
    world = worldsim.make_world(rng, n_poles=50, extent=35.0)
    worldsim.world_maps(world, rng, n_ground=30000)
    worldsim.make_scan_sequence(world, rng, n_scans=rc.DRIVE_SCANS,
                                n_rings=64, n_az=2048,
                                elev_deg=(2.0, -24.8))
    worldsim.synth_twists(rc.DRIVE_SCANS, rng=rng)
    rng_state = rng.bit_generator.state
    rec = rc.MappingRecorder()
    plain = jslam.MappingPipeline
    jslam.MappingPipeline = rec.recording(plain)
    try:
        pipeline, gt = worldsim.run_mapping_drive(
            world, jconfig.kitti_hdl64(), rng, **rc.SLAM_DRIVE)
    finally:
        jslam.MappingPipeline = plain
    arrays = {f"slam.{k}": a for k, a in rec.fields(pipeline).items()}
    arrays["slam.gt"] = np.float32(gt)
    return arrays, {"rng_state": rng_state,
                    **rec.summary(pipeline, ate_rmse(
                        np.float64(pipeline.trajectory), gt, align=False))}


def build_mapping_record() -> tuple[dict, dict]:
    """(arrays by ``odometry.<name>`` / ``slam.<name>``, manifest)."""
    import scipy

    arrays, odometry = reference_odometry_chain()
    slam_arrays, slam = reference_slam_loop()
    arrays.update(slam_arrays)
    lapack = scipy.__config__.CONFIG["Build Dependencies"]["lapack"]
    manifest = {
        "written_by": "JAX_PLATFORMS=cpu python tests/"
                      "torch_reference_record.py --mapping --write",
        "versions": {"jax": jax.__version__, "numpy": np.__version__,
                     "scipy": scipy.__version__,
                     lapack["name"]: lapack["version"],
                     "torch": torch.__version__,
                     "python": sys.version.split()[0]},
        "jax_enable_x64": True, "cpu_count": os.cpu_count(),
        "odometry": {"inputs": "bench_odometry.py's make_frames_extracted: "
                               "numpy seed 0, 50 poles over 60 m, 100 "
                               "frames of 64 x 2048",
                     **odometry},
        "slam": {"inputs": "eval_ate.py's slam_loop: the generator after "
                           "the drive's draws, 80 scans of a 10 m "
                           "circle, no IMU",
                 **slam}}
    return arrays, manifest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="write the record (else compare with it)")
    ap.add_argument("--drive", action="store_true",
                    help="the drive record (else the full-width one)")
    ap.add_argument("--mapping", action="store_true",
                    help="the mapping record (else the full-width one)")
    args = ap.parse_args()
    if args.mapping:
        arrays, manifest = build_mapping_record()
        paths = (rc.MAPPING_RECORD, rc.MAPPING_MANIFEST)
    elif args.drive:
        arrays, manifest = build_drive_record()
        paths = (rc.DRIVE_RECORD, rc.DRIVE_MANIFEST)
    else:
        arrays, manifest = build_record()
        paths = (rc.RECORD, rc.MANIFEST)
    if args.write:
        write(arrays, manifest, *paths)
        print(f"wrote {paths[0]} ({os.path.getsize(paths[0])} B) and "
              f"{paths[1]}")
        return 0
    diff = differences(arrays, manifest, *rc.load(*paths))
    print("record equals a fresh computation" if not diff
          else f"record differs: {diff}")
    return 1 if diff else 0


if __name__ == "__main__":
    sys.exit(main())
