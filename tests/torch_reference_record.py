"""Write, or check, the full-width reference record of the port's main
path (``tests/data/torch_reference_fullwidth.npz`` and its JSON
manifest): what the JAX package computes on the CPU for every case of
``reference_cases.py``.

    JAX_PLATFORMS=cpu python tests/torch_reference_record.py --write
    JAX_PLATFORMS=cpu python tests/torch_reference_record.py   # compare
    JAX_PLATFORMS=cpu python tests/torch_reference_record.py --drive --write

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


def normal_equations_record() -> tuple[dict, dict]:
    """What XLA:CPU computes for the Gauss-Newton normal equations on this
    machine (ROADMAP §C21): D = jv^T j, A = jw^T j and b = j^T wr of
    ``rc.ne_problem(m)`` for each of ``rc.NE_ROWS`` and the full
    ``a.T @ b`` of each probe pair (the reference's expressions, jitted),
    and the reference's jitted Huber weights of ``rc.huber_inputs()``.
    The port's plain versions must give the same bits, or this raises:
    then the contraction tree of the running machine (its thread count, its
    caches) is not the one ``core/_xla_dot.py`` encodes. Returns the
    arrays and the manifest entry naming the tree's parameters."""
    from lidar_feature_extraction_tpu.core import stats as jstats
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
    from lidar_feature_extraction_tpu_torch.core import stats as tstats

    ne = jax.jit(lambda jv, jw, j, wr: (jv.T @ j, jw.T @ j, j.T @ wr))
    probe = jax.jit(lambda a, b: a.T @ b)
    arrays, differ = {}, []
    for m in rc.NE_ROWS:
        args = rc.ne_problem(m)
        want = [np.asarray(x) for x in ne(*map(jnp.asarray, args))]
        got = xd.normal_equations_plain(*map(torch.as_tensor, args))
        sums = np.stack([np.asarray(probe(*map(jnp.asarray,
                                               rc.probe_operands(m, p, q))))
                         for p, q in rc.ne_probe_pairs(m)])
        port = np.stack([xd.normal_equations_plain(*map(
            torch.as_tensor, (a, a, b, b[:, 0])))[0].numpy()
            for a, b in (rc.probe_operands(m, p, q)
                         for p, q in rc.ne_probe_pairs(m))])
        for key, w, g in (("D", want[0], got[0]), ("A", want[1], got[1]),
                          ("b", want[2], got[2]), ("probe", sums, port)):
            arrays[f"normal_equations.{m}.{key}"] = w
            if not np.array_equal(np.asarray(g).view(np.int32),
                                  w.view(np.int32)):
                differ.append(f"{m}.{key}")
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
            "rows": list(rc.NE_ROWS)}
    return arrays, tree


def build_drive_record() -> tuple[dict, dict]:
    """(arrays by ``<drive>.<name>``, manifest) of both drives, and the
    normal equations' and Huber weights' record."""
    from lidar_feature_extraction_tpu.utils.evaluation import ate_rmse

    inputs = reference_drive_inputs()
    arrays, tree = normal_equations_record()
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
        "xla_cpu_contraction": tree,
        "inputs_sha256": rc.drive_inputs_sha256(*inputs),
        "inputs": "eval_ate.py's drive from the JAX package's worldsim: "
                  "numpy seed 0, 50 poles over 35 m, 30000 ground points, "
                  "20 scans of 64 x 2048, twists",
        "drives": drives}
    return arrays, manifest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", action="store_true",
                    help="write the record (else compare with it)")
    ap.add_argument("--drive", action="store_true",
                    help="the drive record (else the full-width one)")
    args = ap.parse_args()
    if args.drive:
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
