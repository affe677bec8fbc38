"""Time eval_ate.py's closed-loop drive on a CUDA card: the port's
``FusedLocalizationPipeline`` over the drive's 20 scans under
``kitti_hdl64()`` (production) and its faithful variant.

    python3 profile_drive.py --write-inputs build/drive_inputs.pkl
    python3 profile_drive.py --inputs build/drive_inputs.pkl              # this tree's port
    python3 profile_drive.py --inputs build/drive_inputs.pkl --root DIR   # DIR's port

``--write-inputs`` makes the drive's inputs with this tree's
``reference_cases.drive_inputs`` (the JAX package's worldsim draws) and
stores them, so that two commits time the same scans. ``DIR`` is a
checkout of another commit (``git archive`` of the parent unpacked under
``build/``); its package is imported in place of this tree's. Compare
two commits only within one machine, in turns (parent, change, change,
parent), one process each.

The replay is this tree's ``reference_cases.port_drive`` in every case.
Per drive: ms per scan (its host clock, ending in
``torch.cuda.synchronize()``) of ``--repeats`` replays after an untimed
one (mean and median of each replay, and their medians), the ATE of the
last replay, then, under ``torch.profiler`` (after the timed loops: a
profiler session leaves the host's launches slower for the rest of the
process), one ``localize_scan`` of the last scan from the previous
scan's fused pose: kernel launches in all and per Gauss-Newton iteration
and the device busy time. Prints the card's name and power limit, then
one JSON line per drive. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def write_inputs(path: str) -> None:
    sys.path.insert(0, HERE)
    import reference_cases as rc

    edges, surfs, scans, gt, twists, _, _ = rc.drive_inputs()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump((edges, surfs, scans, gt, twists), f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose port is timed (default: this one)")
    ap.add_argument("--inputs", help="the stored drive inputs")
    ap.add_argument("--write-inputs", metavar="PATH",
                    help="store the drive's inputs and stop")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if args.write_inputs:
        write_inputs(args.write_inputs)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("profile_drive: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import reference_cases as rc
    from profile_fits import profiled
    sys.path.insert(0, root)

    import lidar_feature_extraction_tpu_torch as port
    from lidar_feature_extraction_tpu_torch.config import kitti_hdl64
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        build_feature_maps, build_geometry_maps, localize_scan)
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.utils.evaluation import ate_rmse

    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) \
            != root:
        print(f"profile_drive: imported {port.__file__}, not from {root}",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    with open(args.inputs, "rb") as f:
        edges, surfs, scans, gt, twists = pickle.load(f)
    clouds = (torch.as_tensor(edges, dtype=torch.float32, device=dev),
              torch.ones(len(edges), dtype=torch.bool, device=dev),
              torch.as_tensor(surfs, dtype=torch.float32, device=dev),
              torch.ones(len(surfs), dtype=torch.bool, device=dev))
    for name in rc.DRIVES:
        cfg = rc.drive_config(name, kitti_hdl64())
        build = (build_geometry_maps if name == "production"
                 else build_feature_maps)
        maps = build(*clouds, cfg)
        rc.port_drive(maps, cfg, scans, twists, dev)      # untimed
        runs = []
        for _ in range(args.repeats):
            ms = []
            runs.append((ms, rc.port_drive(maps, cfg, scans, twists, dev,
                                           ms=ms)))
        means = [statistics.fmean(ms) for ms, _ in runs]
        medians = [statistics.median(ms) for ms, _ in runs]
        last = runs[-1][1]
        image = scan_range_image(*scans[-1], cfg, dev)
        prior = Pose(*(torch.as_tensor(last[k][-2], device=dev)
                       for k in ("fused_q", "fused_t")))
        out = []
        prof = profiled(lambda: out.append(localize_scan(maps, image, prior,
                                                         cfg)))
        its = int(out[0][0].iterations)
        print(json.dumps({
            "drive": name, "root": root, "scans": len(scans),
            "repeats": args.repeats, "ms_per_scan_mean": means,
            "ms_per_scan_median": medians,
            "ms_per_scan_mean_median": statistics.median(means),
            "ms_per_scan_median_median": statistics.median(medians),
            "ate_rmse_m": ate_rmse(last["measured_t"], gt, align=False),
            "gn_iterations": last["iterations"].tolist(),
            "profiled_gn_iterations": its, **prof,
            "launches_per_gn_iteration": prof["launches"] / max(its, 1),
            "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
