"""Time the port's dense pose-graph optimizer on a CUDA card at
slam_loop's graphs.

    python3 profile_pose_graph.py               # this tree's port
    python3 profile_pose_graph.py --root DIR    # DIR's port

The graphs come from the mapping record (``tests/data/
torch_reference_mapping.npz``) through this tree's
``reference_cases.slam_graph``: for each optimize() bucket of eval_ate.py's
slam_loop (8, 16, 24 and 40 active keyframes, shape buckets (K, M) =
(8, 8), (16, 16), (32, 32), (64, 64)), the keyframes' odometry poses and
every recorded constraint between them with its weight and information,
padded as ``MappingPipeline.optimize`` pads them. One call is what
``optimize()`` runs: the graduated schedule of ``optimize_pose_graph``
(delta 8.0, 2.0, 0.5 for 3, 3, 4 Gauss-Newton iterations).

``DIR`` is a checkout of another commit (``git archive`` of the parent
unpacked under ``build/``); its package is imported in place of this
tree's. Compare two commits only within one machine, in turns (parent,
change, change, parent), one process each.

Per bucket: ms per call (host clock ending in
``torch.cuda.synchronize()``; median and mean of ``--repeats`` calls after
an untimed one), then, under ``torch.profiler`` after the timed calls,
one call's kernel launches in all and per Gauss-Newton iteration and the
device busy time. Prints the card's name and power limit, then one JSON
line per bucket. Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GN_ITERATIONS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose port is timed (default: this one)")
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_pose_graph: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import reference_cases as rc
    from profile_fits import profiled
    sys.path.insert(0, root)

    import lidar_feature_extraction_tpu_torch as port
    from lidar_feature_extraction_tpu_torch.parallel import pose_graph as pg
    from lidar_feature_extraction_tpu_torch.pipeline.slam import (
        MappingPipeline)

    assert os.path.dirname(os.path.dirname(port.__file__)) == root, \
        port.__file__
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    arrays, _ = rc.load_mapping()
    dev = "cuda"
    for ka in rc.SLAM_GRAPH_KEYFRAMES:
        (q, t), cons = rc.slam_graph(arrays, ka)
        graph = pg.PoseGraph(torch.as_tensor(q, device=dev),
                             torch.as_tensor(t, device=dev))
        constraints = pg.Constraints(*(torch.as_tensor(a, device=dev)
                                       for a in cons))

        def optimize():
            g = graph
            for delta, n in MappingPipeline._gnc_schedule(0.5,
                                                          GN_ITERATIONS):
                g = pg.optimize_pose_graph(g, constraints, n_iterations=n,
                                           robust_delta=delta)
            return g

        out = optimize()
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.repeats):
            start = time.perf_counter()
            optimize()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - start))
        prof = profiled(optimize)
        print(json.dumps({
            "root": root, "keyframes": ka, "K": len(q), "M": len(cons[0]),
            "optimize_ms_median": statistics.median(ms),
            "optimize_ms_mean": statistics.fmean(ms),
            "launches": prof["launches"],
            "launches_per_gn_iteration": prof["launches"] / GN_ITERATIONS,
            "device_busy_ms": prof["device_busy_ms"],
            "finite": bool(torch.isfinite(out.poses_t).all()),
            "poses_t_sum": float(out.poses_t.double().sum())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
