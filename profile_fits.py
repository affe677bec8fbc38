"""Profile the faithful kNN registration of ``vlp16()`` on a CUDA card:
the fits of one search round and one Gauss-Newton iteration of the
port's ``HostLocalizer`` over ``FeatureMaps``, on the full-width
record's scenes (``reference_cases.py``).

    python3 profile_fits.py                    # this tree's port
    python3 profile_fits.py --root DIR         # DIR's port (another commit)

``DIR`` is a checkout of another commit (for example ``git archive`` of
the parent unpacked under ``build/``); its ``reference_cases.py`` and
package are imported in place of this tree's. Compare two commits only
within one machine, in turns (parent, change, change, parent), one
process each.

Per scene (``vlp16/bench``, ``vlp16/street``), from the record's prior 2:

- every prior through ``HostLocalizer.register`` and ``localize_scan``:
  status and iterations against the record's, and the largest pose
  difference (the registration fed the record's features);
- host-clock times (``torch.cuda.synchronize()`` at both ends, median of
  ``--repeats``) of one search round's fit (``_fit``: candidate gather,
  kNN, line and plane fits), one Gauss-Newton iteration on frozen fits
  (``_light_step``), one iteration that refits (``_step``, the
  ``refit_per_iteration`` configuration) and the whole ``register``;
- then, under ``torch.profiler`` (after every timed loop: a profiler
  session leaves the host's launches slower for the rest of the
  process), the kernel launches and device busy time of each.

Prints the card's name and power limit, then one JSON line per scene.
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SCENES = ("vlp16/bench", "vlp16/street")
PRIOR = 2


def profiled(fn) -> dict:
    """Kernel launches (the runtime's launch calls) and device busy time
    of one call of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in events)
    return {"launches": sum(e.count for e in events
                            if e.key in launch_calls),
            "device_busy_ms": busy / 1e3}


def timed_ms(fn, repeats: int) -> float:
    import torch

    fn()
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - start))
    return statistics.median(out)


def fit_calls(case: str, dev: str):
    """(the callables profiled, the ``HostLocalizer`` and what
    ``scene_profile`` holds against the record) of ``case`` on ``dev``:
    one search round's fit, one Gauss-Newton iteration on frozen fits, one
    that refits and the whole ``register`` from the record's prior 2."""
    import reference_cases as rc
    from lidar_feature_extraction_tpu_torch.pipeline import (
        launch, localization)

    cfg = launch.load_config("vlp16")
    rec = rc.case_arrays(rc.load()[0], case)
    maps = rc.port_maps(case, rec["labels"], cfg, dev)
    feats = rc.ref_features_tensors(rec, dev)
    poses = rc.port_poses(dev)
    host = localization.HostLocalizer(maps, cfg)
    refit_host = localization.HostLocalizer(maps, dataclasses.replace(
        cfg, registration=dataclasses.replace(cfg.registration,
                                              refit_per_iteration=True)))
    e, ev, s, sv = feats
    pose = poses[PRIOR]
    s_ds, s_ok = host._downsample(s, sv)
    eg, sg = host._fit(e, ev, s_ds, s_ok, pose)
    cand = refit_host._gather(e, s_ds, pose)
    calls = {
        "fit": lambda: host._fit(e, ev, s_ds, s_ok, pose),
        "light_step": lambda: host._light_step(eg, sg, e, s_ds, pose),
        "refit_step": lambda: refit_host._step(cand, e, ev, s_ds, s_ok,
                                               pose),
        "register": lambda: host.register(*feats, pose)}
    return calls, (cfg, rec, maps, feats, poses, host)


def scene_profile(case: str, repeats: int, dev: str = "cuda") -> dict:
    import reference_cases as rc
    from lidar_feature_extraction_tpu_torch.pipeline import localization

    calls, (cfg, rec, maps, feats, poses, host) = fit_calls(case, dev)
    runs = {"host": [host.register(*feats, p) for p in poses],
            "localize_scan": [localization.localize_scan(
                maps, rc.port_image(case, cfg, dev), p, cfg)[0]
                for p in poses]}
    held = {}
    for name, results in runs.items():
        got = rc.results_arrays(results)
        held[name] = {
            "status": got["status"].tolist(),
            "iterations": got["iterations"].tolist(),
            "same_status_iterations": bool(
                np.array_equal(got["status"], rec["localize_status"])
                and np.array_equal(got["iterations"],
                                   rec["localize_iterations"])),
            "t_diff_max_m": float(np.abs(
                got["t"].astype(np.float64) - rec["localize_t"]).max())}
    return {"case": case, "prior": PRIOR,
            "record": {"status": rec["localize_status"].tolist(),
                       "iterations": rec["localize_iterations"].tolist()},
            "held": held,
            "register_gn_iterations": int(runs["host"][PRIOR].iterations),
            "ms": {k: timed_ms(fn, repeats) for k, fn in calls.items()},
            "profile": {k: profiled(fn) for k, fn in calls.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).parent,
                    help="checkout whose port is profiled")
    ap.add_argument("--tag", default=None, help="label of the run")
    ap.add_argument("--repeats", type=int, default=9)
    opts = ap.parse_args()
    root = opts.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("profile_fits.py: no CUDA device", file=sys.stderr)
        return 1
    import lidar_feature_extraction_tpu_torch as port
    import reference_cases as rc
    for mod, up in ((port, 1), (rc, 0)):
        if Path(mod.__file__).resolve().parents[up] != root:
            print(f"profile_fits.py: imported {mod.__file__}, not from "
                  f"{root}", file=sys.stderr)
            return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(smi, flush=True)
    for case in SCENES:
        print(json.dumps({"tag": opts.tag or str(root),
                          "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": smi,
                          **scene_profile(case, opts.repeats)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
