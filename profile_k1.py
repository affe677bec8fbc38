"""Time kernel K1 on a CUDA card at ``kitti_hdl64()`` widths (64 x 2304).

    python3 profile_k1.py                          # this tree's K1
    python3 profile_k1.py --baseline DIR           # and DIR's K1, in turns
    python3 profile_k1.py --phases                 # and the per-phase split

``DIR`` is a checkout of another commit (for example ``git archive`` of
the parent unpacked under ``build/``); its wrapper
``lidar_feature_extraction_tpu_torch/ops/extraction_cuda.py`` is loaded
by path and builds its own kernel source into ``DIR/build/kernels``, and
its K1 is checked against its own plain version (its
``ops/extraction.py``, also loaded by path).

For each implementation (the baseline and this tree) and each scan
(chip_smoke's bench scan and its street scan), in turns (baseline, this
tree, this tree, baseline) for ``--repeats`` rounds, ``k1_check.py``'s
``check_and_time``: labels, curvature and columns bit-equal to the plain
PyTorch version, then ``device_us`` (the kernel's device time per
launch, from ``torch.profiler`` over ``--launches`` launches after
warm-up) and ``host_us`` (the wrapper's host time per call).

With ``--phases`` each implementation is also built with
``-DK1_PHASE_TIMING`` (a build the port never uses), whose kernel stamps
``%globaltimer`` and ``clock64()`` at each phase boundary of every block
into a debug buffer; the split is the median over ``--phase-launches``
launches of the mean over blocks.

Prints one JSON line per measurement and writes everything to ``--out``.
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
STAMP_BLOCKS, STAMPS, STAMP_ROUNDS = 256, 16, 32
P_RINGS = 64  # rings of kitti_hdl64(), the shape profiled here


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_impl(root: Path, tag: str):
    """(the K1 wrapper module, the plain version) of the checkout at
    ``root``, loaded by path."""
    ops = root / "lidar_feature_extraction_tpu_torch" / "ops"
    return (_load(ops / "extraction_cuda.py", f"k1_impl_{tag}"),
            _load(ops / "extraction.py",
                  f"k1_plain_{tag}").label_and_columns_plain)


def phase_split(mod, args, launches: int):
    """Per-phase device time of ``mod``'s kernel built with
    -DK1_PHASE_TIMING; None if its source has no stamps."""
    import torch

    plain_flags = tuple(mod.NVCC_FLAGS)
    mod.NVCC_FLAGS = plain_flags + ("-DK1_PHASE_TIMING",)
    mod.load.cache_clear()
    lib = ctypes.CDLL(str(mod.build()))
    if not hasattr(lib, "k1_phase_read"):
        mod.NVCC_FLAGS = plain_flags
        mod.load.cache_clear()
        return None
    lib.k1_phase_names.restype = ctypes.c_char_p
    names = lib.k1_phase_names().decode().split(",")
    ns = np.zeros((STAMP_BLOCKS, STAMPS), np.uint64)
    clk = np.zeros((STAMP_BLOCKS, STAMPS), np.int64)
    rounds = np.zeros((STAMP_BLOCKS, 2), np.int32)
    round_clk = np.zeros((STAMP_BLOCKS, STAMP_ROUNDS, 2), np.int64)
    round_ns = np.zeros((STAMP_BLOCKS, STAMP_ROUNDS, 2), np.uint64)
    has_rounds = hasattr(lib, "k1_round_read")
    per_launch_ns, per_launch_clk, spans, rounds_seen = [], [], [], None
    work, barrier, latency, skew = [], [], [], []
    blocks = None
    for i in range(launches + 3):
        mod.label_and_columns_cuda(*args)
        torch.cuda.synchronize()
        err = lib.k1_phase_read(ns.ctypes.data, clk.ctypes.data,
                                rounds.ctypes.data)
        if err:
            raise RuntimeError(f"k1_phase_read: CUDA error {err}")
        if has_rounds and lib.k1_round_read(round_clk.ctypes.data,
                                            round_ns.ctypes.data):
            raise RuntimeError("k1_round_read failed")
        if i < 3:
            continue
        if blocks is None:
            blocks = int(np.count_nonzero(ns[:, 0]))
        k = len(names) + 1
        t = ns[:blocks, :k].astype(np.int64)
        c = clk[:blocks, :k]
        per_launch_ns.append(np.diff(t, axis=1).mean(axis=0))
        per_launch_clk.append(np.diff(c, axis=1).mean(axis=0))
        spans.append(float(t[:, -1].max() - t[:, 0].min()))
        rounds_seen = rounds[:blocks].copy()
        if has_rounds:
            # Round work: from the end of one round's barrier to the end of
            # the next round's work, within a pass; barrier: the rest.
            for b in range(blocks):
                g_edge, g_surf = rounds[b]
                for g in range(min(g_edge + g_surf, STAMP_ROUNDS)):
                    barrier.append(round_clk[b, g, 1] - round_clk[b, g, 0])
                    if g not in (0, g_edge):
                        work.append(round_clk[b, g, 0]
                                    - round_clk[b, g - 1, 1])
            # Two CTAs per ring (blocks 2r, 2r + 1), on the global clock:
            # the barrier's own latency, from the later CTA's arrival to
            # the earlier exit, and the gap between the two arrivals.
            if blocks == 2 * P_RINGS:
                t = round_ns[:blocks].astype(np.int64)
                for r in range(blocks // 2):
                    a, b = 2 * r, 2 * r + 1
                    n_r = min(int(rounds[a].sum()), STAMP_ROUNDS)
                    for g in range(n_r):
                        latency.append(min(t[a, g, 1], t[b, g, 1])
                                       - max(t[a, g, 0], t[b, g, 0]))
                        skew.append(abs(t[a, g, 0] - t[b, g, 0]))
    mod.NVCC_FLAGS = plain_flags
    mod.load.cache_clear()
    med_ns = np.median(np.stack(per_launch_ns), axis=0)
    med_clk = np.median(np.stack(per_launch_clk), axis=0)
    return {
        "blocks": blocks,
        "phases": [{"phase": n, "us_mean_over_blocks": float(a) / 1e3,
                    "cycles_mean_over_blocks": float(b)}
                   for n, a, b in zip(names, med_ns, med_clk)],
        "span_us_median": statistics.median(spans) / 1e3,
        "rounds_edge_mean": float(rounds_seen[:, 0].mean()),
        "rounds_edge_max": int(rounds_seen[:, 0].max()),
        "rounds_surface_mean": float(rounds_seen[:, 1].mean()),
        "rounds_surface_max": int(rounds_seen[:, 1].max()),
        "round_work_cycles_mean": float(np.mean(work)) if work else None,
        "round_barrier_cycles_mean": (float(np.mean(barrier)) if barrier
                                      else None),
        "round_barrier_latency_ns_mean": (float(np.mean(latency))
                                          if latency else None),
        "round_arrival_gap_ns_mean": float(np.mean(skew)) if skew else None,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--phase-launches", type=int, default=50)
    ap.add_argument("--out", type=Path,
                    default=HERE / "chiprun_out" / "k1_profile.json")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_k1: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from k1_check import check_and_time, k1_inputs
    from lidar_feature_extraction_tpu_torch.config import kitti_hdl64

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)

    cfg = kitti_hdl64()
    ex = cfg.extraction
    impls, plains = {}, {}
    if opts.baseline is not None:
        impls["baseline"], plains["baseline"] = load_impl(
            opts.baseline.resolve(), "baseline")
    impls["this"], plains["this"] = load_impl(HERE, "this")
    order = list(impls) + list(impls)[::-1] if len(impls) > 1 else ["this"]
    inputs = k1_inputs(cfg, "cuda")

    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "shape": [ex.n_rings, ex.max_points_per_ring],
              "device": torch.cuda.get_device_name(0), "builds": {},
              "runs": [], "phases": {}}
    for tag, mod in impls.items():
        so = mod.build()
        log = so.with_suffix(".log")
        report["builds"][tag] = log.read_text() if log.exists() else ""

    for rep in range(opts.repeats):
        for tag in order:
            for scene, args in inputs.items():
                row = {"repeat": rep, "impl": tag, "scene": scene,
                       **check_and_time(impls[tag].label_and_columns_cuda,
                                        args, opts.launches, plains[tag])}
                report["runs"].append(row)
                print(json.dumps(row), flush=True)

    summary = {}
    for tag in impls:
        for scene in inputs:
            rows = [r for r in report["runs"]
                    if r["impl"] == tag and r["scene"] == scene]
            for key in ("device_us", "host_us"):
                v = [r[key] for r in rows]
                summary[f"{tag}/{scene}/{key}"] = {
                    "mean": statistics.fmean(v), "min": min(v),
                    "max": max(v), "n": len(v)}
    report["summary"] = summary
    print(json.dumps({"summary": summary}), flush=True)

    if opts.phases:
        for tag, mod in impls.items():
            for scene, args in inputs.items():
                split = phase_split(mod, args, opts.phase_launches)
                report["phases"][f"{tag}/{scene}"] = split
                print(json.dumps({"phases": f"{tag}/{scene}",
                                  "split": split}), flush=True)

    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(report, indent=1))
    print(f"wrote {os.path.relpath(opts.out, HERE)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
