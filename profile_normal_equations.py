"""Time the ``normal_equations`` kernel against a baseline tree's, on the
same operands, on one CUDA card.

    python3 profile_normal_equations.py                   # this tree alone
    python3 profile_normal_equations.py --baseline DIR    # and DIR's, in turns

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into ``build/``). Both trees
register the same PyTorch operator, so each runs in a process of its own:
first both build their library (in parallel), then the processes run in
turns (baseline, this tree, this tree, baseline) for ``--repeats``
rounds. Each times chip_smoke's cases (``ne_operands``: 2,047, 10,240
and 14,336 rows, and 14,336 x B = 32) with j row-major, as the main path
gives it, and column-major: the profiler's device time per launch
(``k1_check.device_us_per_launch``, 200 launches), and a digest of the
outputs' bits. At 4,096 rows and above the two trees must give the same
bits (below, the baseline may predate ROADMAP §C22). Writes
``chiprun_out/ne_profile.json`` and prints one JSON line per run and a
summary.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
CASES = ((2047, 1), (10240, 1), (14336, 1), (14336, 32))
LAYOUTS = ("contiguous", "strided")
LAUNCHES = 200
# The row count from which XLA:CPU tiles the gradient (_xla_dot's
# GEMV_TILED_FROM): a baseline from before ROADMAP §C22 agrees from there.
SAME_BITS_FROM = 4096


def _load(name: str, path: Path):
    """The module at ``path`` (this tree's), whatever ``sys.path`` holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: Path, build_only: bool) -> int:
    """Builds (and unless ``build_only`` times) ``root``'s kernel; prints
    one JSON line of device us and digests by case and layout."""
    import torch

    sys.path.insert(0, str(root))
    from lidar_feature_extraction_tpu_torch.ops import (
        normal_equations_cuda as ne)

    if build_only:
        ne.build()
        return 0
    if Path(ne.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {ne.__file__}, not {root}'s")
    ne.load()
    smoke = _load("_smoke", HERE / "chip_smoke.py")
    k1_check = _load("_k1_check", HERE / "k1_check.py")
    dev = torch.device("cuda")
    out = {}
    for m, batch in CASES:
        for layout in LAYOUTS:
            args = smoke.ne_operands(m, batch, dev, layout)
            got = ne.normal_equations_cuda(*args)
            torch.cuda.synchronize()
            digest = hashlib.sha256(b"".join(
                g.contiguous().cpu().numpy().tobytes() for g in got))
            us, seen = k1_check.device_us_per_launch(
                lambda: ne.normal_equations_cuda(*args),
                "normal_equations_kernel", LAUNCHES)
            out[f"{m}x{batch}.{layout}"] = {
                "device_us": us, "device_launches_seen": seen,
                "bits_sha256": digest.hexdigest()}
    print(json.dumps(out), flush=True)
    return 0


def run_worker(root: Path, build_only: bool = False) -> dict | None:
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(root), *(["--build-only"] if build_only else [])],
        capture_output=True, text=True, check=False, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"worker for {root} failed ({proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    return None if build_only else json.loads(
        proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--out", type=Path,
                    default=HERE / "chiprun_out" / "ne_profile.json")
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.worker is not None:
        return worker(opts.worker.resolve(), opts.build_only)

    import torch

    if not torch.cuda.is_available():
        print("profile_normal_equations: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)

    roots = {"this": HERE}
    if opts.baseline is not None:
        roots = {"baseline": opts.baseline.resolve(), "this": HERE}
    with ThreadPoolExecutor(len(roots)) as pool:
        list(pool.map(lambda r: run_worker(r, build_only=True),
                      roots.values()))
    order = list(roots) + list(roots)[::-1]
    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "roots": {k: str(v) for k, v in roots.items()}, "runs": []}
    for rep in range(opts.repeats):
        for tag in order:
            row = {"repeat": rep, "impl": tag, **run_worker(roots[tag])}
            report["runs"].append(row)
            print(json.dumps(row), flush=True)

    summary, differ = {}, []
    for case in report["runs"][0]:
        if case in ("repeat", "impl"):
            continue
        for tag in roots:
            rows = [r[case] for r in report["runs"] if r["impl"] == tag]
            us = [r["device_us"] for r in rows]
            summary[f"{tag}/{case}"] = {
                "device_us_mean": statistics.fmean(us), "min": min(us),
                "max": max(us), "n": len(us)}
            if len({r["bits_sha256"] for r in rows}) != 1:
                differ.append(f"{tag}/{case}: runs differ")
        if "baseline" in roots:
            b = summary[f"baseline/{case}"]["device_us_mean"]
            summary[f"ratio/{case}"] = b / summary[f"this/{case}"][
                "device_us_mean"]
            same = {r[case]["bits_sha256"] for r in report["runs"]}
            if int(case.split("x")[0]) >= SAME_BITS_FROM and len(same) != 1:
                differ.append(f"{case}: baseline and this tree differ")
    report["summary"], report["differ"] = summary, differ
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"summary": summary, "differ": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
