"""Time the ``robust_weights`` kernel (``csrc/robust_weights.cu``) on one
CUDA card, and split its device time into phases, against another tree's.

    python3 profile_robust_weights.py                     # this tree alone
    python3 profile_robust_weights.py --baseline DIR      # and DIR's, in turns
    python3 profile_robust_weights.py --cluster 2 8       # and this tree's
                                                          # kernel at fixed
                                                          # cluster sizes

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` under ``build/``). Each tree's
``csrc/robust_weights.cu`` is compiled alone into a library with a plain
C interface (this tree's ``fma_cuda`` flags: ``sm_90a``, no contraction),
loaded with ``ctypes`` and called through ``robust_weights_f32``, twice:
as the port builds it, and with ``-DRW_PHASE_TIMING`` (a build the port
never uses), whose kernel stamps ``%globaltimer`` and ``clock64()`` after
a barrier at each phase boundary of lane 0's first block. With
``--cluster C ...`` this tree's kernel is also built with
``-DRW_CLUSTER=C`` for each C, which fixes the number of CTAs that share a
lane (only a source that reads ``RW_CLUSTER`` differs).

The cases are chip_smoke's (``gn_kernels_check.robust_weights_case``):
10,240 correspondences at B = 1 without and with the block medians, at
B = 8 and 32 with them, and 14,336 at B = 1 with them. Every build's outputs
must equal this tree's plain version (``stats.robust_weights_plain``, on
the CPU) bit for bit, a NaN against a NaN. Then, in turns (baseline, this
tree, variants, and back) for ``--repeats`` rounds: the profiler's device
time per launch (``k1_check.device_us_per_launch``, ``--launches``
launches), and once per build the phase split: the median over
``--phase-launches`` launches of each phase's ns and cycles.

Prints one JSON line per measurement and a summary, writes everything to
``--out`` (by default ``build/rw_profile.json``). Needs a CUDA device;
fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = Path("lidar_feature_extraction_tpu_torch") / "csrc" / \
    "robust_weights.cu"
CASES = ((10240, 1, False), (10240, 1, True), (10240, 8, True),
         (10240, 32, True), (14336, 1, True))
KERNEL = "robust_weights_kernel"
_P, _I = ctypes.c_void_p, ctypes.c_int


def case_name(n: int, batch: int, medians: bool) -> str:
    return f"{n}x{batch}.{'loop' if medians else 'step'}"


class Build:
    """One compiled ``robust_weights.cu`` loaded with ctypes."""

    def __init__(self, path: Path, table):
        lib = ctypes.CDLL(str(path))
        lib.robust_weights_f32.argtypes = [
            _P, _P, _I, _I, _P, _I, _I, ctypes.c_double, _P, _P, _P, _P,
            _P, _P]
        lib.robust_weights_f32.restype = _I
        if hasattr(lib, "robust_weights_set_table"):
            lib.robust_weights_set_table.argtypes = [_P, _I]
            lib.robust_weights_set_table.restype = _I
            if lib.robust_weights_set_table(table.ctypes.data, table.size):
                raise RuntimeError("robust_weights_set_table failed")
        self.lib = lib
        self.stamped = hasattr(lib, "rw_phase_read")
        if self.stamped:
            lib.rw_phase_names.restype = ctypes.c_char_p
            lib.rw_phase_read.argtypes = [_P, _P]
            lib.rw_phase_read.restype = _I
            lib.rw_stamps.restype = _I
            self.names = lib.rw_phase_names().decode().split(",")

    def call(self, errors, valid, shape, medians: bool, out=None):
        """The kernel's (n_valid, error, scale, weights, block_meds) of
        ``errors``, ``valid`` [B, N] on the card, into ``out`` if given."""
        import torch

        batch, n = errors.shape
        sizes = np.array([s for s, _ in shape], np.int64)
        nb = len(shape) if medians else 0
        dev = errors.device
        if out is None:
            out = (torch.empty(batch, dtype=torch.int32, device=dev),
                   torch.empty(batch, device=dev),
                   torch.empty(batch, device=dev),
                   torch.empty(batch, n, device=dev),
                   torch.empty(batch, nb, device=dev))
        err = self.lib.robust_weights_f32(
            errors.data_ptr(), valid.data_ptr(), batch, n,
            sizes.ctypes.data, nb, int(medians), 1.345,
            *(o.data_ptr() for o in out),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"robust_weights_f32: CUDA error {err}")
        return out

    def phases(self, args, launches: int) -> dict:
        """The median over ``launches`` launches of each phase's ns and
        cycles (lane 0's first block), and of the whole span."""
        import torch

        # Phases in order, each from the previous stamp; then those named
        # "+...", each from the start, in the last slots.
        seq = [x for x in self.names if not x.startswith("+")]
        beside = [x for x in self.names if x.startswith("+")]
        extra = np.arange(len(beside))
        k = self.lib.rw_stamps()
        ns = np.zeros(k, np.uint64)
        clk = np.zeros(k, np.int64)
        out = self.call(*args)
        per_ns, per_clk = [], []
        for i in range(launches + 3):
            self.call(*args, out=out)
            torch.cuda.synchronize()
            if self.lib.rw_phase_read(ns.ctypes.data, clk.ctypes.data):
                raise RuntimeError("rw_phase_read failed")
            if i >= 3:
                t, c = ns.astype(np.int64), clk
                per_ns.append(np.concatenate([
                    np.diff(t[:len(seq) + 1]), t[-1 - extra] - t[0]]))
                per_clk.append(np.concatenate([
                    np.diff(c[:len(seq) + 1]), c[-1 - extra] - c[0]]))
        med_ns = np.median(np.stack(per_ns), axis=0)
        med_clk = np.median(np.stack(per_clk), axis=0)
        return {"phases": {name: {"us": float(a) / 1e3, "cycles": float(c)}
                           for name, a, c in zip(seq + beside, med_ns,
                                                 med_clk)},
                "span_us": float(np.median([x[:len(seq)].sum()
                                            for x in per_ns])) / 1e3,
                "span_cycles": float(np.median([x[:len(seq)].sum()
                                                for x in per_clk]))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--cluster", type=int, nargs="*", default=[])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--phase-launches", type=int, default=50)
    ap.add_argument("--out", type=Path,
                    default=HERE / "build" / "rw_profile.json")
    opts = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_robust_weights: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import gn_kernels_check as gk
    from k1_check import device_us_per_launch
    from lidar_feature_extraction_tpu_torch.core import stats
    from lidar_feature_extraction_tpu_torch.ops import fma_cuda, gn_kernels_cuda
    from lidar_feature_extraction_tpu_torch.ops.extraction_cuda import (
        build_library)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)

    roots = {"this": HERE}
    if opts.baseline is not None:
        roots = {"baseline": opts.baseline.resolve(), "this": HERE}
    variants = {tag: (root, ()) for tag, root in roots.items()}
    for c in opts.cluster:
        variants[f"this.c{c}"] = (HERE, (f"-DRW_CLUSTER={c}",))
    flags = fma_cuda._flags()

    def build(item):
        tag, (root, extra) = item
        src = root / SOURCE
        return tag, tuple(
            build_library(src, flags + extra + timing, f"rw_profile_{tag}",
                          key=str(src))
            for timing in ((), ("-DRW_PHASE_TIMING",)))

    with ThreadPoolExecutor(2 * len(variants)) as pool:
        paths = dict(pool.map(build, variants.items()))
    table = gn_kernels_cuda.rsqrt_table() if hasattr(
        gn_kernels_cuda, "rsqrt_table") else np.zeros(1, np.uint16)
    builds = {tag: tuple(Build(p, table) for p in pair)
              for tag, pair in paths.items()}
    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0),
              "roots": {k: str(v) for k, v in roots.items()},
              "variants": {k: list(v[1]) for k, v in variants.items()},
              "builds": {tag: [p.with_suffix(".log").read_text()
                               if p.with_suffix(".log").exists() else ""
                               for p in pair]
                         for tag, pair in paths.items()},
              "checks": {}, "runs": [], "phases": {}}

    dev = torch.device("cuda")
    inputs = {}
    for n, batch, medians in CASES:
        errors, valid, shape = gk.robust_weights_case(n, batch)
        e, v = torch.as_tensor(errors), torch.as_tensor(valid)
        want = stats.robust_weights_plain(e, v, shape, gk.HUBER_K, medians)
        args = (e.to(dev), v.to(dev), shape, medians)
        case = case_name(n, batch, medians)
        inputs[case] = args
        for tag, pair in builds.items():
            for kind, b in zip(("timed", "stamped"), pair):
                got = b.call(*args)
                torch.cuda.synchronize()
                diff = gk.compare(got[:4] + ((got[4] if medians else None),),
                                  want, gk.RW_OUTPUTS)
                report["checks"][f"{tag}.{kind}/{case}"] = diff
    bad = {k: v for k, v in report["checks"].items() if any(v.values())}
    print(json.dumps({"checks": len(report["checks"]), "differ": bad}),
          flush=True)

    order = list(variants) + list(variants)[::-1]
    for rep in range(opts.repeats):
        for tag in order:
            timed = builds[tag][0]
            row = {"repeat": rep, "impl": tag}
            for case, args in inputs.items():
                out = timed.call(*args)
                us, seen = device_us_per_launch(
                    lambda: timed.call(*args, out=out), KERNEL,
                    opts.launches)
                row[case] = {"device_us": us, "device_launches_seen": seen}
            report["runs"].append(row)
            print(json.dumps(row), flush=True)
    for tag in order[:len(variants)]:
        stamped = builds[tag][1]
        if not stamped.stamped:
            continue
        for case, args in inputs.items():
            split = stamped.phases(args, opts.phase_launches)
            report["phases"][f"{tag}/{case}"] = split
            print(json.dumps({"phases": f"{tag}/{case}", **split}),
                  flush=True)

    summary = {}
    for tag in variants:
        for case in inputs:
            us = [r[case]["device_us"] for r in report["runs"]
                  if r["impl"] == tag]
            summary[f"{tag}/{case}"] = {
                "device_us_mean": statistics.fmean(us), "min": min(us),
                "max": max(us), "n": len(us)}
    report["summary"] = summary
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"summary": summary, "differ": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
