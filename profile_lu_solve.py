"""Check and time the ``lu_solve`` kernel (``csrc/lu_solve.cu``) on one CUDA
card at the pose graph's bucket sizes, against cuSOLVER and, optionally,
another tree's kernel.

    python3 profile_lu_solve.py                       # this tree
    python3 profile_lu_solve.py --baseline DIR        # and DIR's kernel
    python3 profile_lu_solve.py --sizes 384 768 --launches 50
    python3 profile_lu_solve.py --phases              # and the phase split

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` under ``build/``); its
``csrc/lu_solve.cu`` is compiled with this tree's flags and called through
its own ``extern "C"`` entry point, ``lu_solve(lu, acc, perm, x, b, batch,
n, k, stream)`` (the one-CTA kernel, which factors ``lu`` in place).

First the bits: at every size, chip_smoke's systems of each of
``chip_smoke.LU_KINDS`` (pose-graph-shaped, random, ties in the pivot
column, singular) through the kernel against the plain version on a CPU
copy of the same inputs (``lu_cuda.lu_solve_plain``; NaN against NaN),
and three systems in one launch against their lone launches. Then, on the pose-graph-shaped
system: the profiler's device time per launch
(``k1_check.device_us_per_launch``), the host time per call
(``k1_check.host_us_per_call``), the CUDA-event time of one call, of
``torch.linalg.solve_ex`` (cuSOLVER; used nowhere in the port) and of the
baseline's kernel, in turns (this tree, cuSOLVER, baseline, this tree),
and the bound (``k1_check.bound_us``: the matrix and right-hand side read
once and the solution written once, against 2n^3/3 float32 operations).

With ``--phases``, the kernel is also built with ``-DLU_PHASE_TIMING``
(a build the port never uses), whose first CTA stamps ``%globaltimer`` at
each step of ``kalman.lu_plan(n)``: the split of one call (after warm-up,
median of ``--reps`` calls) into the copy, the panels (``getf2``, on one
CTA while the others wait), the updates' work seen from the first CTA,
the grid barriers' waits, and the solve, and the first CTA's sub-phases
of the panels (load, the rows above the diagonal, sgemv and the pivot,
swap and scale, store and row swaps) and of the solve (the lower
triangle's blocks and its chains, the upper triangle) in SM cycles,
with the ptxas report of both builds.

Prints one JSON object and writes it to ``chiprun_out/profile_lu_solve.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

import chip_smoke
import k1_check
from lidar_feature_extraction_tpu_torch.fusion import kalman
from lidar_feature_extraction_tpu_torch.ops import lu_cuda
from lidar_feature_extraction_tpu_torch.ops.extraction_cuda import (
    build_library)

ROOT = Path(__file__).resolve().parent
SIZES = chip_smoke.LU_SIZES


def baseline_library(tree: Path):
    """The baseline tree's kernel, built with this tree's flags."""
    lib = ctypes.CDLL(str(build_library(
        tree / "lidar_feature_extraction_tpu_torch" / "csrc" / "lu_solve.cu",
        lu_cuda.NVCC_FLAGS, "lu_solve_baseline")))
    lib.lu_solve.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.lu_solve.restype = ctypes.c_int

    def run(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        n = a.shape[-1]
        lu = a.reshape(1, n, n).clone()
        acc = torch.empty_like(lu)
        perm = torch.empty((1, n), dtype=torch.int32, device=a.device)
        x = torch.empty((1, n, 1), dtype=torch.float32, device=a.device)
        err = lib.lu_solve(lu.data_ptr(), acc.data_ptr(), perm.data_ptr(),
                           x.data_ptr(), b.contiguous().data_ptr(), 1, n, 1,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline lu_solve: CUDA error {err}")
        return x[0, :, 0]
    return run


def phase_split(n: int, reps: int, device) -> dict:
    """One call's phases (ns, median over ``reps`` calls) from the
    ``-DLU_PHASE_TIMING`` build, called through its C entry point."""
    so = build_library(lu_cuda.SOURCE,
                       lu_cuda.NVCC_FLAGS + ("-DLU_PHASE_TIMING",),
                       "lu_solve_phases")
    lib = ctypes.CDLL(str(so))
    lib.lu_solve.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.lu_solve_grid.argtypes = [ctypes.c_int]
    lib.lu_solve_workspace_floats.argtypes = [ctypes.c_int]
    lib.lu_solve_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.lu_solve_parts.argtypes = [ctypes.c_void_p]
    names = ("getf2_load", "getf2_row_step", "getf2_gemv_pivot",
             "getf2_swap_scale", "getf2_store_swaps", "solve_lower_blocks",
             "solve_lower_extend", "solve_upper")
    sums = (ctypes.c_ulonglong * len(names))()
    a, b = chip_smoke.lu_system(n, "spd", device)
    plan = kalman.lu_plan(n)
    steps = torch.tensor(plan, dtype=torch.int32, device=device)
    parts = lib.lu_solve_grid(1)
    work = torch.empty(lib.lu_solve_workspace_floats(n), device=device)
    x = torch.empty(n, device=device)
    count = 4 + 3 * len(plan)
    stamps = (ctypes.c_ulonglong * count)()
    rows = []
    for _ in range(reps + 3):
        err = lib.lu_solve(a.data_ptr(), x.data_ptr(), b.data_ptr(),
                           steps.data_ptr(), work.data_ptr(), len(plan), 1,
                           n, 1, parts,
                           torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if (err or lib.lu_solve_stamps(stamps, count)
                or lib.lu_solve_parts(sums)):
            raise RuntimeError("lu_solve_phases failed")
        t = list(stamps)
        split = {"copy": t[1] - t[0], "getf2": 0, "update_work": 0,
                 "update_wait": 0, "getf2_wait": 0,
                 "solve": t[count - 1] - t[count - 2]}
        for s, step in enumerate(plan):
            start, own, done = t[2 + 3 * s: 5 + 3 * s]
            if step[0] == kalman.GETF2:
                split["getf2"] += own - start
                split["getf2_wait"] += done - own
            else:
                split["update_work"] += own - start
                split["update_wait"] += done - own
        split["total"] = t[count - 1] - t[0]
        split.update((f"{k}_cycles", v) for k, v in zip(names, sums))
        rows.append(split)
    rows = rows[3:]
    out = {key: statistics.median(r[key] for r in rows) for key in rows[0]}
    out.update(parts=parts, steps=len(plan),
               getf2_steps=sum(st[0] == kalman.GETF2 for st in plan))
    return out


def event_ms(fn, reps: int) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--sizes", type=int, nargs="+", default=SIZES)
    parser.add_argument("--baseline", type=Path, default=None)
    parser.add_argument("--launches", type=int, default=100)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--phases", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_lu_solve.py needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    base = baseline_library(args.baseline) if args.baseline else None
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi.strip(),
           "checks": {}, "timing": {}}
    for n in args.sizes:
        for kind in chip_smoke.LU_KINDS:
            a, b = chip_smoke.lu_system(n, kind, dev)
            got = lu_cuda.lu_solve_cuda(a, b)
            want = lu_cuda.lu_solve_plain(a.cpu(), b.cpu())
            torch.cuda.synchronize()
            out["checks"][f"{kind}.{n}"] = chip_smoke.lu_bits_equal(
                got, want)
        a = torch.stack([chip_smoke.lu_system(n, "spd", dev)[0] + 0.5 * k
                         for k in range(3)])
        b = torch.stack([chip_smoke.lu_system(n, "random", dev)[1]
                         * (k + 1)
                         for k in range(3)])
        batch = lu_cuda.lu_solve_cuda(a, b)
        lone = torch.stack([lu_cuda.lu_solve_cuda(x, y) for x, y in zip(a, b)])
        out["checks"][f"batch.{n}"] = chip_smoke.lu_bits_equal(batch,
                                                               lone)
    for n in args.sizes:
        a, b = chip_smoke.lu_system(n, "spd", dev)
        mine = lambda: lu_cuda.lu_solve_cuda(a, b)  # noqa: E731
        library = lambda: torch.linalg.solve_ex(a, b)  # noqa: E731
        dev_us, seen = k1_check.device_us_per_launch(
            mine, "lu_solve_kernel", args.launches)
        row = {"device_us": dev_us, "launches_seen": seen,
               "host_us": k1_check.host_us_per_call(mine, calls=50),
               "ms": event_ms(mine, args.reps),
               "library_ms": event_ms(library, args.reps)}
        if base is not None:
            row["baseline_ms"] = event_ms(lambda: base(a, b), args.reps)
            row["baseline_bits_equal_plain"] = chip_smoke.lu_bits_equal(
                base(a, b), lu_cuda.lu_solve_plain(a.cpu(), b.cpu()))
        row["ms_again"] = event_ms(mine, args.reps)
        bound, by = k1_check.bound_us(4 * (n * n + 2 * n), 2 * n ** 3 // 3)
        row.update(bound_us=bound, bound_by=by)
        out["timing"][str(n)] = row
    if args.phases:
        out["phases_ns"] = {str(n): phase_split(n, args.reps, dev)
                            for n in args.sizes}
        out["ptxas"] = {
            so.name: so.with_suffix(".log").read_text()[-600:]
            for so in (lu_cuda.build(), build_library(
                lu_cuda.SOURCE, lu_cuda.NVCC_FLAGS + ("-DLU_PHASE_TIMING",),
                "lu_solve_phases"))}
    out["all_checks_pass"] = all(out["checks"].values())
    text = json.dumps(out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "profile_lu_solve.json").write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
