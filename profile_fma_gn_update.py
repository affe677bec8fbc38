"""Time the ``fma_f32`` and ``gn_update`` kernels (``csrc/fma_f32.cu``,
``csrc/gn_update.cu``) on one CUDA card, against another tree's, in turns.

    python3 profile_fma_gn_update.py                      # this tree alone
    python3 profile_fma_gn_update.py --baseline DIR       # and DIR's, in turns
    python3 profile_fma_gn_update.py --sizes 3 8192 --sass build/sass

``DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` under ``build/``).

Device time. Each tree's two ``.cu`` files are compiled alone into
libraries with a plain C interface (this tree's ``fma_cuda`` flags:
``sm_90a``, no contraction), loaded with ``ctypes`` and called through
their ``extern "C"`` entry points ``fma_f32`` and ``gn_update_f32``, whose
signatures every tree keeps; ``gn_update.cu`` also with
``-DGU_PHASE_TIMING`` (a build the port never uses), whose kernel stamps
``%globaltimer`` and ``clock64()`` at each phase boundary of lane 0's
block. First the bits: every build's outputs must equal the plain
versions (``_xla_f32._fma_plain`` on the card, ``_xla_dot.gn_update_plain``
on the CPU) bit for bit, a NaN against a NaN, on chip_smoke's fma layouts
and triples (``fma_layout``, ``fma_operands``; and a misaligned output
through the C entry point) and on the gn_update cases below. Then, in
turns (baseline, this tree, this tree, baseline) for ``--repeats``
rounds, with ``torch.addcmul`` on the same operands between the two
halves of a round, the profiler's device time per launch
(``k1_check.device_us_per_launch``, ``--launches`` launches):

- fma_f32 at 2^20 elements from memory (each launch the next of
  chip_smoke's ``ROTATE_BYTES`` of operand sets) and in L2, at a row
  block's [8192, 3] against an ``a`` of [8192, 1] the same two ways, and
  at each ``--sizes`` count, contiguous, the same two ways (one output
  for every operand set, as the caching allocator gives a wrapper);
- gn_update on chip_smoke's cases (``gn_kernels_check.gn_update_case`` at
  14,336 rows) at B = 1 and 32, on a B = 32 of regular lanes only, and on
  each of the eight edge lanes alone: what each lane costs.

Then the launch shape of this tree's ``fma_f32`` and of ``addcmul`` at
each of those cases, as the profiler's trace records it (grid, block,
registers per thread, shared memory, blocks and warps per SM, estimated
occupancy), and this tree's phase split (median over ``--phase-launches`` launches
of each phase's ns and cycles) at B = 1 and 32.

Host time. Both trees register the same PyTorch operators, so each
tree's host time is measured in a process of its own, in turns (baseline,
this tree, this tree, baseline): ``k1_check.host_us_per_call`` of the
operator ``lidar_port::fma_f32`` called alone (``host_us_op``), of the
wrapper ``fma_f32_cuda`` (``host_us``), of ``xf.fma`` (the port's call,
``host_us_xf``), of ``torch.addcmul`` (``library_host_us``) and of the
same ``addcmul`` through ``torch.ops.aten.addcmul.default``, the route
the port's operator takes from Python (``library_host_us_ops``), at
2^20, [8192, 3] and the ``--sizes``; and of ``gn_update_cuda`` at B = 1
and 32.

``--sass DIR`` writes ``cuobjdump -sass`` of every build into DIR. Prints
one JSON line per measurement and a summary, and writes everything to
``--out`` (by default ``build/fma_gn_profile.json``). Needs a CUDA device;
fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import itertools
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CSRC = Path("lidar_feature_extraction_tpu_torch") / "csrc"
FMA_KERNEL = "fma_f32"
GU_KERNEL = "gn_update_kernel"
ADDCMUL_KERNEL = "addcmul_cuda_kernel"
# The launch shape's fields in the profiler's trace.
SHAPE_KEYS = ("grid", "block", "registers per thread", "shared memory",
              "blocks per SM", "warps per SM", "est. achieved occupancy %")
GU_ROWS = 14336
MAX_SETS = 4096
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _load(name: str, path: Path):
    """The module at ``path`` (this tree's), whatever ``sys.path`` holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fma_layout(a, b, c):
    """(shape, size, sa, sb, sc) as ``fma_f32_op.cpp`` passes them to the
    C entry point: the broadcast shape and each operand's strides over it
    (0 where it broadcasts), int64 numpy arrays."""
    import torch

    tensors = [x for x in (a, b, c) if isinstance(x, torch.Tensor)]
    shape = tuple(torch.broadcast_shapes(*(x.shape for x in tensors)))
    nd = len(shape)

    def strides(x):
        if not isinstance(x, torch.Tensor):
            return np.zeros(max(nd, 1), np.int64)
        lead = nd - x.dim()
        return np.array([0 if d < lead or x.shape[d - lead] == 1
                         else x.stride(d - lead) for d in range(nd)]
                        + [0] * (nd == 0), np.int64)

    return (shape, np.array(list(shape) or [1], np.int64), strides(a),
            strides(b), strides(c))


class FmaBuild:
    """One compiled ``fma_f32.cu`` loaded with ctypes."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        lib.fma_f32.argtypes = [_P, ctypes.c_float, _P, _P, _P, _LL, _I,
                                _P, _P, _P, _P, _P]
        lib.fma_f32.restype = _I
        self.lib = lib

    def bind(self, a, b, c, out=None):
        """A call of the kernel on (a, b, c) with the layout worked out
        once; returns (call, out)."""
        import torch

        shape, size, sa, sb, sc = fma_layout(a, b, c)
        if out is None:
            out = torch.empty(shape, device=b.device)
        tensor_a = isinstance(a, torch.Tensor)
        args = (a.data_ptr() if tensor_a else None,
                0.0 if tensor_a else float(a), b.data_ptr(), c.data_ptr(),
                out.data_ptr(), out.numel(), len(shape), size.ctypes.data,
                sa.ctypes.data, sb.ctypes.data, sc.ctypes.data)
        # The layout arrays live as long as the call that passes them.
        def call(_arrays=(size, sa, sb, sc)):
            err = self.lib.fma_f32(*args,
                                   torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"fma_f32: CUDA error {err}")
            return out
        return call, out


class GuBuild:
    """One compiled ``gn_update.cu`` loaded with ctypes."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        lib.gn_update_f32.argtypes = [_P] * 10 + [_I, ctypes.c_float] + \
            [_P] * 6
        lib.gn_update_f32.restype = _I
        self.lib = lib
        self.stamped = hasattr(lib, "gu_phase_read")
        if self.stamped:
            lib.gu_phase_names.restype = ctypes.c_char_p
            lib.gu_phase_read.argtypes = [_P, _P]
            lib.gu_phase_read.restype = _I
            lib.gu_stamps.restype = _I
            self.names = lib.gu_phase_names().decode().split(",")

    def bind(self, D, A, b, q, t, tau):
        """A call of the kernel on a batch [B, ...]; returns (call, out)."""
        import torch

        B = D.shape[0]
        dev = D.device
        out = (torch.empty(B, 4, device=dev), torch.empty(B, 3, device=dev),
               torch.empty(B, 6, 6, device=dev), torch.empty(B, device=dev),
               torch.empty(B, device=dev))
        strides = [np.array(x.stride(), np.int64) for x in (D, A, b, q, t)]
        args = (*(x.data_ptr() for x in (D, A, b, q, t)),
                *(s.ctypes.data for s in strides), B, float(tau),
                *(o.data_ptr() for o in out))

        def call(_strides=strides):
            err = self.lib.gn_update_f32(
                *args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"gn_update_f32: CUDA error {err}")
            return out
        return call, out

    def phases(self, call, launches: int) -> dict:
        """The median over ``launches`` launches of each phase's ns and
        cycles (lane 0's block), names with "+" from the start."""
        import torch

        seq = [x for x in self.names if not x.startswith("+")]
        beside = [x for x in self.names if x.startswith("+")]
        extra = np.arange(len(beside))
        k = self.lib.gu_stamps()
        ns = np.zeros(k, np.uint64)
        clk = np.zeros(k, np.int64)
        per_ns, per_clk = [], []
        for i in range(launches + 3):
            call()
            torch.cuda.synchronize()
            if self.lib.gu_phase_read(ns.ctypes.data, clk.ctypes.data):
                raise RuntimeError("gu_phase_read failed")
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


def launch_shape(fn, kernel: str, trace: Path, calls: int = 20,
                 windows: int = 5) -> dict:
    """The launch shape of ``kernel`` (``SHAPE_KEYS``) as the profiler's
    trace, written to ``trace``, records it over ``calls`` calls of
    ``fn``; a window whose trace holds no launch of it (the tracer can
    miss launches) is traced again, up to ``windows`` in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        seen = [e for e in json.loads(trace.read_text())["traceEvents"]
                if e.get("cat") == "kernel"
                and kernel in e.get("name", "")]
        if seen:
            return {"kernel": seen[0]["name"], "launches": len(seen),
                    **{k: seen[0].get("args", {}).get(k)
                       for k in SHAPE_KEYS}}
    raise RuntimeError(f"no launch of {kernel!r} in {windows} traces")


def gn_cases(device) -> dict:
    """gn_update's timed cases: {name: (D, A, b, q, t) on ``device``}."""
    import torch
    import gn_kernels_check as gk

    def on(arrays):
        return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                     for a in arrays)

    b32 = gk.gn_update_case(GU_ROWS, 32)
    # Below GN_EDGE_LANES lanes a case has no edge lanes.
    regular = [gk.gn_update_case(GU_ROWS, 4, seed=s) for s in range(8)]
    cases = {"1": on(gk.gn_update_case(GU_ROWS, 1)), "32": on(b32),
             "32.regular": on(tuple(np.concatenate(x) for x in zip(
                 *regular)))}
    for lane in range(gk.GN_EDGE_LANES + 1):
        cases[f"lane{lane}"] = on(tuple(x[lane:lane + 1] for x in b32))
    return cases


def host_worker(root: Path, sizes: list, build_only: bool) -> int:
    """Builds (and unless ``build_only`` times) ``root``'s operators;
    prints one JSON line of host us per call by case."""
    import torch

    sys.path.insert(0, str(root))
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
    from lidar_feature_extraction_tpu_torch.ops import fma_cuda
    from lidar_feature_extraction_tpu_torch.ops import gn_kernels_cuda

    if Path(fma_cuda.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {fma_cuda.__file__}, not {root}'s")
    if build_only:
        fma_cuda.build()
        gn_kernels_cuda.build()
        return 0
    k1_check = _load("_k1_check", HERE / "k1_check.py")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    out = {}
    op = fma_cuda.load()
    shapes = [("1m", (1 << 20,), (1 << 20,)), ("rows", (8192, 1), (8192, 3))]
    shapes += [(f"n{n}", (n,), (n,)) for n in sizes]
    for name, shape_a, shape in shapes:
        a = torch.randn(shape_a, device=dev, generator=g)
        b = torch.randn(shape, device=dev, generator=g)
        c = torch.randn(shape, device=dev, generator=g)
        out[f"fma.{name}"] = {
            "host_us_op": k1_check.host_us_per_call(
                lambda: op(a, 0.0, b, c)),
            "host_us": k1_check.host_us_per_call(
                lambda: fma_cuda.fma_f32_cuda(a, b, c)),
            "host_us_xf": k1_check.host_us_per_call(lambda: xf.fma(a, b, c)),
            "library_host_us": k1_check.host_us_per_call(
                lambda: torch.addcmul(c, a, b)),
            "library_host_us_ops": k1_check.host_us_per_call(
                lambda: torch.ops.aten.addcmul.default(c, a, b))}
    for name, args in gn_cases(dev).items():
        if name in ("1", "32"):
            out[f"gn_update.{name}"] = {"host_us": k1_check.host_us_per_call(
                lambda: gn_kernels_cuda.gn_update_cuda(*args, 0.1))}
    print(json.dumps(out), flush=True)
    return 0


def run_host_worker(root: Path, sizes: list, build_only: bool = False):
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--host-worker",
         str(root), "--sizes", *map(str, sizes),
         *(["--build-only"] if build_only else [])],
        capture_output=True, text=True, check=False, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"host worker for {root} failed "
                           f"({proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    return None if build_only else json.loads(
        proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--sizes", type=int, nargs="*", default=[])
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--phase-launches", type=int, default=50)
    ap.add_argument("--sass", type=Path, default=None)
    ap.add_argument("--out", type=Path,
                    default=HERE / "build" / "fma_gn_profile.json")
    ap.add_argument("--host-worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.host_worker is not None:
        return host_worker(opts.host_worker.resolve(), opts.sizes,
                           opts.build_only)

    import torch

    if not torch.cuda.is_available():
        print("profile_fma_gn_update: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke
    import gn_kernels_check as gk
    from k1_check import device_us_per_launch
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
    from lidar_feature_extraction_tpu_torch.ops import fma_cuda
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
    flags = fma_cuda._flags()
    jobs = [(tag, kind, timing) for tag in roots
            for kind, timing in (("fma", ()), ("gu", ()),
                                 ("gu", ("-DGU_PHASE_TIMING",)))]

    def build(job):
        tag, kind, timing = job
        root = roots.get(tag, HERE)
        src = root / CSRC / ("fma_f32.cu" if kind == "fma"
                             else "gn_update.cu")
        return job, build_library(src, flags + timing,
                                  f"fg_profile_{tag}_{kind}", key=str(src))

    # The operators' builds (the host workers') beside the plain ones.
    with ThreadPoolExecutor(len(jobs) + len(roots)) as pool:
        host_builds = [pool.submit(run_host_worker, r, opts.sizes, True)
                       for r in roots.values()]
        paths = dict(pool.map(build, jobs))
        for f in host_builds:
            f.result()
    fma = {tag: FmaBuild(paths[tag, "fma", ()]) for tag in roots}
    gu = {tag: GuBuild(paths[tag, "gu", ()]) for tag in roots}
    stamped = {tag: GuBuild(paths[tag, "gu", ("-DGU_PHASE_TIMING",)])
               for tag in roots}
    report = {"nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0),
              "roots": {k: str(v) for k, v in roots.items()},
              "builds": {f"{tag}.{kind}{''.join(timing)}":
                         p.with_suffix(".log").read_text()
                         if p.with_suffix(".log").exists() else ""
                         for (tag, kind, timing), p in paths.items()},
              "checks": {}, "runs": [], "host": [], "shapes": {},
              "phases": {}}
    if opts.sass is not None:
        opts.sass.mkdir(parents=True, exist_ok=True)
        for (tag, kind, timing), p in paths.items():
            dump = subprocess.run(["cuobjdump", "-sass", str(p)],
                                  capture_output=True, text=True,
                                  check=False, timeout=300)
            stamped_ = ".stamped" if kind == "gu" and timing else ""
            name = f"{tag}.{kind}{stamped_}.sass"
            (opts.sass / name).write_text(dump.stdout + dump.stderr)

    # Bits first.
    dev = torch.device("cuda")
    for name in (*chip_smoke.FMA_LAYOUTS, "triples", "misaligned_out"):
        if name == "triples":
            a, b, c = chip_smoke.fma_operands(dev)
        elif name == "misaligned_out":
            a, b, c = chip_smoke.fma_layout("offset_all", dev)
        else:
            a, b, c = chip_smoke.fma_layout(name, dev)
        want = xf._fma_plain(a, b, c)
        for tag, build_ in fma.items():
            out = None
            if name == "misaligned_out":
                out = torch.empty(want.numel() + 1, device=dev)[1:]
            call, got = build_.bind(a, b, c, out)
            if want.numel():
                call()
            torch.cuda.synchronize()
            report["checks"][f"fma.{tag}/{name}"] = \
                gk.differing(got.view(want.shape), want) \
                if want.numel() else 0
    cases = gn_cases(dev)
    for name, args in cases.items():
        want = xd.gn_update_plain(*(x.cpu() for x in args), gk.TAU)
        for tag, build_ in {**gu, **{f"{t}.stamped": b
                                     for t, b in stamped.items()}}.items():
            call, got = build_.bind(*args, gk.TAU)
            call()
            torch.cuda.synchronize()
            diff = gk.compare(got, want, gk.GN_OUTPUTS)
            report["checks"][f"gn_update.{tag}/{name}"] = sum(diff.values())
    bad = {k: v for k, v in report["checks"].items() if v}
    print(json.dumps({"checks": len(report["checks"]), "differ": bad}),
          flush=True)

    # Device time in turns.
    g = torch.Generator(device=dev).manual_seed(12)
    fma_cases = {}
    shapes = [("1m", (1 << 20,), (1 << 20,)), ("rows", (8192, 1), (8192, 3))]
    shapes += [(f"n{n}", (n,), (n,)) for n in opts.sizes]
    for name, shape_a, shape in shapes:
        n = int(np.prod(shape))
        nbytes = 4 * (shape_a[0] + 3 * n)
        # At most MAX_SETS sets: a size of a few elements stays in L2
        # whatever the rotation.
        sets = min(-(-chip_smoke.ROTATE_BYTES // nbytes), MAX_SETS)
        # Each set 16-byte aligned, as a fresh allocation is.
        bulk = [torch.randn((sets, -(-x[0] // 4) * 4, *x[1:]), device=dev,
                            generator=g)[:, :x[0]]
                for x in (shape_a, shape, shape)]
        fma_cases[name] = [tuple(x[i] for x in bulk) for i in range(sets)]
    order = list(roots) + ["addcmul"] + list(roots)[::-1]

    def timed(calls, kernel):
        cycle = itertools.cycle(calls)
        return device_us_per_launch(lambda: next(cycle)(), kernel,
                                    opts.launches)

    def fma_calls(tag, ops):
        if tag == "addcmul":
            return [lambda x=x: torch.addcmul(x[2], x[0], x[1]) for x in ops]
        # One output for every operand set, as the caching allocator hands
        # addcmul (and the port's wrapper) the same block on each call.
        _, out = fma[tag].bind(*ops[0])
        return [fma[tag].bind(*x, out)[0] for x in ops]

    for rep in range(opts.repeats):
        for tag in order:
            row = {"repeat": rep, "impl": tag}
            kernel = ADDCMUL_KERNEL if tag == "addcmul" else FMA_KERNEL
            for name, ops in fma_cases.items():
                calls = fma_calls(tag, ops)
                row[f"fma.{name}"] = timed(calls, kernel)[0]
                if len(ops) > 1:
                    row[f"fma.{name}.l2"] = timed(calls[:1], kernel)[0]
            for name, args in cases.items():
                if tag not in gu:
                    break
                call, _ = gu[tag].bind(*args, gk.TAU)
                row[f"gn_update.{name}"] = timed([call], GU_KERNEL)[0]
            report["runs"].append(row)
            print(json.dumps(row), flush=True)

    trace = opts.out.parent / "fma_gn_profile_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    for name, ops in fma_cases.items():
        for tag in ("this", "addcmul"):
            kernel = ADDCMUL_KERNEL if tag == "addcmul" else FMA_KERNEL
            shape = launch_shape(fma_calls(tag, ops[:1])[0], kernel, trace)
            report["shapes"][f"{tag}/fma.{name}"] = shape
            print(json.dumps({"shape": f"{tag}/fma.{name}", **shape}),
                  flush=True)
    trace.unlink()

    for tag, build_ in stamped.items():
        if not build_.stamped:
            continue
        for name in ("1", "32"):
            call, _ = build_.bind(*cases[name], gk.TAU)
            split = build_.phases(call, opts.phase_launches)
            report["phases"][f"{tag}/{name}"] = split
            print(json.dumps({"phases": f"{tag}/{name}", **split}),
                  flush=True)

    for tag in list(roots) + list(roots)[::-1]:
        row = {"impl": tag, **run_host_worker(roots[tag], opts.sizes)}
        report["host"].append(row)
        print(json.dumps({"host": row}), flush=True)

    summary = {}
    for key in report["runs"][0]:
        if key in ("repeat", "impl"):
            continue
        for tag in (*roots, "addcmul"):
            us = [r[key] for r in report["runs"]
                  if r["impl"] == tag and key in r]
            if not us:
                continue
            summary[f"{tag}/{key}"] = {"device_us_mean": statistics.fmean(us),
                                       "min": min(us), "max": max(us),
                                       "n": len(us)}
    for tag in roots:
        for key, row in report["host"][0].items():
            if key == "impl":
                continue
            for field in row:
                vals = [h[key][field] for h in report["host"]
                        if h["impl"] == tag]
                summary[f"{tag}/{key}.{field}"] = {
                    "mean": statistics.fmean(vals), "all": vals}
    report["summary"] = summary
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"summary": summary, "differ": bad}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
