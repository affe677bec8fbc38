"""Kernel K1 on a CUDA card: the scans it is checked on, its check against
the plain PyTorch version, and its timing. ``chip_smoke.py`` and
``profile_k1.py`` share these; the port's package does not use them.

- ``bench_xyz`` / ``street_keyframes``: chip_smoke's two scenes at
  ``kitti_hdl64()`` widths, made from a seed with numpy;
- ``check_and_time``: labels, curvature and columns of a K1 wrapper
  bit-equal to ``label_and_columns_plain`` (raises otherwise), then
- ``device_us_per_launch``: the kernel's own time on the device, from
  ``torch.profiler`` (CUPTI): self device time of the kernels whose name
  contains the given string, divided by the launches the profiler saw,
  over many launches after warm-up. No host work is inside this number;
- ``host_us_per_call``: the caller's host time per call, host clock
  around many calls with no synchronisation inside the window (the
  enqueue cost: argument checks, allocations, the launch itself);
- ``bound_us``: the least time an H100 could take for some work.

Everything here needs a CUDA device and falls back to nothing.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): HBM3 bandwidth and float32 outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
KERNEL = "k1_kernel"
PROFILE_WINDOWS = 3


def bench_xyz(R: int, P: int):
    """bench.py's scan (seed 0) and the generator after its draws."""
    from lidar_feature_extraction_tpu_torch.utils.synthetic import bench_scan

    rng = np.random.default_rng(0)
    return bench_scan(rng, R, P), rng


def street_keyframes(R: int, P: int, n: int = 7):
    """The street world (seed 1) scanned from ``n`` keyframes: yields
    (xyz, origin, yaw); keyframe 0 is the identity."""
    from lidar_feature_extraction_tpu_torch.utils.synthetic import (
        street_scan, street_world)

    rng = np.random.default_rng(1)
    world = street_world(rng)
    for k in range(n):
        o = (0.0, 0.0) if k == 0 else tuple(rng.uniform(-3, 3, 2) * [1, .3])
        yaw = 0.0 if k == 0 else float(rng.uniform(-0.05, 0.05))
        yield street_scan(world, rng, R, P, o, yaw), o, yaw


def k1_args(xyz: torch.Tensor, count: torch.Tensor, cfg) -> tuple:
    """K1's arguments for a scan xyz [R, P, 3] with count [R]."""
    ex = cfg.extraction
    return (*(xyz[..., i].contiguous() for i in range(3)), count, ex,
            cfg.registration.surface_downsample_leaf, ex.edges_per_ring,
            ex.surface_runs_per_ring)


def k1_inputs(cfg, device) -> dict:
    """K1's arguments on chip_smoke's bench scan and on its street scan
    (keyframe 0), every ring full."""
    ex = cfg.extraction
    R, P = ex.n_rings, ex.max_points_per_ring
    count = torch.full((R,), P, dtype=torch.int32, device=device)
    scans = {"bench": bench_xyz(R, P)[0],
             "street": next(street_keyframes(R, P))[0]}
    return {scene: k1_args(torch.as_tensor(xyz, device=device), count, cfg)
            for scene, xyz in scans.items()}


def k1_work(R: int, P: int, padding: int) -> tuple[int, int]:
    """(bytes, float operations) that K1 must move and do over [R, P]:
    x, y, z and count read once, labels, curvature and col written once;
    per lane about 41 + 2 * padding float operations (range 4, neighbour
    cosine 13, voxel key 6, curvature 2p + 2, thresholds 2, occlusion 4,
    parallel beam 8, range limits 2)."""
    return R * P * 24 + R * 4, R * P * (41 + 2 * padding)


def bound_us(nbytes: int, flops: int) -> tuple[float, str]:
    """(microseconds, "bytes" or "operations"): the larger of the time
    to move ``nbytes`` at the memory rate and to do ``flops`` float32
    operations at the peak rate, and which of the two it is."""
    t_bytes = 1e6 * nbytes / H100_BYTES_PER_S
    t_ops = 1e6 * flops / H100_FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _self_device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    raise RuntimeError("profiler event has no self device time")


def device_us_per_launch(fn, kernel: str, launches: int = 200,
                         warmup: int = 10) -> tuple[float, int]:
    """(mean device time in microseconds of one launch of the kernel(s)
    named ``kernel``, launches the profiler saw) over ``launches`` calls
    of ``fn`` (one launch each). The tracer can miss launches of a window
    (once 111 of 200 on an H100), so the mean is over those it saw, and a
    window where it saw fewer than 100 is traced again, up to
    ``PROFILE_WINDOWS`` in all; raises if none saw between 100 and
    ``launches``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if min(100, launches) <= count <= launches:
            return sum(_self_device_us(e) for e in events) / count, count
        seen.append(count)
    raise RuntimeError(f"profiler saw {seen} launches of {kernel!r} in "
                       f"windows of {launches} calls")


def host_us_per_call(fn, calls: int = 200, warmup: int = 10,
                     windows: int = 5) -> float:
    """Host time per call of ``fn``, in microseconds: the median over
    ``windows`` host-clock windows of ``calls`` calls each, with no
    synchronisation inside a window. (The host is shared, and one
    window can be twice another.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        end = time.perf_counter()
        torch.cuda.synchronize()
        per_call.append(1e6 * (end - start) / calls)
    return statistics.median(per_call)


def check_and_time(wrapper, args: tuple, launches: int = 200,
                   plain=None) -> dict:
    """Checks K1's ``wrapper`` bit-equal to the plain version on ``args``
    (``plain``, by default this tree's ``label_and_columns_plain``;
    raises RuntimeError naming the first output that differs), then
    times it: ``host_us`` per call, ``device_us`` per launch over
    ``launches`` (and ``device_launches_seen``), with the edge and
    surface counts and the curvature's largest difference (0)."""
    from lidar_feature_extraction_tpu_torch.ops import extraction as tex

    got = wrapper(*args)
    want = (plain or tex.label_and_columns_plain)(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("labels", "curvature", "col"), got, want):
        if not torch.equal(g, w):
            raise RuntimeError(f"K1: {name} differs from the plain version")
    call = lambda: wrapper(*args)  # noqa: E731
    host = host_us_per_call(call, launches)
    device, seen = device_us_per_launch(call, KERNEL, launches)
    return {"host_us": host, "device_us": device,
            "device_launches_seen": seen,
            "max_abs_err": float((got[1] - want[1]).abs().max()),
            "edge": int((got[0] == tex.EDGE).sum()),
            "surface": int((got[0] == tex.SURFACE).sum())}
