"""Profiling helpers: per-stage wall-time counters and a device trace.

Port of ``lidar_feature_extraction_tpu/utils/profiling.py``. Wrap any
stage with ``StageTimer`` for scans/s accounting, or use ``trace`` to
capture a ``torch.profiler`` trace of the hot path (CPU and CUDA
activity) that Perfetto (ui.perfetto.dev) or TensorBoard's profiler
plugin opens.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulates wall time per named stage. Given ``block_on`` (the
    stage's outputs, or any object), a stage waits for the card before it
    stops the clock, where the reference calls
    ``jax.block_until_ready(block_on)``, so times are honest under
    asynchronous launches."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        yield
        if block_on is not None and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> dict:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name]
                / max(self.counts[name], 1),
                "per_sec": self.counts[name] / self.totals[name]
                if self.totals[name] > 0 else float("inf"),
            }
            for name in self.totals
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body (CPU and, where there is a card, CUDA activity)
    and write its trace to ``log_dir/trace.json`` (Chrome trace format:
    Perfetto and TensorBoard read it). The context's value is that
    path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
