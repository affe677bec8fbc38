"""Kernel K1 on CUDA: fused labeling + compaction columns of a range image.

Replaces the reference's Pallas kernel
``lidar_feature_extraction_tpu/ops/extraction_pallas.py::
label_and_columns_pallas``. The kernel is ``csrc/extraction_k1.cu``
(CUDA C++ for ``sm_90a``, one thread block per ring, every plane of the
ring in shared memory; the header of that file says what bounds it on an
H100 and what the design does about it). Its plain PyTorch version is
``ops/extraction.py::label_and_columns_plain``.

Build: ``nvcc`` compiles the source into a shared library with a plain C
interface under ``build/kernels/`` at the repository root, named by a
hash of the source and flags, at first use; ``ctypes`` loads it. A
failed build raises. Nothing is compiled or loaded at import time.

``label_and_columns`` dispatches on the tensors' device: CPU tensors go
to the plain version, CUDA tensors to the kernel, with no fallback
between the two.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.config import ExtractionConfig
from lidar_feature_extraction_tpu_torch.ops.extraction import (
    label_and_columns_plain)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "extraction_k1.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: K1 cannot be built")
    return path


def build() -> Path:
    """Compile K1 unless the library for this source and these flags
    exists (it is named by their hash). The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library as ``.log``. Raises on failure."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libextraction_k1_{digest[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load K1's library once per process."""
    lib = ctypes.CDLL(str(build()))
    lib.k1_smem_bytes.argtypes = [_I]
    lib.k1_smem_bytes.restype = ctypes.c_size_t
    lib.k1_max_smem_bytes.argtypes = [_I]
    lib.k1_max_smem_bytes.restype = _I
    lib.k1_error_string.argtypes = [_I]
    lib.k1_error_string.restype = ctypes.c_char_p
    lib.k1_label_and_columns.argtypes = (
        [_P] * 7 + [_I] * 5 + [_F] * 8 + [_I, _I, _P])
    lib.k1_label_and_columns.restype = _I
    return lib


def _f32(v: float) -> float:
    """A Python float rounded to float32, the way JAX and torch round a
    Python scalar compared against a float32 array."""
    return float(np.float32(v))


def label_and_columns_cuda(x: torch.Tensor, y: torch.Tensor,
                           z: torch.Tensor, count: torch.Tensor,
                           cfg: ExtractionConfig, surface_leaf: float,
                           ce: int, cs: int):
    """Launch K1 on [R, P] float32 CUDA planes x, y, z and count [R].
    Returns (labels [R, P] int32, curvature [R, P] float32,
    col [R, P] int32) on the current stream, without synchronising.
    Each launch adds one to ``label_and_columns_cuda.launches``."""
    for name, t in (("x", x), ("y", y), ("z", z)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"K1: {name} must be a 2-D float32 CUDA "
                             f"tensor, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if t.shape != x.shape or t.device != x.device:
            raise ValueError(f"K1: {name} must match x's shape and device")
    R, P = x.shape
    if R == 0 or P == 0:
        raise ValueError(f"K1: empty range image {tuple(x.shape)}")
    if count.shape != (R,):
        raise ValueError(f"K1: count must be [{R}], got {tuple(count.shape)}")
    if not 0 < cfg.n_blocks <= 127 or cfg.padding < 0 or cfg.nms_rounds < 0:
        raise ValueError("K1: needs 0 < n_blocks <= 127, padding >= 0 "
                         "and nms_rounds >= 0")
    if ce < 0 or cs <= 0:
        raise ValueError("K1: needs ce >= 0 and cs > 0")

    lib = load()
    device = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    smem = lib.k1_smem_bytes(P)
    limit = lib.k1_max_smem_bytes(device)
    if smem > limit:
        raise ValueError(f"K1: a ring of {P} points needs {smem} bytes of "
                         f"shared memory; the device allows {limit}")

    x, y, z = x.contiguous(), y.contiguous(), z.contiguous()
    count = count.to(device=x.device, dtype=torch.int32).contiguous()
    labels = torch.empty((R, P), dtype=torch.int32, device=x.device)
    curv = torch.empty((R, P), dtype=torch.float32, device=x.device)
    col = torch.empty((R, P), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.k1_label_and_columns(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), count.data_ptr(),
            labels.data_ptr(), curv.data_ptr(), col.data_ptr(),
            R, P, cfg.padding, cfg.n_blocks, cfg.nms_rounds,
            _f32(math.cos(cfg.radian_threshold)), _f32(cfg.edge_threshold),
            _f32(cfg.surface_threshold), _f32(cfg.distance_diff_threshold),
            _f32(cfg.min_range), _f32(cfg.max_range),
            _f32(cfg.parallel_beam_min_range_ratio), _f32(surface_leaf),
            ce, cs, stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: CUDA error {err} "
                           f"({lib.k1_error_string(err).decode()})")
    label_and_columns_cuda.launches += 1
    return labels, curv, col


label_and_columns_cuda.launches = 0


def label_and_columns(x, y, z, count, cfg: ExtractionConfig,
                      surface_leaf: float, ce: int, cs: int):
    """K1 for CUDA tensors, its plain version for CPU tensors."""
    if x.device.type == "cpu":
        return label_and_columns_plain(x, y, z, count, cfg, surface_leaf,
                                       ce, cs)
    if x.device.type == "cuda":
        return label_and_columns_cuda(x, y, z, count, cfg, surface_leaf,
                                      ce, cs)
    raise ValueError(f"K1: no version for device {x.device}")
