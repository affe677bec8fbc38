"""Kernel K1 on CUDA: fused labeling + compaction columns of a range image.

Replaces the reference's Pallas kernel
``lidar_feature_extraction_tpu/ops/extraction_pallas.py::
label_and_columns_pallas``. The kernel is ``csrc/extraction_k1.cu``
(CUDA C++ for ``sm_90a``, a cluster of two thread blocks per ring,
ballot-mask NMS; the header of that file says what bounds it on an H100
and what the design does about it). Its plain PyTorch version is
``ops/extraction.py::label_and_columns_plain``.

Limits: padding <= 16 (the kernel's window masks are 2 * padding bits),
n_blocks <= 127 and at most 6144 points per ring; the wrapper raises
beyond them.

Build: ``nvcc`` compiles the source into a shared library with a plain C
interface under ``build/kernels/`` at the repository root, named by a
hash of the source and flags, at first use; ``ctypes`` loads it. A
failed build raises. Nothing is compiled or loaded at import time.

Host cost per call is kept small: the kernel's shared-memory attribute
is set once per device, the float parameters are packed once per
configuration, and the three outputs are planes of one allocation.

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
# Limits of the kernel (csrc/extraction_k1.cu: kMaxPadding, kMaxBlocks);
# the most points per ring (6144) comes from the library.
MAX_PADDING = 16
MAX_BLOCKS = 127

_P = ctypes.c_void_p
_I = ctypes.c_int


class _Params(ctypes.Structure):
    """The kernel's ``Params``, field for field."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("padding", "n_blocks", "nms_rounds", "ce", "cs")] + \
               [(name, ctypes.c_float) for name in
                ("cos_thr", "edge_thr", "surf_thr", "dist_thr", "min_range",
                 "max_range", "par_thr", "leaf")]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: no kernel can be built")
    return path


def build_library(sources, flags, stem: str, key: str = "") -> Path:
    """Compile ``sources`` (one path or several) with ``nvcc flags`` into
    ``build/kernels/`` unless the library for these sources, flags and
    ``key`` exists (it is named ``lib<stem>_<hash>.so`` by their hash).
    The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside the library as ``.log``. Raises on failure."""
    sources = [sources] if isinstance(sources, Path) else list(sources)
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in sources)
                            + (" ".join(flags) + key).encode()).hexdigest()
    so = BUILD_DIR / f"lib{stem}_{digest[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def build() -> Path:
    """Compile K1 (``build_library``) unless it is built."""
    return build_library(SOURCE, NVCC_FLAGS, "extraction_k1")


class _Library:
    """K1's loaded library and what it has set up on each device."""

    def __init__(self, path: Path):
        lib = ctypes.CDLL(str(path))
        for name in ("k1_max_padding", "k1_max_points", "k1_max_blocks"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = _I
        lib.k1_params_bytes.argtypes = []
        lib.k1_params_bytes.restype = ctypes.c_size_t
        lib.k1_smem_bytes.argtypes = [_I]
        lib.k1_smem_bytes.restype = ctypes.c_size_t
        lib.k1_init.argtypes = [ctypes.POINTER(_I)]
        lib.k1_init.restype = _I
        lib.k1_error_string.argtypes = [_I]
        lib.k1_error_string.restype = ctypes.c_char_p
        lib.k1_label_and_columns.argtypes = [_P] * 5 + [_I, _I, _P, _P]
        lib.k1_label_and_columns.restype = _I
        if lib.k1_params_bytes() != ctypes.sizeof(_Params):
            raise RuntimeError("K1: Params layout differs from the kernel's")
        if (lib.k1_max_padding(), lib.k1_max_blocks()) != (MAX_PADDING,
                                                           MAX_BLOCKS):
            raise RuntimeError("K1: limits differ from the kernel's")
        self.max_points = lib.k1_max_points()
        self.lib = lib
        self.launch = lib.k1_label_and_columns
        self.smem_limit: dict[int, int] = {}  # per device
        self._smem: dict[int, int] = {}       # per ring width

    def error(self, err: int) -> str:
        return f"CUDA error {err} ({self.lib.k1_error_string(err).decode()})"

    def ready(self, device: int) -> int:
        """Set the kernel up on ``device`` (the current one) once;
        returns the device's opt-in shared-memory limit."""
        limit = self.smem_limit.get(device)
        if limit is None:
            v = _I(0)
            err = self.lib.k1_init(ctypes.byref(v))
            if err != 0:
                raise RuntimeError(f"K1 init failed: {self.error(err)}")
            limit = self.smem_limit[device] = v.value
        return limit

    def smem_bytes(self, P: int) -> int:
        v = self._smem.get(P)
        if v is None:
            v = self._smem[P] = self.lib.k1_smem_bytes(P)
        return v


@functools.lru_cache(maxsize=None)
def load() -> _Library:
    """Build (if needed) and load K1's library once per process."""
    return _Library(build())


def _f32(v: float) -> float:
    """A Python float rounded to float32, the way JAX and torch round a
    Python scalar compared against a float32 array."""
    return float(np.float32(v))


@functools.lru_cache(maxsize=64)
def _params(cfg: ExtractionConfig, surface_leaf: float, ce: int,
            cs: int) -> _Params:
    if not 0 <= cfg.padding <= MAX_PADDING:
        raise ValueError(f"K1: padding must be in [0, {MAX_PADDING}] (its "
                         f"window masks are 2 * padding bits), got "
                         f"{cfg.padding}")
    if not 0 < cfg.n_blocks <= MAX_BLOCKS or cfg.nms_rounds < 0:
        raise ValueError(f"K1: needs 0 < n_blocks <= {MAX_BLOCKS} and "
                         f"nms_rounds >= 0")
    if ce < 0 or cs <= 0:
        raise ValueError("K1: needs ce >= 0 and cs > 0")
    return _Params(
        cfg.padding, cfg.n_blocks, cfg.nms_rounds, ce, cs,
        _f32(math.cos(cfg.radian_threshold)), _f32(cfg.edge_threshold),
        _f32(cfg.surface_threshold), _f32(cfg.distance_diff_threshold),
        _f32(cfg.min_range), _f32(cfg.max_range),
        _f32(cfg.parallel_beam_min_range_ratio), _f32(surface_leaf))


def label_and_columns_cuda(x: torch.Tensor, y: torch.Tensor,
                           z: torch.Tensor, count: torch.Tensor,
                           cfg: ExtractionConfig, surface_leaf: float,
                           ce: int, cs: int):
    """Launch K1 on [R, P] float32 CUDA planes x, y, z and count [R].
    Returns (labels [R, P] int32, curvature [R, P] float32,
    col [R, P] int32), the three planes of one allocation, on the current
    stream, without synchronising. Each launch adds one to
    ``label_and_columns_cuda.launches``."""
    dev = x.device
    for name, t in (("x", x), ("y", y), ("z", z)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"K1: {name} must be a contiguous 2-D float32 "
                             f"tensor on x's device, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"K1: needs CUDA tensors, got {dev}")
    R, P = x.shape
    if y.shape != x.shape or z.shape != x.shape:
        raise ValueError("K1: x, y and z must have one shape")
    lib = load()
    if not 0 < P <= lib.max_points or R == 0:
        raise ValueError(f"K1: needs 0 < P <= {lib.max_points} points per "
                         f"ring and R > 0, got {tuple(x.shape)}")
    if count.shape != (R,):
        raise ValueError(f"K1: count must be [{R}], got {tuple(count.shape)}")
    if count.dtype != torch.int32 or count.device != dev:
        count = count.to(device=dev, dtype=torch.int32)
    params = _params(cfg, surface_leaf, ce, cs)

    index = dev.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return label_and_columns_cuda(x, y, z, count, cfg, surface_leaf,
                                          ce, cs)
    limit = lib.ready(index)
    smem = lib.smem_bytes(P)
    if smem > limit:
        raise ValueError(f"K1: a ring of {P} points needs {smem} bytes of "
                         f"shared memory; the device allows {limit}")
    out = torch.empty((3, R, P), dtype=torch.int32, device=dev)
    err = lib.launch(x.data_ptr(), y.data_ptr(), z.data_ptr(),
                     count.contiguous().data_ptr(), out.data_ptr(), R, P,
                     ctypes.byref(params),
                     torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"K1 launch failed: {lib.error(err)}")
    label_and_columns_cuda.launches += 1
    return out[0], out[1].view(torch.float32), out[2]


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

