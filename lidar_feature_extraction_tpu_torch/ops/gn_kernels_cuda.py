"""The fused float32 Gauss-Newton kernels on CUDA: ``robust_weights`` and
``gn_update``, one launch each per iteration.

``ops/gauss_newton.py``'s float32 step needs, from its errors, the valid
count, the error total, the MAD scale and the Huber weights (and, in the
fused loop, the per-block error medians), and from the normal equations
D, A, b the solve, the degeneracy guard and the pose update, with the
bits the JAX package's jitted code gives (ROADMAP §C20, §C21). On CPU
tensors the plain versions ``stats.robust_weights_plain`` and
``_xla_dot.gn_update_plain`` run (the port's float32 forms, ~360 and
~570 small launches per iteration on a card); on CUDA tensors these
kernels, ``csrc/robust_weights.cu`` and ``csrc/gn_update.cu``
(``sm_90a``), each for one problem or a batch in one launch, each lane
as alone. They port no TPU kernel: the reference leaves this arithmetic
to XLA.

The kernels are bound to PyTorch as the operators
``lidar_port::robust_weights`` and ``lidar_port::gn_update``
(``csrc/gn_kernels_op.cpp``, CUDA only). ``build`` compiles the three
files into one library with ``nvcc`` against the installed torch (at
first use, into ``build/kernels/``); ``load`` loads it. ``robust_weights``
reads ``xf.rsqrt``'s estimates from ``rsqrt_table``, which the wrapper
copies to each device once (the library's ``robust_weights_set_table``).
A failed build or launch raises. Nothing is compiled or loaded at import
time.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.ops import fma_cuda
from lidar_feature_extraction_tpu_torch.ops.extraction_cuda import (
    build_library)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "robust_weights.cu", CSRC / "gn_update.cu",
           CSRC / "gn_kernels_op.cpp")


def build() -> Path:
    """Compile the kernels and their operators unless they are built;
    returns the library (``fma_cuda``'s flags: ``sm_90a``, no
    contraction, linked against the installed torch)."""
    return build_library(SOURCES, fma_cuda._flags(), "gn_kernels",
                         key=torch.__version__)


@functools.lru_cache(maxsize=None)
def load():
    """Build (if needed) and load the library once per process; returns
    the operators' namespace."""
    torch.ops.load_library(str(build()))
    return torch.ops.lidar_port


def rsqrt_table() -> np.ndarray:
    """``xf.rsqrt``'s 12-bit estimate for each of its 2,048 input classes,
    indexed by the exponent's parity (bit 10) and the top ten mantissa
    bits, as uint16: ``round(8192 / sqrt(mid) - 4096)`` in float64 at the
    class's midpoint ``mid`` scaled to [1, 4), as ``core/_xla_f32.py``'s
    ``rsqrt`` computes it."""
    index = np.arange(2048)
    mid = (1.0 + ((index & 0x3FF) + 0.5) / 1024.0) \
        * np.where(index >> 10 == 1, 1.0, 2.0)
    return np.rint(8192.0 / np.sqrt(mid) - 4096.0).astype(np.uint16)


_TABLE_DEVICES: set = set()


@functools.lru_cache(maxsize=None)
def _c_library():
    """The loaded library's C functions (ctypes)."""
    load()
    lib = ctypes.CDLL(str(build()))  # the library load() loaded
    lib.robust_weights_set_table.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.robust_weights_set_table.restype = ctypes.c_int
    lib.robust_weights_cluster_size.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.robust_weights_cluster_size.restype = ctypes.c_int
    return lib


def cluster_size(batch: int, tasks: int) -> int:
    """The CTAs ``robust_weights`` gives each of ``tasks`` tasks of
    ``batch`` lanes (1 + the residual blocks with the block medians)."""
    return _c_library().robust_weights_cluster_size(batch, tasks)


def _set_table(device: torch.device) -> None:
    """Copies ``rsqrt_table`` to ``device``; the wrapper calls it once per
    device and process (the kernel refuses to launch on a device without
    the table)."""
    table = rsqrt_table()
    with torch.cuda.device(device):
        err = _c_library().robust_weights_set_table(table.ctypes.data,
                                                    table.size)
    if err:
        raise RuntimeError(f"robust_weights: the rsqrt table was not "
                           f"copied to {device}: CUDA error {err}")
    _TABLE_DEVICES.add(device.index)


def robust_weights_cuda(errors: torch.Tensor, valid: torch.Tensor,
                        shape: tuple, huber_k: float = 1.345,
                        with_block_medians: bool = False):
    """``(n_valid, error, scale, weights, block_meds)`` of CUDA float32
    ``errors`` [N] or [B, N] under bool ``valid`` of the same shape, the
    residual blocks ``shape`` (``((N_b, D_b), ...)``) giving the block
    medians when ``with_block_medians`` (else None), on the current
    stream, without synchronising. Each launch adds one to
    ``robust_weights_cuda.launches``."""
    if not errors.is_cuda:
        raise ValueError(f"robust_weights: needs CUDA tensors, got "
                         f"{errors.device}")
    if errors.device.index not in _TABLE_DEVICES:
        _set_table(errors.device)
    n_valid, error, scale, weights, meds = load().robust_weights(
        errors, valid, [n for n, _ in shape], float(huber_k),
        with_block_medians)
    if errors.numel():
        robust_weights_cuda.launches += 1
    return (n_valid, error, scale, weights,
            meds if with_block_medians else None)


def gn_update_cuda(D: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                   q: torch.Tensor, t: torch.Tensor, tau: float):
    """``(q_new, t_new, H, dq_norm, dt_norm)`` of CUDA float32 normal
    equations D, A [..., 7, 7], b [..., 7] at the pose q [..., 4], t
    [..., 3] (no batch or one of B lanes; any strides), on the current
    stream, without synchronising. Each launch adds one to
    ``gn_update_cuda.launches``."""
    if not D.is_cuda:
        raise ValueError(f"gn_update: needs CUDA tensors, got {D.device}")
    out = load().gn_update(D, A, b, q, t, float(tau))
    if D.numel():
        gn_update_cuda.launches += 1
    return out


robust_weights_cuda.launches = 0
gn_update_cuda.launches = 0
