"""``normal_equations`` on CUDA: the float32 Gauss-Newton normal equations
in XLA:CPU's summation order, one launch.

``weighted_update`` (``ops/gauss_newton.py``) needs D = jv^T j,
A = jw^T j and b = j^T wr of float32 problems with the bits the JAX
package's jitted code gives (ROADMAP §C21); ``core/_xla_dot.py`` says in
what order XLA:CPU sums them. On CPU tensors the plain version
``_xla_dot.normal_equations_plain`` runs; on CUDA tensors this kernel,
``csrc/normal_equations.cu`` (``sm_90a``), for one problem [M, 7] or a
batch [B, M, 7] in one launch, each lane in the lone problem's tree. It
ports no TPU kernel: the reference leaves the products to XLA, and no
library product fixes a summation order.

The kernel is bound to PyTorch as the operator
``lidar_port::normal_equations`` (``csrc/normal_equations_op.cpp``,
CUDA only), beside ``lidar_port::normal_equations_tree``, its tree as a
CPU tensor. ``build`` compiles both files into one library with ``nvcc``
against the installed torch (at first use, into ``build/kernels/``);
``load`` loads it. A failed build or launch raises. Nothing is compiled
or loaded at import time.
"""

from __future__ import annotations

import functools
from pathlib import Path

import torch

from lidar_feature_extraction_tpu_torch.ops import fma_cuda
from lidar_feature_extraction_tpu_torch.ops.extraction_cuda import (
    build_library)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "normal_equations.cu", CSRC / "normal_equations_op.cpp")


def build() -> Path:
    """Compile the kernel and its operators unless they are built;
    returns the library (``fma_cuda``'s flags: ``sm_90a``, no
    contraction, linked against the installed torch)."""
    return build_library(SOURCES, fma_cuda._flags(), "normal_equations",
                         key=torch.__version__)


@functools.lru_cache(maxsize=None)
def load():
    """Build (if needed) and load the library once per process; returns
    the operator."""
    torch.ops.load_library(str(build()))
    return torch.ops.lidar_port.normal_equations


def tree(m: int) -> torch.Tensor:
    """The kernel's chunks of an ``m``-row contraction: int64 [chunks, 3]
    of (first row, end row, block), on the CPU."""
    load()
    return torch.ops.lidar_port.normal_equations_tree(m)


def normal_equations_cuda(jv: torch.Tensor, jw: torch.Tensor,
                          j: torch.Tensor, wr: torch.Tensor):
    """(D [..., 7, 7], A [..., 7, 7], b [..., 7]) of CUDA float32 ``jv``,
    ``jw``, ``j`` [M, 7] or [B, M, 7] and ``wr`` [M] or [B, M], on the
    current stream, without synchronising. Each launch adds one to
    ``normal_equations_cuda.launches``."""
    if not j.is_cuda:
        raise ValueError(f"normal_equations: needs CUDA tensors, got "
                         f"{j.device}")
    out = load()(jv, jw, j, wr)
    if j.numel():
        normal_equations_cuda.launches += 1
    return out


normal_equations_cuda.launches = 0
