"""``fma_f32`` on CUDA: a float32 fused multiply-add in one launch.

The port computes the float32 expressions that the JAX package's jitted
code contracts into fused multiply-adds (ROADMAP §C18-§C20) with
``core/_xla_f32.py::fma``. On CPU tensors that is its plain version,
``_xla_f32._fma_plain`` (float64 with round-to-odd, about 21 elementwise
launches); on CUDA float32 tensors it is this kernel,
``csrc/fma_f32.cu`` (``__fmaf_rn``, ``sm_90a``): one launch, the
operands read through the strides of their broadcast views. Both round
once, so they give the same bits.

The kernel is bound to PyTorch as the operator ``lidar_port::fma_f32``
(``csrc/fma_f32_op.cpp``, registered for CUDA tensors only), so a call
costs one dispatcher call. ``build`` compiles both files into one library
with ``nvcc`` against the installed torch's headers and libraries (at
first use, into ``build/kernels/``, named by a hash of the sources, flags
and torch version); ``load`` loads it with ``torch.ops.load_library``. A
failed build or launch raises. Nothing is compiled or loaded at import
time.
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import torch

from lidar_feature_extraction_tpu_torch.ops.extraction_cuda import (
    build_library)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "fma_f32.cu", CSRC / "fma_f32_op.cpp")


def _flags() -> tuple:
    """nvcc's flags: the kernel's (``sm_90a``, no contraction of the
    device code's own arithmetic) and those of a library that links
    against the installed torch (its C++ standard and ABI)."""
    root = os.path.dirname(torch.__file__)
    lib = os.path.join(root, "lib")
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++20", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
            f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
            "-isystem", os.path.join(root, "include"),
            "-L", lib, "-lc10", "-lc10_cuda", "-ltorch_cpu", "-ltorch",
            "-Xlinker", f"-rpath={lib}")


def build() -> Path:
    """Compile ``fma_f32`` and its operator unless they are built;
    returns the library."""
    return build_library(SOURCES, _flags(), "fma_f32", key=torch.__version__)


@functools.lru_cache(maxsize=None)
def load():
    """Build (if needed) and load the library once per process; returns
    the operator's one overload (called directly, not through the
    overload packet)."""
    torch.ops.load_library(str(build()))
    return torch.ops.lidar_port.fma_f32.default


def fma_f32_cuda(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, on CUDA float32 tensors of shapes that
    broadcast (``a`` may be a Python float). Returns a new contiguous
    tensor of the broadcast shape, on the current stream, without
    synchronising. Each launch adds one to ``fma_f32_cuda.launches`` and,
    while ``fma_f32_cuda.sizes`` is a dict, one to its entry for the
    launch's element count."""
    if not b.is_cuda:
        raise ValueError(f"fma_f32: needs CUDA tensors, got {b.device}")
    if isinstance(a, torch.Tensor):
        out = load()(a, 0.0, b, c)
    else:
        out = load()(None, float(a), b, c)
    n = out.numel()
    if n:
        fma_f32_cuda.launches += 1
        sizes = fma_f32_cuda.sizes
        if sizes is not None:
            sizes[n] = sizes.get(n, 0) + 1
    return out


fma_f32_cuda.launches = 0
fma_f32_cuda.sizes = None
