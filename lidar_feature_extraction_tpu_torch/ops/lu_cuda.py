"""The pose graph's dense float32 solve on CUDA: ``csrc/lu_solve.cu``.

The reference solves the graph's normal equations with
``jnp.linalg.solve``, which XLA:CPU hands to OpenBLAS's ``sgetrf`` and
two ``strsm`` calls. The kernel computes the blocked LU factorization
(``kalman.lu_plan``'s steps: panels on one CTA, the updates to their
right as float32 SIMT tiles over the system's CTAs) and both triangular
solves of each system in one cooperative launch, in the order of the
plain version, ``fusion/kalman.py``'s ``lu_factor`` and ``lu_solve``, and
equals it bit for bit. No library solver (``torch.linalg``, cuSOLVER)
is on this path.

Build: ``nvcc`` (``sm_90a``, ``--fmad=false``) compiles the source into a
shared library with a plain C interface under ``build/kernels/`` at the
first call on a card (``extraction_cuda.build_library``); ``ctypes``
loads it. Nothing is compiled or loaded at import time.

``solve`` dispatches on the device: CPU tensors go to the plain version,
float32 CUDA tensors to the kernel; any other CUDA tensor raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from lidar_feature_extraction_tpu_torch.fusion import kalman
from lidar_feature_extraction_tpu_torch.ops.extraction_cuda import (
    build_library)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "lu_solve.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int


def build() -> Path:
    """Compile the kernel (``build_library``) unless it is built."""
    return build_library(SOURCE, NVCC_FLAGS, "lu_solve")


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the library once per process, and check
    that its constants are the plain version's."""
    lib = ctypes.CDLL(str(build()))
    lib.lu_solve.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.lu_solve.restype = _I
    lib.lu_solve_error_string.argtypes = [_I]
    lib.lu_solve_error_string.restype = ctypes.c_char_p
    for name, want in (("lu_solve_trsm_rows", kalman.TRSM_ROWS),
                       ("lu_solve_gemm_q", kalman.GEMM_Q)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], _I
        if fn() != want:
            raise RuntimeError(f"lu_solve: {name}() differs from kalman's "
                               f"{want}")
    for name in ("lu_solve_max_n", "lu_solve_max_panel"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], _I
    for name in ("lu_solve_grid", "lu_solve_workspace_floats"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [_I], _I
    return lib


@functools.lru_cache(maxsize=None)
def _plan(n: int, device: torch.device) -> tuple[torch.Tensor, int]:
    """``kalman.lu_plan(n)`` as an int32 [steps, 5] tensor on ``device``
    (uploaded once per order and device) and the floats of a system's
    workspace; raises above the kernel's order or panel width."""
    lib = load()
    if n > lib.lu_solve_max_n():
        raise ValueError(f"lu_solve_cuda: n = {n} above "
                         f"{lib.lu_solve_max_n()}")
    widest = max(s[2] for s in kalman.lu_plan(n) if s[0] == kalman.GETF2)
    if widest > lib.lu_solve_max_panel():
        raise ValueError(f"lu_solve_cuda: a panel of {widest} columns")
    return (torch.tensor(kalman.lu_plan(n), dtype=torch.int32, device=device),
            lib.lu_solve_workspace_floats(n))


@functools.lru_cache(maxsize=None)
def _parts(batch: int, device: torch.device) -> int:
    """CTAs per system (``lu_solve_grid``) on ``device``."""
    with torch.cuda.device(device):
        parts = load().lu_solve_grid(batch)
    if parts <= 0:
        raise ValueError(f"lu_solve_cuda: a batch of {batch} systems does not "
                         "fit one cooperative launch")
    return parts


def lu_solve_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` on the card: a [n, n] or [B, n, n] float32, b
    [n], [n, k] or with the same leading batch; one cooperative launch of
    ``_parts`` CTAs per system. Returns x shaped as b. Counts its launches
    in ``lu_solve_cuda.launches``."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("lu_solve_cuda: CUDA tensors only")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"lu_solve_cuda: float32 only, got {a.dtype} and "
                         f"{b.dtype}")
    if a.dim() not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"lu_solve_cuda: a must be [n, n] or [B, n, n], "
                         f"got {tuple(a.shape)}")
    batched = a.dim() == 3
    n = a.shape[-1]
    vector = b.dim() == a.dim() - 1
    if b.shape[:a.dim() - 1] != a.shape[:-1]:
        raise ValueError(f"lu_solve_cuda: b {tuple(b.shape)} does not fit a "
                         f"{tuple(a.shape)}")
    a3 = a.reshape(-1, n, n).contiguous()
    batch = a3.shape[0]
    rhs = b.reshape(batch, n, -1).contiguous()
    plan, floats = _plan(n, a.device)
    parts = _parts(batch, a.device)
    work = torch.empty((batch, floats), dtype=torch.float32, device=a.device)
    x = torch.empty_like(rhs)
    lib = load()
    with torch.cuda.device(a.device):
        err = lib.lu_solve(a3.data_ptr(), x.data_ptr(), rhs.data_ptr(),
                           plan.data_ptr(), work.data_ptr(), plan.shape[0],
                           batch, n, rhs.shape[-1], parts,
                           torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lu_solve_cuda: CUDA error {err} "
                           f"({lib.lu_solve_error_string(err).decode()})")
    lu_solve_cuda.launches += 1
    out = x if batched else x[0]
    return out[..., 0] if vector else out


lu_solve_cuda.launches = 0


def lu_solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version, on any device: ``kalman.lu_factor``
    and ``kalman.lu_solve`` of each system."""
    if a.dim() == 2:
        return kalman.lu_solve(*kalman.lu_factor(a), b)
    return torch.stack([kalman.lu_solve(*kalman.lu_factor(ai), bi)
                        for ai, bi in zip(a, b)])


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x = b`` in float32 in the reference's LAPACK order: the kernel
    on a CUDA tensor (``lu_solve_cuda``, which raises on another dtype),
    the plain version on a CPU tensor."""
    if a.is_cuda:
        return lu_solve_cuda(a, b)
    return lu_solve_plain(a, b)
