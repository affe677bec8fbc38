"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*).

Each test feeds the same seeded float32 numpy inputs to the JAX
reference and to the port and compares the results as numpy arrays.
JAX runs on the CPU, and the suite runs with ``jax_enable_x64`` on
(test_extraction turns it on at import), so inputs are cast to float32
explicitly on both sides and reference outputs are cast before
comparing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch import config as tcfg

torch.set_num_threads(2)


def np32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def to_np(a) -> np.ndarray:
    """A torch tensor, JAX array or numpy array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def t32(a) -> torch.Tensor:
    return torch.as_tensor(np32(a))


def port_config(cfg) -> tcfg.PipelineConfig:
    """The port's copy of a reference PipelineConfig, field for field."""
    d = dataclasses.asdict(cfg)
    reg = d["registration"]
    reg["edge_map"] = tcfg.VoxelMapConfig(**reg["edge_map"])
    reg["surface_map"] = tcfg.VoxelMapConfig(**reg["surface_map"])
    return tcfg.PipelineConfig(
        compact_extraction=d["compact_extraction"],
        extraction=tcfg.ExtractionConfig(**d["extraction"]),
        registration=tcfg.RegistrationConfig(**reg),
        ekf=tcfg.EkfConfig(**d["ekf"]),
        mapping=tcfg.MappingConfig(**d["mapping"]),
        parallel=tcfg.ParallelConfig(**d["parallel"]))


def scatter_rows_case(width: int, seed: int = 3):
    """(out, index, src) with many rows per destination and values over
    ten decades, so the order of each destination's adds shows in its
    bits; and the rows added one at a time in ``src``'s order."""
    rng = np.random.default_rng(seed)
    n, d = 400, 7
    index = rng.integers(0, d, n)
    src = np32(rng.normal(size=(n, width))
               * 10.0 ** rng.uniform(-5, 5, (n, 1)))
    out = np32(rng.normal(size=(d, width)))
    want = out.copy()
    for k in range(n):
        want[index[k]] = want[index[k]] + src[k]
    return out, index, src, want
