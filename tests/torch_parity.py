"""Shared helpers of the PyTorch port's parity tests (tests/test_torch_*).

Each test feeds the same seeded float32 numpy inputs to the JAX
reference and to the port and compares the results as numpy arrays.
JAX runs on the CPU, and the suite runs with ``jax_enable_x64`` on
(test_extraction turns it on at import), so inputs are cast to float32
explicitly on both sides and reference outputs are cast before
comparing.
"""

from __future__ import annotations

import numpy as np
import torch

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
