"""Correspondence residual blocks.

Port of ``ResidualBlock`` from ``lidar_feature_extraction_tpu/ops/
residuals.py:44``; the kNN residual factories belong to the faithful
registration path, which is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ResidualBlock(NamedTuple):
    """Fixed-shape correspondence set.

    jacobian: [N, D, 7], residual: [N, D], valid: [N] — D=3 for edge,
    D=1 for surface rows.
    """

    jacobian: torch.Tensor
    residual: torch.Tensor
    valid: torch.Tensor
