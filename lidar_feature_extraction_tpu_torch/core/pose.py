"""SE(3) pose as a (quaternion, translation) pair of tensors.

Port of ``lidar_feature_extraction_tpu/core/pose.py`` (``identity`` and
``apply``, the parts the localization step uses).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_feature_extraction_tpu_torch.core import quaternion as quat


class Pose(NamedTuple):
    """Rigid transform: ``apply(p) = R(q) p + t``. q is wxyz [..., 4]."""

    q: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(dtype=torch.float32, device="cuda") -> "Pose":
        return Pose(quat.quat_identity(dtype, device),
                    torch.zeros(3, dtype=dtype, device=device))

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        """Transform points [..., 3]."""
        return quat.quat_rotate(self.q, p) + self.t
