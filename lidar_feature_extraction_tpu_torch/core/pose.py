"""SE(3) pose as a (quaternion, translation) pair of tensors.

Port of ``lidar_feature_extraction_tpu/core/pose.py``.
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

    def apply_each(self, p: torch.Tensor) -> torch.Tensor:
        """Transform each scan's points [..., N, 3] by its own pose
        (q [..., 4], t [..., 3]): one pose and its scan, or one pose per
        scan of a batch."""
        return quat.quat_rotate(self.q[..., None, :], p) + self.t[..., None, :]

    def apply_fma(self, p: torch.Tensor) -> torch.Tensor:
        """``apply`` with ``quat_rotate_fma``: the points of the
        registration's residual rows and queries, as the reference's
        jitted code computes them."""
        return quat.quat_rotate_fma(self.q, p) + self.t

    def apply_each_fma(self, p: torch.Tensor) -> torch.Tensor:
        """``apply_each`` with ``quat_rotate_fma`` (``apply_fma``)."""
        return Pose(self.q[..., None, :], self.t[..., None, :]).apply_fma(p)

    def compose(self, other: "Pose") -> "Pose":
        """``self @ other``: first apply ``other``, then ``self``."""
        return Pose(
            quat.quat_normalize(quat.quat_multiply(self.q, other.q)),
            quat.quat_rotate(self.q, other.t) + self.t,
        )

    def inverse(self) -> "Pose":
        qinv = quat.quat_conjugate(self.q)
        return Pose(qinv, -quat.quat_rotate(qinv, self.t))

    def matrix(self) -> torch.Tensor:
        """Homogeneous 4x4 matrix [..., 4, 4]."""
        r = quat.quat_to_matrix(self.q)
        top = torch.cat([r, self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(
                                  top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    @staticmethod
    def from_matrix(m: torch.Tensor) -> "Pose":
        return Pose(quat.matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])


def pose_delta_magnitudes(a: Pose, b: Pose):
    """(translation delta norm, quaternion vec-part norm) of ``a^-1 b``,
    the keyframe gate's measure (``map.hpp:49-59``)."""
    d = a.inverse().compose(b)
    dq = d.q * torch.where(d.q[..., :1] < 0, -1.0, 1.0)
    return (torch.linalg.vector_norm(d.t, dim=-1),
            torch.linalg.vector_norm(dq[..., 1:], dim=-1))
