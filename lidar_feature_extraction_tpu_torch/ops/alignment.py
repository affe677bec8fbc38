"""Point-to-point alignment problem.

Port of ``lidar_feature_extraction_tpu/ops/alignment.py``: the
reference's ``AlignmentProblem``, residual ``T(p) - y`` with Jacobian
``[DRpDq | I]`` per correspondence, the simplest problem for
``run_gauss_newton`` and a rigid point-set alignment utility.
"""

from __future__ import annotations

import torch

from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
from lidar_feature_extraction_tpu_torch.ops.residuals import ResidualBlock


def alignment_block(src: torch.Tensor, dst: torch.Tensor,
                    valid: torch.Tensor, pose: Pose) -> ResidualBlock:
    """One [N, 3, 7] residual block for ``T(src) - dst``: Jacobian rows
    ``[DRpDq | I_3]``, residual ``R(q) p + t - y``; invalid lanes are
    zeroed so the masked reductions ignore them."""
    n = src.shape[0]
    r = pose.apply(src) - dst                                  # [N, 3]
    dr = quat.drpdq(pose.q.expand(n, 4), src)                  # [N, 3, 4]
    eye = torch.eye(3, dtype=src.dtype, device=src.device).expand(n, 3, 3)
    jac = torch.cat([dr, eye], dim=-1)                         # [N, 3, 7]
    okf = valid[:, None]
    return ResidualBlock(jacobian=torch.where(okf[..., None], jac, 0.0),
                         residual=torch.where(okf, r, 0.0), valid=valid)


def alignment_problem(src: torch.Tensor, dst: torch.Tensor,
                      valid: torch.Tensor):
    """``problem_fn(pose) -> gn.Problem`` over fixed correspondences,
    for ``gn.run_gauss_newton``."""

    def problem_fn(pose: Pose) -> gn.Problem:
        return gn.make_problem([alignment_block(src, dst, valid, pose)])

    return problem_fn


def align_points(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                 initial: Pose, max_iterations: int = 40,
                 convergence_tol: float = 1e-3) -> gn.GNResult:
    """Estimate the rigid transform mapping ``src`` onto ``dst``."""
    return gn.run_gauss_newton(alignment_problem(src, dst, valid),
                               initial, max_iterations=max_iterations,
                               convergence_tol=convergence_tol)
