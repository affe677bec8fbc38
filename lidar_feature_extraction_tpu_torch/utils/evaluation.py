"""Trajectory evaluation: ATE-RMSE with optional SE(3)/Sim(3) alignment.

A copy of ``lidar_feature_extraction_tpu/utils/evaluation.py`` (numpy
only), which the port cannot import.

The reference repo ships no evaluation tooling (SURVEY.md §6); the
BASELINE.json targets are ATE parity on KITTI 00/05, so the evaluator is
a first-class component here. Conventions follow the standard KITTI /
evo ATE definition: align estimated positions to ground truth with the
Umeyama closed-form, then RMSE over translation errors.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares rigid (or similarity) transform src -> dst.

    src, dst: [N, 3]. Returns (R [3,3], t [3], s scalar).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    sgn = np.sign(np.linalg.det(u @ vt))
    s_mat = np.diag([1.0, 1.0, sgn])
    r = u @ s_mat @ vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        scale = np.trace(np.diag(d) @ s_mat) / var_s
    else:
        scale = 1.0
    t = mu_d - scale * r @ mu_s
    return r, t, scale


def ate_rmse(estimated: np.ndarray, ground_truth: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE over positions), [N, 3] each."""
    est = np.asarray(estimated, np.float64)
    gt = np.asarray(ground_truth, np.float64)
    assert est.shape == gt.shape
    if align and len(est) >= 3:
        r, t, s = umeyama_alignment(est, gt)
        est = (s * (r @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=-1).mean()))


def relative_translation_errors(poses_est: np.ndarray,
                                poses_gt: np.ndarray,
                                delta: int = 1) -> np.ndarray:
    """Per-step drift: || (est_i -> est_{i+d}) - (gt_i -> gt_{i+d}) ||."""
    e = np.asarray(poses_est)
    g = np.asarray(poses_gt)
    de = e[delta:] - e[:-delta]
    dg = g[delta:] - g[:-delta]
    return np.linalg.norm(de - dg, axis=-1)
