"""Robust statistics: masked wide-bisection median, MAD scale, Huber
weights.

Port of ``lidar_feature_extraction_tpu/core/stats.py:84-143``. The median
keeps the reference's sort-free wide bisection (256 thresholds per round,
3 rounds), which converges to the LOWER-middle order statistic, so the
scale matches the reference rather than an exact sort. Everything stays
on the input's device: no value is read back to the host. Both medians
reduce over the last axis, so leading dimensions are a batch (one median
per lane of a batched Gauss-Newton step).
"""

from __future__ import annotations

import torch

# 1 / norm.ppf(3/4): consistent-estimator factor for MAD -> stddev.
MAD_CONSISTENCY = 1.482602218505602


def _wide_median(values: torch.Tensor, mask: torch.Tensor,
                 branch: int = 256, rounds: int = 3) -> torch.Tensor:
    """Lower-middle median of ``values[mask]`` over the last axis
    ([..., N] -> [...]) by wide value-range bisection: each round counts
    the values below ``branch`` thresholds at once and narrows the
    interval ``branch``-fold."""
    dtype = values.dtype
    big = torch.finfo(dtype).max
    n = torch.sum(mask, dim=-1, dtype=torch.int32)
    half = (n + 1) // 2  # rank of the lower middle element
    lo = torch.amin(torch.where(mask, values, big), dim=-1)
    hi = torch.amax(torch.where(mask, values, -big), dim=-1)

    steps = torch.arange(1, branch + 1, dtype=dtype, device=values.device)
    below_ok = mask[..., :, None]
    for _ in range(rounds):
        w = (hi - lo) / branch
        t = lo[..., None] + w[..., None] * steps            # [..., branch]
        below = torch.sum((values[..., :, None] <= t[..., None, :])
                          & below_ok, dim=-2, dtype=torch.int32)
        j = torch.clamp_max(torch.sum(below < half[..., None], dim=-1,
                                      dtype=torch.int32),
                            branch - 1).to(dtype)
        lo, hi = lo + w * j, lo + w * (j + 1)
    med = 0.5 * (lo + hi)
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def masked_scale_bisect(values: torch.Tensor, mask: torch.Tensor,
                        iters: int = 30) -> torch.Tensor:
    """Sort-free ``1.4826 * MAD`` over the last axis via two
    wide-bisection medians. ``iters`` is kept for the reference's
    signature and unused."""
    del iters
    med = _wide_median(values, mask)
    return MAD_CONSISTENCY * _wide_median(torch.abs(values - med[..., None]),
                                          mask)


def huber_derivative(e: torch.Tensor, k: float = 1.345) -> torch.Tensor:
    """IRLS weight d/de Huber(e) for squared error ``e``: 1 below the
    elbow, ``k / sqrt(e)`` above."""
    safe = torch.clamp_min(e, k * k)
    return torch.where(e < k * k, torch.ones_like(e), k / torch.sqrt(safe))
