"""Robust statistics: masked medians, MAD scale, Huber loss and weights.

Port of ``lidar_feature_extraction_tpu/core/stats.py``. Two medians:

- ``masked_median`` / ``masked_mad`` / ``masked_scale``: the exact,
  sort-based median (for an even count the mean of the two middle
  values);
- ``_wide_median`` / ``masked_scale_bisect``: the reference's sort-free
  wide bisection (256 thresholds per round, 3 rounds), which converges
  to the LOWER-middle order statistic. The Gauss-Newton step uses this
  one, as the reference's does.

Everything stays on the input's device: no value is read back to the
host. Every median reduces over the last axis, so leading dimensions are
a batch (one median per lane of a batched Gauss-Newton step).
"""

from __future__ import annotations

import torch

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf

# 1 / norm.ppf(3/4): consistent-estimator factor for MAD -> stddev.
MAD_CONSISTENCY = 1.482602218505602


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``values[mask]`` over the last axis ([..., N] -> [...]):
    the middle value for an odd count, the mean of the two middle values
    for an even one, NaN for none. Masked-out values sort to +inf; the
    middle indices come from the valid count."""
    n = torch.sum(mask, dim=-1, dtype=torch.int32)
    s = torch.sort(torch.where(mask, values, float("inf")), dim=-1).values
    # Odd n: element (n-1)/2 twice. Even n: elements n/2-1 and n/2.
    lo = torch.clamp_min((n - 1) // 2, 0)
    hi = torch.where(n % 2 == 1, lo,
                     torch.clamp(n // 2, 0, values.shape[-1] - 1))

    def at(i):
        return torch.gather(s, -1, i[..., None].to(torch.int64))[..., 0]

    med = 0.5 * (at(lo) + at(hi))
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))


def masked_mad(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median absolute deviation of ``values[mask]`` over the last axis."""
    med = masked_median(values, mask)
    return masked_median(torch.abs(values - med[..., None]), mask)


def masked_scale(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Robust scale ``1.4826 * MAD`` over the last axis."""
    return MAD_CONSISTENCY * masked_mad(values, mask)


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
        # lo + w * k, fused as the reference's jitted code fuses it
        # (ROADMAP §C20)
        t = xf.fma(w[..., None], steps, lo[..., None])     # [..., branch]
        below = torch.sum((values[..., :, None] <= t[..., None, :])
                          & below_ok, dim=-2, dtype=torch.int32)
        j = torch.clamp_max(torch.sum(below < half[..., None], dim=-1,
                                      dtype=torch.int32),
                            branch - 1).to(dtype)
        lo, hi = xf.fma(w, j, lo), xf.fma(w, j + 1, lo)
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


def huber(e: torch.Tensor, k: float = 1.345) -> torch.Tensor:
    """Huber loss of a squared error ``e``: ``e`` below the elbow k^2,
    ``2 k sqrt(e) - k^2`` above."""
    sqrt_e = torch.sqrt(torch.clamp_min(e, 0.0))
    return torch.where(e < k * k, e, 2.0 * k * sqrt_e - k * k)


def huber_derivative(e: torch.Tensor, k: float = 1.345) -> torch.Tensor:
    """IRLS weight d/de Huber(e) for squared error ``e``: 1 below the
    elbow, ``k / sqrt(e)`` above; in float32 ``k * rsqrt(e)`` as the
    reference's jitted code computes it (``_xla_f32.rsqrt``)."""
    safe = torch.clamp_min(e, k * k)
    above = (k * xf.rsqrt(safe) if e.dtype == torch.float32
             else k / torch.sqrt(safe))
    return torch.where(e < k * k, torch.ones_like(e), above)
