"""Range-image scan container: a raw scan sorted into a fixed-shape
``[n_rings, max_points_per_ring]`` image.

Port of ``lidar_feature_extraction_tpu/core/scan.py:24-112``: one stable
argsort over a composite (ring, azimuth) key, then a scatter into a
padded image whose extra last row takes the dropped points; and the
per-point XY range.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RangeImage(NamedTuple):
    """Azimuth-sorted, ring-major scan.

    xyz:   [R, P, 3] point coordinates; garbage where ``mask`` is False.
    mask:  [R, P] validity. Valid points are compacted to the front of
           each ring and sorted by ascending atan2(y, x).
    count: [R] number of valid points per ring.

    A batch of B scans has a leading [B] on every field
    (``stack_range_images``).
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    count: torch.Tensor

    @property
    def n_rings(self) -> int:
        return self.xyz.shape[-3]

    @property
    def max_points(self) -> int:
        return self.xyz.shape[-2]


def stack_range_images(images) -> RangeImage:
    """B range images of one shape as one batch: [B, R, P, 3] xyz,
    [B, R, P] mask and [B, R] count."""
    return RangeImage(*(torch.stack(field) for field in zip(*images)))


def build_range_image(
    xyz: torch.Tensor,
    ring: torch.Tensor,
    valid: torch.Tensor,
    n_rings: int,
    max_points_per_ring: int,
    min_points_per_ring: int = 0,
) -> RangeImage:
    """Organize a raw scan ``xyz [N, 3]``, ``ring [N]``, ``valid [N]``
    into a RangeImage."""
    n = xyz.shape[0]
    dev = xyz.device
    azimuth = torch.atan2(xyz[:, 1], xyz[:, 0])  # (-pi, pi]
    ring = torch.clamp(ring, 0, n_rings - 1).to(torch.int64)
    # Invalid points sort to the end, then by ring, then by azimuth.
    # The reference's jnp.argsort is stable; torch's is only on request.
    key = torch.where(valid, ring.to(xyz.dtype) * 8.0 + azimuth,
                      torch.full_like(azimuth, float("inf")))
    order = torch.argsort(key, stable=True)
    sorted_xyz = xyz[order]
    sorted_ring = ring[order]
    sorted_valid = valid[order]

    counts = torch.bincount(
        torch.where(valid, ring, torch.full_like(ring, n_rings)),
        minlength=n_rings + 1)[:n_rings]
    ring_starts = torch.cat([torch.zeros(1, dtype=counts.dtype, device=dev),
                             torch.cumsum(counts, 0)[:-1]])
    pos_in_ring = torch.arange(n, device=dev) - ring_starts[sorted_ring]

    keep = sorted_valid & (pos_in_ring < max_points_per_ring)
    rows = torch.where(keep, sorted_ring, torch.full_like(sorted_ring, n_rings))
    cols = torch.where(keep, pos_in_ring, torch.zeros_like(pos_in_ring))

    # Row n_rings is the dump row of dropped points, cut off below.
    img = torch.zeros((n_rings + 1, max_points_per_ring, 3), dtype=xyz.dtype,
                      device=dev)
    img[rows, cols] = sorted_xyz
    msk = torch.zeros((n_rings + 1, max_points_per_ring), dtype=torch.bool,
                      device=dev)
    msk[rows, cols] = keep

    img = img[:n_rings]
    msk = msk[:n_rings]
    count = torch.clamp_max(counts, max_points_per_ring).to(torch.int32)

    if min_points_per_ring > 0:
        ring_alive = count >= min_points_per_ring
        msk = msk & ring_alive[:, None]
        count = torch.where(ring_alive, count, torch.zeros_like(count))

    return RangeImage(xyz=img, mask=msk, count=count)


def xy_range(image: RangeImage) -> torch.Tensor:
    """Per-point XY-plane range, [..., R, P] (the reference's ``Range``
    is the XY norm, not the 3D norm)."""
    return torch.sqrt(image.xyz[..., 0] ** 2 + image.xyz[..., 1] ** 2)
