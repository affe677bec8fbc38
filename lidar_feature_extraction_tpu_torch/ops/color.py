"""Debug colouring: RGB per point label or per scalar value.

Port of ``lidar_feature_extraction_tpu/ops/color.py``: the reference's
coloured debug cloud of the extraction. Colours are table lookups,
[..., 3] uint8 on the labels' device.
"""

from __future__ import annotations

import torch

# Label -> RGB table (order matches the PointLabel codes).
_LABEL_COLORS = (
    (120, 120, 120),   # Default: gray
    (255, 64, 64),     # Edge: red
    (255, 160, 160),   # EdgeNeighbor: light red
    (64, 96, 255),     # Surface: blue
    (160, 180, 255),   # SurfaceNeighbor: light blue
    (40, 40, 40),      # OutOfRange: near-black
    (255, 200, 0),     # Occluded: amber
    (0, 200, 120),     # ParallelBeam: green
)


def color_by_label(labels: torch.Tensor) -> torch.Tensor:
    """PointLabel codes [...] -> RGB [..., 3] uint8."""
    table = torch.tensor(_LABEL_COLORS, dtype=torch.uint8,
                         device=labels.device)
    safe = torch.clamp(labels, 0, len(_LABEL_COLORS) - 1).to(torch.int64)
    return table[safe]


def color_by_value(values: torch.Tensor, vmin=None, vmax=None
                   ) -> torch.Tensor:
    """Scalar field -> blue-to-red ramp, [..., 3] uint8; the range is
    the values' own unless ``vmin`` / ``vmax`` are given."""
    v = values.to(torch.float32)
    lo = torch.min(v) if vmin is None else vmin
    hi = torch.max(v) if vmax is None else vmax
    span = torch.clamp_min(torch.as_tensor(hi - lo, dtype=torch.float32,
                                           device=v.device), 1e-12)
    t = torch.clamp((v - lo) / span, 0.0, 1.0)
    r = (255 * t).to(torch.uint8)
    b = (255 * (1.0 - t)).to(torch.uint8)
    g = (255 * (1.0 - torch.abs(2 * t - 1))).to(torch.uint8)
    return torch.stack([r, g, b], dim=-1)


def labeled_cloud(image_xyz: torch.Tensor, mask: torch.Tensor,
                  labels: torch.Tensor):
    """(xyz [N, 3], rgb [N, 3], valid [N]) flattened debug cloud."""
    rgb = color_by_label(labels)
    return (image_xyz.reshape(-1, 3), rgb.reshape(-1, 3), mask.reshape(-1))
