"""Batched scan localization on one device.

Port of ``lidar_feature_extraction_tpu/parallel/distributed.py``. The
reference's ``make_batched_localizer`` is ``jax.vmap(localize_scan)``
over B scans with the maps shared, the batch sharded over a device
mesh. Here the batch is an explicit leading dimension on one card
(``pipeline/localization.py::localize_scans``), on every branch of
``localize_scan`` (compact or full extraction, ``GeometryMaps`` or
``FeatureMaps``): one K1 launch labels every ring of the batch, and one
Gauss-Newton loop registers every scan in lock-step, each scan getting
the result it would get alone. It serves the independent scans of
several vehicles, or of offline mapping shards.

The mesh has no counterpart on one card; batching over several cards
with ``torch.distributed`` is ROADMAP.md item 12.4.
"""

from __future__ import annotations

import torch

from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.core.scan import RangeImage
from lidar_feature_extraction_tpu_torch.pipeline.localization import (
    localize_scans)


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def make_batched_localizer(cfg: PipelineConfig, device=None):
    """Returns ``run(maps, images[B], priors[B]) -> (results[B],
    feats[B])`` on ``device`` (the CUDA card unless the caller passes
    another): the images and priors are moved there, the maps must
    already be there (they are built once, on the device that
    registers against them)."""
    device = torch.device("cuda" if device is None else device)

    def run(maps, images: RangeImage, priors: Pose):
        images = RangeImage(*(a.to(device) for a in images))
        priors = Pose(priors.q.to(device), priors.t.to(device))
        table = maps.edge[0]   # the edge grid's records or points
        if not _on(table, device):
            raise ValueError(f"make_batched_localizer: the maps are on "
                             f"{table.device}, the localizer on {device}")
        return localize_scans(maps, images, priors, cfg)

    return run
