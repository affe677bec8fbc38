"""Batched scan localization, on one device or sharded over a mesh.

Port of ``lidar_feature_extraction_tpu/parallel/distributed.py``. The
reference's ``make_batched_localizer`` is ``jax.vmap(localize_scan)``
over B scans with the maps shared, the batch sharded over a device
mesh. Here the batch is an explicit leading dimension on a device
(``pipeline/localization.py::localize_scans``), on every branch of
``localize_scan`` (compact or full extraction, ``GeometryMaps`` or
``FeatureMaps``): one K1 launch labels every ring of the batch, and one
Gauss-Newton loop registers every scan in lock-step, each scan getting
the result it would get alone. It serves the independent scans of
several vehicles, or of offline mapping shards.

Over a mesh (``parallel/mesh.py``) each rank registers its contiguous
shard of the batch the same way on its own device, with the maps
replicated: one K1 launch per rank per batch, and nothing to reduce, so
a rank's lanes are the ones it would register alone.
``multihost.gather_to_host`` assembles the whole batch's results where a
caller needs them.
"""

from __future__ import annotations

import torch

from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.core.scan import RangeImage
from lidar_feature_extraction_tpu_torch.parallel.mesh import (
    Mesh, shard_batch)
from lidar_feature_extraction_tpu_torch.pipeline.localization import (
    localize_scans)


def _on(t: torch.Tensor, device: torch.device) -> bool:
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def make_batched_localizer(cfg: PipelineConfig, device=None,
                           mesh: Mesh | None = None):
    """Returns ``run(maps, images[B], priors[B]) -> (results[B],
    feats[B])`` on ``device`` (the CUDA card unless the caller passes
    another): the images and priors are moved there, the maps must
    already be there (they are built once, on the device that
    registers against them).

    With ``mesh`` the device is the mesh's, B must be a multiple of the
    mesh size, every rank calls ``run`` with the whole batch and gets
    the results of its shard, lanes ``rank * B / size`` onwards."""
    if mesh is not None:
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"make_batched_localizer: device {device} is "
                             f"not the mesh's {mesh.device}")
        device = mesh.device
    device = torch.device("cuda" if device is None else device)

    def run(maps, images: RangeImage, priors: Pose):
        if mesh is not None:
            images, priors = shard_batch(mesh, (images, priors))
        images = RangeImage(*(a.to(device) for a in images))
        priors = Pose(priors.q.to(device), priors.t.to(device))
        table = maps.edge[0]   # the edge grid's records or points
        if not _on(table, device):
            raise ValueError(f"make_batched_localizer: the maps are on "
                             f"{table.device}, the localizer on {device}")
        return localize_scans(maps, images, priors, cfg)

    return run
