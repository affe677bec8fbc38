"""Pipeline assembly: resolve a configuration, load the maps, build the
localization, mapping or odometry pipeline.

Port of ``lidar_feature_extraction_tpu/pipeline/launch.py``. The
reference's ROS launch graphs become constructors: a preset plus file
and dict overlays (the role of the reference's parameter YAML), the
edge and surface PCD maps loaded into device grids, and the assembled
pipeline object. Every constructor builds on the CUDA card unless the
caller passes another ``device``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping, Optional

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch import config as config_mod
from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.io.pcd import load_pcd

PRESETS = {
    "default": PipelineConfig,
    "kitti_hdl64": config_mod.kitti_hdl64,
    "vlp16": config_mod.vlp16,
}


def _replace_nested(obj, overrides: Mapping[str, Any]):
    """``dataclasses.replace`` through nested frozen dataclasses:
    ``{"extraction": {"padding": 2}, ...}``. An unknown key raises."""
    updates = {}
    for key, value in overrides.items():
        if not hasattr(obj, key):
            raise KeyError(f"unknown config field: {key!r} "
                           f"on {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _replace_nested(current, value)
        else:
            updates[key] = value
    return dataclasses.replace(obj, **updates)


def load_config(preset: str = "default",
                overrides: Optional[Mapping[str, Any]] = None,
                params_file: Optional[str] = None) -> PipelineConfig:
    """Resolve a PipelineConfig: preset, then the params file, then the
    dict overrides. ``params_file`` is JSON, or YAML when ``yaml``
    imports."""
    if preset not in PRESETS:
        raise KeyError(f"unknown preset {preset!r}; "
                       f"have {sorted(PRESETS)}")
    cfg = PRESETS[preset]()
    if params_file is not None:
        with open(params_file) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            try:
                import yaml
            except ImportError as e:
                raise ValueError(
                    f"{params_file} is not JSON and pyyaml is "
                    "unavailable") from e
            data = yaml.safe_load(text)
        cfg = _replace_nested(cfg, data)
    if overrides:
        cfg = _replace_nested(cfg, overrides)
    return cfg


def load_maps(edge_pcd: str, surface_pcd: str, cfg: PipelineConfig,
              geometry: bool = True, device="cuda"):
    """Edge and surface feature maps from PCD files, built on
    ``device``: per-voxel line and plane fits (``GeometryMaps``, the
    production path) or, with ``geometry=False``, point grids
    (``FeatureMaps``)."""
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        build_feature_maps, build_geometry_maps)

    def cloud(path):
        pts = torch.as_tensor(np.asarray(load_pcd(path), np.float32),
                              device=device)
        return pts, torch.ones(len(pts), dtype=torch.bool, device=device)

    build = build_geometry_maps if geometry else build_feature_maps
    return build(*cloud(edge_pcd), *cloud(surface_pcd), cfg)


def launch_localization(edge_pcd: str, surface_pcd: str,
                        cfg: Optional[PipelineConfig] = None,
                        initial_pose: Optional[Pose] = None,
                        geometry: bool = True, device="cuda"):
    """The localization workload: maps, extraction, registration and the
    EKF feedback loop (``FusedLocalizationPipeline``)."""
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        FusedLocalizationPipeline)

    cfg = cfg or PipelineConfig()
    maps = load_maps(edge_pcd, surface_pcd, cfg, geometry=geometry,
                     device=device)
    return FusedLocalizationPipeline(maps, cfg, initial_pose=initial_pose,
                                     device=device)


def launch_mapping(cfg: Optional[PipelineConfig] = None, device="cuda",
                   **kwargs):
    """The mapping workload: odometry front end, keyframes, loop closure
    and the graph back end (``MappingPipeline``)."""
    from lidar_feature_extraction_tpu_torch.pipeline.slam import (
        MappingPipeline)

    return MappingPipeline(cfg or PipelineConfig(), device=device, **kwargs)


def launch_odometry(cfg: Optional[PipelineConfig] = None, device="cuda"):
    """Scan-to-scan odometry (``Odometry``)."""
    from lidar_feature_extraction_tpu_torch.pipeline.odometry import Odometry

    return Odometry(cfg or PipelineConfig(), device=device)
