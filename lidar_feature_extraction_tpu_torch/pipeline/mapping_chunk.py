"""Chunked mapping front end: a block of scans through one extraction,
then odometry scan by scan, then the host's bookkeeping.

Port of ``lidar_feature_extraction_tpu/pipeline/mapping_chunk.py``. The
reference runs a block in one jitted ``lax.scan`` (extract ->
constant-velocity prior -> incremental moment-grid registration ->
window insert, per scan). Here:

- the block's range images ``[B, R, P, 3]`` go through ONE
  ``extract_features`` call: on the card one K1 launch labels every
  ring of the block, where the per-scan pipeline launches K1 once per
  scan; each scan's features are the ones it gets alone (labels ring by
  ring, compaction scan by scan);
- odometry then runs scan by scan (``geometry_odometry_step`` with the
  constant-velocity prior, the reference's ``mapping_chunk.py:89-108``),
  every step functional: the carry the block started from is left as it
  was, so a suspect block can be replayed from it. Nothing is read back
  to the host until the block ends but the Gauss-Newton loop's own stop
  test;
- the host then reads every scan's status and edge fit at once. If any
  scan is suspect (the gate of ``Odometry._check``), the whole block is
  replayed scan by scan through the host ``Odometry`` facade, whose
  re-seed ladder handles it, from the pre-block carry; otherwise the
  block's poses go through ``ingest_odometry_result`` (keyframes, loop
  closure, the back end) and the facade is brought up to the block's
  end, so checkpoints and later replays see the same state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.config import PipelineConfig
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.core.scan import RangeImage
from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
from lidar_feature_extraction_tpu_torch.ops.extraction import (
    extract_features)
from lidar_feature_extraction_tpu_torch.pipeline.odometry import (
    GeometryOdometryState, geometry_odometry_step, init_geometry_odometry)
from lidar_feature_extraction_tpu_torch.pipeline.slam import MappingPipeline


class ChunkCarry(NamedTuple):
    """State threaded between scan blocks."""

    odo: GeometryOdometryState
    prev_q: torch.Tensor   # pose BEFORE the latest update (CV prior)
    prev_t: torch.Tensor


class ChunkOutputs(NamedTuple):
    """Per-scan results of one block ([B, ...] leading axis)."""

    pose_q: torch.Tensor        # [B, 4]
    pose_t: torch.Tensor        # [B, 3]
    status: torch.Tensor        # [B]
    hessian: torch.Tensor       # [B, 6, 6]
    block_errors: torch.Tensor  # [B, n_blocks]
    edge_pts: torch.Tensor      # [B, E, 3] sensor frame
    edge_valid: torch.Tensor    # [B, E]
    surf_pts: torch.Tensor      # [B, S, 3]
    surf_valid: torch.Tensor    # [B, S]


def init_chunk_carry(cfg: PipelineConfig, dtype=torch.float32,
                     device="cuda") -> ChunkCarry:
    odo = init_geometry_odometry(cfg, dtype, device)
    return ChunkCarry(odo=odo, prev_q=odo.pose_q, prev_t=odo.pose_t)


def mapping_chunk_step(carry: ChunkCarry, images: RangeImage,
                       cfg: PipelineConfig):
    """Extraction + constant-velocity-prior odometry for a [B, ...] block
    of range images. Returns the carry after the block and the block's
    ``ChunkOutputs``; ``carry`` is not modified."""
    feats = extract_features(images, cfg.extraction)
    odo, prev_q, prev_t = carry
    results = []
    for s in range(images.xyz.shape[0]):
        # Constant-velocity prior: the previous inter-scan delta composed
        # onto the current pose (at the start prev == cur, so it is the
        # current pose, as the host path's first scans).
        cur = Pose(odo.pose_q, odo.pose_t)
        prior = cur.compose(Pose(prev_q, prev_t).inverse().compose(cur))
        odo2, result = geometry_odometry_step(
            odo, feats.edge_xyz[s], feats.edge_valid[s],
            feats.surface_xyz[s], feats.surface_valid[s], cfg,
            prior_q=prior.q, prior_t=prior.t)
        results.append((odo2.pose_q, odo2.pose_t, result.status,
                        result.hessian, result.block_errors))
        prev_q, prev_t, odo = odo.pose_q, odo.pose_t, odo2
    pose_q, pose_t, status, hessian, block_errors = (
        torch.stack(field) for field in zip(*results))
    return (ChunkCarry(odo=odo, prev_q=prev_q, prev_t=prev_t),
            ChunkOutputs(pose_q=pose_q, pose_t=pose_t, status=status,
                         hessian=hessian, block_errors=block_errors,
                         edge_pts=feats.edge_xyz,
                         edge_valid=feats.edge_valid,
                         surf_pts=feats.surface_xyz,
                         surf_valid=feats.surface_valid))


class ChunkedMappingPipeline(MappingPipeline):
    """``MappingPipeline`` whose front end takes blocks of range images.

    ``process_block(images, stamps)`` registers B scans with one
    extraction, then runs the keyframe / loop-closure / back-end
    bookkeeping on the host. The ``odometry`` facade is kept in step, so
    that a suspect block is replayed through its re-seed ladder and
    checkpoints keep working."""

    def __init__(self, cfg: PipelineConfig, **kwargs):
        super().__init__(cfg, **kwargs)
        self._carry = init_chunk_carry(cfg, self.dtype, self.device)

    def process_block(self, images: RangeImage, stamps) -> None:
        """``images``: a RangeImage with a [B, ...] leading axis
        (``core.scan.stack_range_images``); ``stamps``: the B scans'
        timestamps."""
        images = RangeImage(*(a.to(self.device) for a in images))
        b = len(stamps)
        carry0 = self._carry
        carry1, outs = mapping_chunk_step(carry0, images, self.cfg)
        be = outs.block_errors
        status, edge_err = torch.stack(
            [outs.status.to(be.dtype), be[:, 0]]).cpu().numpy()  # one read
        if self._block_suspect(status.astype(np.int32), edge_err):
            # Re-drive the block scan by scan through the host facade
            # (re-seed ladder) from the pre-block state.
            odo = self.odometry
            odo.state = carry0.odo
            odo._last_pose = Pose(carry0.prev_q, carry0.prev_t)
            for s in range(b):
                feats = self._extract(RangeImage(*(a[s] for a in images)))
                self.process_scan(feats.edge_xyz, feats.edge_valid,
                                  feats.surface_xyz, feats.surface_valid,
                                  stamp=float(stamps[s]))
            last = odo._last_pose
            self._carry = ChunkCarry(
                odo=odo.state,
                prev_q=odo.state.pose_q if last is None else last.q,
                prev_t=odo.state.pose_t if last is None else last.t)
            return

        self._carry = carry1
        # The facade at the block's end, for checkpoints and replays.
        self.odometry.state = carry1.odo
        self.odometry._last_pose = Pose(carry1.prev_q, carry1.prev_t)
        self.odometry.n_scans += b
        for s in range(b):
            self.ingest_odometry_result(
                outs.edge_pts[s], outs.edge_valid[s], outs.surf_pts[s],
                outs.surf_valid[s], Pose(outs.pose_q[s], outs.pose_t[s]),
                hessian=outs.hessian[s], stamp=float(stamps[s]))

    def _block_suspect(self, status: np.ndarray,
                       edge_errors: np.ndarray) -> bool:
        """The odometry gate over a block: a scan with EMPTY_INPUT or
        MAX_ITERATIONS, or whose edge block's median point-to-line
        distance (from its median squared residual ``edge_errors``) is
        finite and above ``edge_gate_distance``. The first scan of a run
        reports EMPTY_INPUT (no window yet) and is exempt, as the host
        path's ``n_scans > 1`` check."""
        first_exempt = 1 if len(self.keyframes) == 0 else 0
        if np.isin(status[first_exempt:],
                   (gn.EMPTY_INPUT, gn.MAX_ITERATIONS)).any():
            return True
        gate = self.odometry.edge_gate_distance
        if gate is None:
            return False
        edge_med = np.sqrt(np.maximum(edge_errors[first_exempt:], 0.0)) / 2.0
        return bool((np.isfinite(edge_med) & (edge_med > gate)).any())

    def _extract(self, image: RangeImage):
        return extract_features(image, self.cfg.extraction)
