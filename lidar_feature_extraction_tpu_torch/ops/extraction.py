"""LOAM feature extraction on fixed-shape ``[n_rings, max_points]``
range images: plain PyTorch.

Port of ``lidar_feature_extraction_tpu/ops/extraction.py``. The functions
here are the plain version of kernel K1 (the hand-written CUDA kernel in
``ops/extraction_cuda.py``): labels and compaction columns must be
bit-equal to it and to the reference, so every step keeps the
reference's arithmetic:

- float thresholds are Python floats compared against float32 tensors,
  which torch, like JAX's weak typing, rounds to float32 first;
- each float expression is evaluated in the reference's order, one
  rounded operation at a time, except where XLA:CPU contracts the
  reference's jitted float32 code into fused multiply-adds: the range
  ``sqrt(fma(x, x, y*y))``, the neighbour cosine's
  ``fma(x, xn, y*yn)`` and the curvature's first step
  ``fma(-2p, r[i], r[i-1])``. There the port computes the same correctly
  rounded FMA (``_fma``), and takes square roots correctly rounded
  (``_sqrt``; the CPU build of torch is an ulp off on some float32
  inputs), both from ``core/_xla_f32.py``. float64 keeps one rounding
  per operation;
- rolls wrap, and the reference masks the wrapped lanes;
- integer cumsums are exact, so ``torch.cumsum`` replaces the
  reference's Hillis-Steele shift ladder;
- ``//`` on tensors floors, as JAX's does.

The multi-select NMS loop reads "anything selected?" back to the host
once per round; the CUDA kernel keeps that loop on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lidar_feature_extraction_tpu_torch.config import ExtractionConfig
from lidar_feature_extraction_tpu_torch.core._xla_f32 import (
    _fma_plain as _fma, sqrt as _sqrt)
from lidar_feature_extraction_tpu_torch.core.scan import RangeImage

# Label codes — parity with the reference's PointLabel enum.
DEFAULT = 0
EDGE = 1
EDGE_NEIGHBOR = 2
SURFACE = 3
SURFACE_NEIGHBOR = 4
OUT_OF_RANGE = 5
OCCLUDED = 6
PARALLEL_BEAM = 7


class ExtractionResult(NamedTuple):
    """One scan's features; a batch adds a leading [B] to each field."""

    labels: torch.Tensor        # [R, P] int32 PointLabel codes
    curvature: torch.Tensor     # [R, P] float
    edge_xyz: torch.Tensor      # [max_edges, 3]
    edge_valid: torch.Tensor    # [max_edges] bool
    surface_xyz: torch.Tensor   # [max_surfaces, 3]
    surface_valid: torch.Tensor  # [max_surfaces] bool


def _lane(a: torch.Tensor) -> torch.Tensor:
    """Lane index along the last axis, broadcastable against ``a``."""
    return torch.arange(a.shape[-1], dtype=torch.int32, device=a.device)


def _col(count: torch.Tensor) -> torch.Tensor:
    return count.reshape(-1, 1).to(torch.int32)


def _xy_norm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """XY range as the reference's jitted code computes it."""
    return _sqrt(_fma(x, x, y * y))


def curvature_kernel(rng: torch.Tensor, count: torch.Tensor,
                     padding: int) -> torch.Tensor:
    """Squared range-curvature over each ring, [R, P]:
    c[i] = (sum_{|k|<=p} w_k * range[i+k])^2 with w_0 = -2p, else 1;
    zero outside [p, n-p). The first step is the reference's contracted
    ``fma(-2p, r[i], r[i-1])``."""
    p = padding
    if p == 0:
        acc = -0.0 * rng
    else:
        acc = _fma(-2.0 * p, rng, torch.roll(rng, 1, -1)) \
            + torch.roll(rng, -1, -1)
    for k in range(2, p + 1):
        acc = acc + torch.roll(rng, k, -1) + torch.roll(rng, -k, -1)
    idx = _lane(rng)
    interior = (idx >= p) & (idx < _col(count) - p)
    return torch.where(interior, acc * acc, torch.zeros_like(acc))


def neighbor_flags_xy(x: torch.Tensor, y: torch.Tensor, count: torch.Tensor,
                      radian_threshold: float) -> torch.Tensor:
    """nb[r, i]: points i and i+1 of ring r subtend an XY angle below the
    threshold, as cos(angle) > cos(threshold); False at i >= count-1."""
    xn, yn = torch.roll(x, -1, -1), torch.roll(y, -1, -1)
    dot = _fma(x, xn, y * yn)
    norm = _xy_norm(x, y) * _xy_norm(xn, yn)
    cosang = torch.clamp(dot / torch.clamp_min(norm, 1e-30), -1.0, 1.0)
    has_next = _lane(x) < _col(count) - 1
    return (cosang > math.cos(radian_threshold)) & has_next


def neighbor_flags(xyz: torch.Tensor, count: torch.Tensor,
                   radian_threshold: float) -> torch.Tensor:
    """``neighbor_flags_xy`` of a range image's points [R, P, 3]."""
    return neighbor_flags_xy(xyz[..., 0], xyz[..., 1], count,
                             radian_threshold)


def _cumsum_lanes(a: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum along the last axis."""
    return torch.cumsum(a, dim=-1, dtype=torch.int32)


def gap_prefix(nb: torch.Tensor) -> torch.Tensor:
    """G[r, i] = number of non-neighbor pairs strictly before lane i;
    lanes i <= j are connected iff G[i] == G[j]."""
    g = _cumsum_lanes((~nb).to(torch.int32))
    idx = _lane(g)
    return torch.where(idx >= 1, torch.roll(g, 1, -1), torch.zeros_like(g))


def block_ids(count: torch.Tensor, n_points: int, padding: int,
              n_blocks: int) -> torch.Tensor:
    """Block index of each lane, or -1 outside all blocks, [R, P].
    Boundary j of a ring with n points is
    floor((padding*(B-j) + (n-padding)*j) / B); rings with
    n - 2*padding < n_blocks have no blocks."""
    n = _col(count)
    idx = torch.arange(n_points, dtype=torch.int32, device=count.device)
    blk = torch.full((n.shape[0], n_points), -1, dtype=torch.int32,
                     device=count.device)
    for j in range(n_blocks + 1):
        bound_j = (padding * (n_blocks - j) + (n - padding) * j) // n_blocks
        blk = blk + (idx >= bound_j).to(torch.int32)
    active = n - 2 * padding >= n_blocks
    in_blocks = (blk >= 0) & (blk < n_blocks) & (idx < n - padding)
    return torch.where(active & in_blocks, blk, torch.full_like(blk, -1))


def _nms_pass(labels, curvature, blk, g, count, *, padding, n_blocks,
              threshold, pick_max, point_code, neighbor_code, n_iter):
    """Multi-select segmented NMS (reference ``_nms_pass``): each round
    selects every candidate with no better candidate in its connected
    +/-padding window of the same block, then labels the selections and
    their windows. Stops after a round that selects nothing, or after
    ``n_iter`` rounds. Ties go to the higher index for edges and the
    lower index for surfaces."""
    del count, n_blocks
    lane = _lane(curvature)
    P = curvature.shape[-1]
    neg_inf = float("-inf")

    score = curvature if pick_max else -curvature
    thr_ok = (curvature >= threshold) if pick_max else (curvature <= threshold)
    base_cand = (blk >= 0) & thr_ok

    # Window membership per offset: lane+dd in range, same gap segment
    # and same block. Fixed across rounds.
    shifts = [sgn * d for d in range(1, padding + 1) for sgn in (-1, 1)]
    inb = {dd: ((lane + dd >= 0) & (lane + dd < P)
                & (torch.roll(g, -dd, -1) == g)
                & (torch.roll(blk, -dd, -1) == blk)) for dd in shifts}

    for _ in range(n_iter):
        cand = base_cand & (labels == DEFAULT)
        s = torch.where(cand, score, neg_inf)
        blocked = torch.zeros_like(cand)
        for dd in shifts:
            s_n = torch.roll(s, -dd, -1)
            tie_win = dd > 0 if pick_max else dd < 0
            better = (s_n > s) | ((s_n == s) & tie_win)
            blocked = blocked | (inb[dd] & better & (s_n > neg_inf))
        selected = cand & ~blocked
        if not bool(selected.any()):
            break
        win = selected
        for dd in shifts:
            win = win | (torch.roll(selected, -dd, -1) & inb[dd])
        labels = torch.where(win, neighbor_code, labels)
        labels = torch.where(selected, point_code, labels)
    return labels


def occlusion_mask(rng, nb, g, count, *, padding, distance_diff_threshold):
    """Occluded points, [R, P]: a neighbor pair whose range jumps by more
    than the threshold marks up to ``padding`` connected points on the
    far side (left and right sweeps of the reference)."""
    P = rng.shape[-1]
    idx = _lane(rng)
    n = _col(count)

    rng_next = torch.roll(rng, -1, -1)
    jump_up = rng_next > rng + distance_diff_threshold
    trig_l = torch.roll(nb & jump_up & (idx < n - padding - 1), 1, -1)
    trig_l = trig_l & (idx >= 1)
    jump_down = rng > rng_next + distance_diff_threshold
    trig_r = nb & jump_down & (idx >= padding) & (idx <= n - 2)

    occl = trig_l | trig_r
    for dshift in range(1, padding + 1):
        tl = torch.roll(trig_l, dshift, -1) & (idx >= dshift)
        occl = occl | (tl & (g == torch.roll(g, dshift, -1)))
        tr = torch.roll(trig_r, -dshift, -1) & (idx + dshift < P)
        occl = occl | (tr & (g == torch.roll(g, -dshift, -1)))
    return occl & (idx < n)


def parallel_beam_mask(rng, count, *, range_ratio_threshold):
    """Ratio test on both adjacent ranges."""
    idx = _lane(rng)
    n = _col(count)
    safe = torch.clamp_min(rng, 1e-30)
    r_prev = torch.abs(torch.roll(rng, 1, -1) - rng) / safe
    r_next = torch.abs(torch.roll(rng, -1, -1) - rng) / safe
    inner = (idx >= 1) & (idx < n - 1)
    return ((r_prev > range_ratio_threshold)
            & (r_next > range_ratio_threshold) & inner)


def label_planes(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                 count: torch.Tensor, cfg: ExtractionConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Labels [R, P] int32 and curvature [R, P] from x/y planes."""
    rng = torch.where(mask, _xy_norm(x, y), torch.zeros_like(x))

    curv = curvature_kernel(rng, count, cfg.padding)
    nb = neighbor_flags_xy(x, y, count, cfg.radian_threshold)
    g = gap_prefix(nb)
    blk = block_ids(count, x.shape[-1], cfg.padding, cfg.n_blocks)

    labels = torch.full(rng.shape, DEFAULT, dtype=torch.int32,
                        device=rng.device)
    labels = _nms_pass(
        labels, curv, blk, g, count,
        padding=cfg.padding, n_blocks=cfg.n_blocks,
        threshold=cfg.edge_threshold, pick_max=True,
        point_code=EDGE, neighbor_code=EDGE_NEIGHBOR,
        n_iter=cfg.nms_rounds)
    labels = _nms_pass(
        labels, curv, blk, g, count,
        padding=cfg.padding, n_blocks=cfg.n_blocks,
        threshold=cfg.surface_threshold, pick_max=False,
        point_code=SURFACE, neighbor_code=SURFACE_NEIGHBOR,
        n_iter=cfg.nms_rounds)

    # Masking passes overwrite labels in the reference's order.
    ring_active = _col(count) - 2 * cfg.padding >= cfg.n_blocks
    occl = occlusion_mask(rng, nb, g, count, padding=cfg.padding,
                          distance_diff_threshold=cfg.distance_diff_threshold)
    labels = torch.where(occl & ring_active, OCCLUDED, labels)

    in_ring = _lane(rng) < _col(count)
    oor = ~((rng >= cfg.min_range) & (rng <= cfg.max_range)) & in_ring
    labels = torch.where(oor & ring_active, OUT_OF_RANGE, labels)

    par = parallel_beam_mask(
        rng, count, range_ratio_threshold=cfg.parallel_beam_min_range_ratio)
    labels = torch.where(par & ring_active, PARALLEL_BEAM, labels)

    labels = torch.where(mask & ring_active, labels, DEFAULT)
    return labels.to(torch.int32), curv


def label_range_image(image: RangeImage, cfg: ExtractionConfig
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point labels and curvature for a whole range image."""
    return label_planes(image.xyz[..., 0], image.xyz[..., 1],
                        image.mask, image.count, cfg)


def compact_by_mask(xyz: torch.Tensor, mask: torch.Tensor,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked points of [R, P, 3] in scan order, packed into a
    fixed-capacity [capacity, 3] array + validity mask; a batch of scans
    [B, R, P, 3] is packed scan by scan ([B, capacity, 3], [B, capacity]).
    Positions come from a cumsum per scan, so nothing is read back to the
    host."""
    lead = mask.shape[:-2]
    flat = mask.reshape(-1, mask.shape[-2] * mask.shape[-1])   # [L, R * P]
    pts = xyz.reshape(flat.shape + (3,))
    pos = torch.cumsum(flat.to(torch.int64), 1) - 1
    dest = torch.where(flat & (pos < capacity), pos,
                       torch.full_like(pos, capacity))
    gathered = torch.zeros((flat.shape[0], capacity + 1, 3),
                           dtype=xyz.dtype, device=xyz.device)
    # Row ``capacity`` of each scan takes the rest.
    gathered[torch.arange(flat.shape[0], device=xyz.device)[:, None],
             dest] = pts
    n = torch.sum(flat.to(torch.int64), dim=1)
    valid = torch.arange(capacity, device=xyz.device) < n[:, None]
    return (gathered[:, :capacity].reshape(lead + (capacity, 3)),
            valid.reshape(lead + (capacity,)))


def extract_features(image: RangeImage,
                     cfg: ExtractionConfig) -> ExtractionResult:
    """Full feature-extraction step for one organized scan (the map
    build's and the faithful path's extraction), or for a batch of B
    scans ([B, R, P, 3] xyz, the reference's ``vmap``): labels
    [B, R, P], edges [B, max_edges, 3], surfaces [B, max_surfaces, 3].

    With ``cfg.pallas_labeling`` the labels and curvature of a CUDA
    image come from kernel K1, ONE launch on the [B * R, P] planes of a
    batch (its compaction columns are not used here); CPU images, and
    ``pallas_labeling=False``, take ``label_range_image``. Both give the
    same labels and curvature, bit for bit, where the image's mask is
    ``lane < count`` (K1's mask), as in every image ``build_range_image``
    makes. Every labelling step works ring by ring; the compaction runs
    scan by scan."""
    # The batch's rings as one image [B * R, P].
    rings = RangeImage(*(a.reshape((-1,) + a.shape[a.dim() - k:])
                         for a, k in zip(image, (2, 1, 0))))
    if cfg.pallas_labeling and image.xyz.device.type == "cuda":
        from lidar_feature_extraction_tpu_torch.ops.extraction_cuda import (
            label_and_columns_cuda)

        xyz = rings.xyz
        labels, curv, _ = label_and_columns_cuda(
            xyz[..., 0].contiguous(), xyz[..., 1].contiguous(),
            xyz[..., 2].contiguous(), rings.count, cfg, 1.0,
            cfg.edges_per_ring, cfg.surface_runs_per_ring)
    else:
        labels, curv = label_range_image(rings, cfg)
    labels = labels.reshape(image.mask.shape)
    curv = curv.reshape(image.mask.shape)
    edge_xyz, edge_valid = compact_by_mask(
        image.xyz, (labels == EDGE) & image.mask, cfg.max_edges)
    surf_xyz, surf_valid = compact_by_mask(
        image.xyz, (labels == SURFACE) & image.mask, cfg.max_surfaces)
    return ExtractionResult(labels, curv, edge_xyz, edge_valid,
                            surf_xyz, surf_valid)


def _voxel_run_key_planes(x, y, z, leaf: float) -> torch.Tensor:
    """int32 voxel identity hash over coordinate planes (wrapping int32
    multiplies, as in the reference)."""
    cx = torch.floor(x / leaf).to(torch.int32)
    cy = torch.floor(y / leaf).to(torch.int32)
    cz = torch.floor(z / leaf).to(torch.int32)
    return (cx * 73856093) ^ (cy * 19349663) ^ (cz * 83492791)


def _voxel_run_key(xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    return _voxel_run_key_planes(xyz[..., 0], xyz[..., 1], xyz[..., 2],
                                 leaf)


def compact_columns(labels: torch.Tensor, mask: torch.Tensor,
                    key: torch.Tensor, ce: int, cs: int):
    """One-hot column of every lane for the compaction matmul, [R, P]
    int32: edges get their per-ring rank (capped at ``ce``), surface
    voxel-run ENDS get ``ce +`` their stratified run column, all other
    lanes the dump column ``ce + cs``.
    Returns (col, edge_mask, surf_mask, run_end)."""
    edge_mask = (labels == EDGE) & mask
    surf_mask = (labels == SURFACE) & mask
    idx = _lane(labels)
    P = labels.shape[-1]
    minus1 = torch.full_like(labels, -1, dtype=torch.int32)

    epos = _cumsum_lanes(edge_mask.to(torch.int32)) - 1
    ecol = torch.where(edge_mask & (epos < ce), epos, minus1)

    nxt_key = torch.roll(key, -1, -1)
    nxt_surf = torch.roll(surf_mask, -1, -1) & (idx < P - 1)
    run_end = surf_mask & (~nxt_surf | (nxt_key != key))
    rid = _cumsum_lanes(run_end.to(torch.int32)) - 1
    n_runs = torch.clamp_min(rid[:, P - 1:P] + 1, 1)
    denom = torch.clamp_min(n_runs, cs)
    scol_all = (rid * cs) // denom
    scol_prev = ((rid - 1) * cs) // denom
    first_on_col = (rid == 0) | (scol_all > scol_prev)
    scol = torch.where(run_end & first_on_col, scol_all, minus1)

    col = torch.where(ecol >= 0, ecol,
                      torch.where(scol >= 0, ce + scol,
                                  torch.full_like(scol, ce + cs)))
    return col.to(torch.int32), edge_mask, surf_mask, run_end


def label_and_columns_plain(x, y, z, count, cfg: ExtractionConfig,
                            surface_leaf: float, ce: int, cs: int):
    """Plain version of kernel K1 (the reference's Pallas ``_kernel``):
    labels, curvature and compaction columns of [R, P] coordinate planes,
    with the point mask ``lane < count``."""
    mask = _lane(x) < _col(count)
    labels, curv = label_planes(x, y, mask, count, cfg)
    key = _voxel_run_key_planes(x, y, z, surface_leaf)
    col, _, _, _ = compact_columns(labels, mask, key, ce, cs)
    return labels, curv, col


def _segmented_hold(flag: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Per lane of [R, P]: ``value`` [R, P, F] at the most recent lane at
    or before it where ``flag`` is set (lane 0's where there is none), as
    the reference's associative scan gives it; here a running max of the
    flagged lane indices and a gather."""
    lane = _lane(flag).to(torch.int64).expand(flag.shape)
    src = torch.cummax(torch.where(flag, lane, 0), dim=-1).values
    return torch.gather(value, 1, src[..., None].expand(value.shape))


def _surface_run_sums(xyz: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor, leaf: float) -> torch.Tensor:
    """[R, P, 4]: at the end lane of each surface voxel run, the sum of
    the run's points and their count (centroid mode), from per-ring
    cumulative sums less their value before the run's start."""
    surf = (labels == SURFACE) & mask
    key = _voxel_run_key(xyz, leaf)
    prv_surf = torch.roll(surf, 1, -1) & (_lane(labels) >= 1)
    run_start = surf & (~prv_surf | (torch.roll(key, 1, -1) != key))
    own = torch.cat([torch.where(surf[..., None], xyz, 0.0),
                     surf.to(xyz.dtype)[..., None]], dim=-1)
    csum = torch.cumsum(own, dim=1)
    return csum - _segmented_hold(run_start, csum - own)


class CompactFeatures(NamedTuple):
    """Feature outputs of the single-matmul compaction path.

    edge_xyz:     [R * edges_per_ring, 3]
    surface_xyz:  [R * surface_runs_per_ring, 3] one point per voxel run
                  (the run's last measured point, or with
                  ``surface_centroid`` the run's centroid)
    """

    labels: torch.Tensor
    curvature: torch.Tensor
    edge_xyz: torch.Tensor
    edge_valid: torch.Tensor
    surface_xyz: torch.Tensor
    surface_valid: torch.Tensor


def extract_features_compact(image: RangeImage, cfg: ExtractionConfig,
                             surface_leaf: float = 1.0,
                             edges_per_ring: int = 32,
                             surface_runs_per_ring: int = 64,
                             surface_centroid: bool = False
                             ) -> CompactFeatures:
    """Feature extraction compacted by ONE one-hot matmul (reference
    ``extract_features_compact``): per ring, the first ``edges_per_ring``
    edges by lane order, and one point per surface voxel run, runs
    picked stratified by azimuth rank. A run is represented by its last
    measured point, or with ``surface_centroid`` by its centroid.

    With ``cfg.pallas_labeling`` the labels and columns come from
    ``label_and_columns`` (kernel K1 on CUDA tensors, its plain version
    on CPU tensors); otherwise from the plain functions above.

    A batch of B images ([B, R, P, 3] xyz) is extracted as one image of
    B * R rings, every step working ring by ring: ONE K1 launch on the
    [B * R, P] planes. The features come back per scan: labels
    [B, R, P], edges [B, R * edges_per_ring, 3], surfaces
    [B, R * surface_runs_per_ring, 3]."""
    if image.xyz.dim() == 4:
        B = image.mask.shape[0]
        f = extract_features_compact(
            RangeImage(*(a.flatten(0, 1) for a in image)), cfg,
            surface_leaf, edges_per_ring, surface_runs_per_ring,
            surface_centroid)
        # Ring-major rows: scan b's rings (and their features) are the
        # b-th block of R.
        return CompactFeatures(*(a.reshape((B, -1) + a.shape[1:])
                                 for a in f))
    xyz = image.xyz
    R, P = image.mask.shape
    ce, cs = edges_per_ring, surface_runs_per_ring
    dtype = xyz.dtype

    if cfg.pallas_labeling:
        from lidar_feature_extraction_tpu_torch.ops.extraction_cuda import (
            label_and_columns)

        labels, curv, col = label_and_columns(
            xyz[..., 0].contiguous(), xyz[..., 1].contiguous(),
            xyz[..., 2].contiguous(), image.count, cfg, surface_leaf,
            ce, cs)
    else:
        labels, curv = label_range_image(image, cfg)
        key = _voxel_run_key(xyz, surface_leaf)
        col, _, _, _ = compact_columns(labels, image.mask, key, ce, cs)

    # Run-end representative point [xyz, 1] for edges and surfaces alike,
    # or the run sums [sum xyz, count] at the surface run ends.
    feat = torch.cat([xyz, torch.ones((R, P, 1), dtype=dtype,
                                      device=xyz.device)], dim=-1)
    if surface_centroid:
        edge = (labels == EDGE) & image.mask
        feat = torch.where(edge[..., None], feat, _surface_run_sums(
            xyz, labels, image.mask, surface_leaf))
    onehot = (col[..., None] == torch.arange(
        ce + cs, device=xyz.device)[None, None, :]).to(dtype)
    out = torch.einsum("rpc,rpf->rcf", onehot, feat)    # [R, ce+cs, 4]

    eblk = out[:, :ce]
    sblk = out[:, ce:]
    edge_valid = eblk[..., 3] > 0.5
    edge_xyz = torch.where(edge_valid[..., None], eblk[..., :3], 0.0)
    s_cnt = sblk[..., 3]
    surf_valid = s_cnt > 0.5
    surf_xyz = torch.where(surf_valid[..., None],
                           sblk[..., :3] / torch.clamp_min(s_cnt[..., None],
                                                           1.0),
                           0.0)
    return CompactFeatures(
        labels=labels, curvature=curv,
        edge_xyz=edge_xyz.reshape(R * ce, 3),
        edge_valid=edge_valid.reshape(R * ce),
        surface_xyz=surf_xyz.reshape(R * cs, 3),
        surface_valid=surf_valid.reshape(R * cs))
