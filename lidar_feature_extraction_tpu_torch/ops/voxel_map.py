"""Device-resident voxel-hash point map with 3x3x3-neighbourhood kNN.

Port of ``lidar_feature_extraction_tpu/ops/voxel_map.py``: the
correspondence structure of the kNN path for unbounded worlds, where the
dense grid (``ops/voxel_grid.py``) would not fit. Map points are hashed
into an open-addressed voxel table once; kNN gathers the 27 voxels
around each query and keeps the k nearest of their points.

Coordinates are packed map-locally into one int32 key: x, y in
[-1024, 1024) voxels, z in [-256, 256) voxels relative to ``origin``; a
point outside that volume gets ``_EMPTY`` and is never inserted or
matched (``ops/downsample.py`` sorts by the same key).

The table is built with a fixed number of claim rounds and no host
read. Where JAX's primitives differ from torch's:

- the murmur3 finalizer multiplies in uint32; torch has no uint32
  arithmetic, so each multiply runs in int64 on 16-bit halves of the
  constant, masked to 32 bits (no product can overflow);
- ``jnp.argsort`` is stable; ``torch.argsort`` only with
  ``stable=True``;
- a claim round's ``.at[slot].max`` into zeros is a
  ``scatter_reduce_(..., "amax")``, integer and order-free;
- ``lax.associative_scan(jnp.maximum)`` is ``torch.cummax``;
- the slot writes' ``.at[rows, cols].set(mode="drop")``: every point
  not kept writes the dump row ``capacity``, the only index written
  twice, and it is dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_feature_extraction_tpu_torch.ops.voxel_grid import (
    topk_from_candidates)

_XY_BITS = 11  # +/- 1024 voxels
_Z_BITS = 9    # +/- 256 voxels
_XY_HALF = 1 << (_XY_BITS - 1)
_Z_HALF = 1 << (_Z_BITS - 1)
_EMPTY = 0x7FFFFFFF  # sorts last, never a valid packed key
_MASK32 = 0xFFFFFFFF


class VoxelHashMap(NamedTuple):
    """Open-addressed voxel table.

    keys:    [C] int32 packed voxel key; ``_EMPTY`` = free bucket.
    points:  [C, S, 3] point slots per bucket (zeros when unused).
    n_pts:   [C] int32 occupied slots per bucket.
    voxel_size: scalar tensor.
    origin:  [3] map-local frame origin subtracted before voxelization.
    """

    keys: torch.Tensor
    points: torch.Tensor
    n_pts: torch.Tensor
    voxel_size: torch.Tensor
    origin: torch.Tensor


def _pack_coords(xyz: torch.Tensor, voxel_size, origin) -> torch.Tensor:
    """Points [..., 3] -> int32 packed voxel key; _EMPTY if out of volume."""
    c = torch.floor((xyz - origin) / voxel_size).to(torch.int32)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    inside = ((x >= -_XY_HALF) & (x < _XY_HALF)
              & (y >= -_XY_HALF) & (y < _XY_HALF)
              & (z >= -_Z_HALF) & (z < _Z_HALF))
    key = (((x + _XY_HALF) << (_XY_BITS + _Z_BITS))
           | ((y + _XY_HALF) << _Z_BITS)
           | (z + _Z_HALF))
    return torch.where(inside, key, torch.full_like(key, _EMPTY))


def _shift_key(key: torch.Tensor, d: tuple[int, int, int]) -> torch.Tensor:
    """Packed key of the voxel offset by d (valid keys only), component
    by component so that borrows and carries cannot cross fields."""
    dx, dy, dz = d
    x = (key >> (_XY_BITS + _Z_BITS)) + dx
    y = ((key >> _Z_BITS) & ((1 << _XY_BITS) - 1)) + dy
    z = (key & ((1 << _Z_BITS) - 1)) + dz
    inside = ((x >= 0) & (x < 2 * _XY_HALF)
              & (y >= 0) & (y < 2 * _XY_HALF)
              & (z >= 0) & (z < 2 * _Z_HALF) & (key != _EMPTY))
    out = (x << (_XY_BITS + _Z_BITS)) | (y << _Z_BITS) | z
    return torch.where(inside, out, torch.full_like(out, _EMPTY))


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32): the uint32 product."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash_key(key: torch.Tensor, capacity: int) -> torch.Tensor:
    """murmur3-finalizer style avalanche of the key's uint32 bits, then
    mod capacity: int64 bucket indices."""
    h = key.to(torch.int64) & _MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h % capacity


def _find_buckets(table_keys: torch.Tensor, key: torch.Tensor,
                  capacity: int, max_probes: int) -> torch.Tensor:
    """Linear-probe lookup of keys of any shape: the bucket of each key,
    -1 where not found; ``max_probes`` rounds of gathers, no host read."""
    home = _hash_key(key, capacity)
    found = torch.full(key.shape, -1, dtype=torch.int64, device=key.device)
    for t in range(max_probes):
        slot = (home + t) % capacity
        hit = (found == -1) & (table_keys[slot] == key) & (key != _EMPTY)
        found = torch.where(hit, slot, found)
    return found


def build_voxel_map(xyz: torch.Tensor, mask: torch.Tensor, voxel_size,
                    capacity: int, slots: int, max_probes: int = 16,
                    origin=None) -> VoxelHashMap:
    """Insert the masked points [N, 3] into a fresh voxel table.

    Bucket assignment runs ``max_probes`` claim rounds: each round every
    voxel key still without a bucket proposes itself for its next probe
    slot, the largest proposal wins each free bucket, and the losers
    advance. Then each voxel's first ``slots`` points in key-sorted
    (stable) order fill its bucket's slots."""
    n = xyz.shape[0]
    dtype, dev = xyz.dtype, xyz.device
    origin = torch.as_tensor(0.0 if origin is None else origin, dtype=dtype,
                             device=dev).expand(3)
    voxel_size = torch.as_tensor(voxel_size, dtype=dtype, device=dev)
    key = torch.where(mask, _pack_coords(xyz, voxel_size, origin),
                      torch.full(mask.shape, _EMPTY, dtype=torch.int32,
                                 device=dev))

    order = torch.argsort(key, stable=True)          # _EMPTY sorts last
    skey = key[order]
    sxyz = xyz[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = skey[1:] != skey[:-1]
    first = first & (skey != _EMPTY)
    uniq = torch.where(first, skey, torch.full_like(skey, _EMPTY))

    table_keys = torch.full((capacity,), _EMPTY, dtype=torch.int32,
                            device=dev)
    probe = torch.zeros(n, dtype=torch.int64, device=dev)
    home = _hash_key(uniq, capacity)
    placed = ~first
    for _ in range(max_probes):
        slot = (home + probe) % capacity
        want = ~placed
        # Propose key + 1 so that 0 means "no proposal" (valid packed
        # keys are >= 0).
        proposal = torch.zeros(capacity, dtype=torch.int32, device=dev)
        proposal.scatter_reduce_(0, slot, torch.where(
            want, uniq + 1, torch.zeros_like(uniq)), "amax")
        free = table_keys == _EMPTY
        table_keys = torch.where(free & (proposal > 0), proposal - 1,
                                 table_keys)
        got = want & (table_keys[slot] == uniq)
        placed = placed | got
        probe = torch.where(want & ~got, probe + 1, probe)

    bucket = _find_buckets(table_keys, skey, capacity, max_probes)
    idx = torch.arange(n, device=dev)
    seg_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rank = idx - seg_start

    ok = (skey != _EMPTY) & (bucket >= 0) & (rank < slots)
    rows = torch.where(ok, bucket, capacity)
    cols = torch.where(ok, torch.clamp_max(rank, slots - 1), 0)
    points = torch.zeros((capacity + 1, slots, 3), dtype=dtype, device=dev)
    points[rows, cols] = torch.where(ok[:, None], sxyz, 0.0)
    n_pts = torch.zeros(capacity + 1, dtype=torch.int32, device=dev)
    n_pts.index_add_(0, rows, ok.to(torch.int32))
    return VoxelHashMap(keys=table_keys, points=points[:capacity],
                        n_pts=torch.clamp_max(n_pts[:capacity], slots),
                        voxel_size=voxel_size, origin=origin)


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def neighborhood_candidates(vm: VoxelHashMap, queries: torch.Tensor,
                            max_probes: int = 16):
    """The 27-voxel candidate sets around each query [..., Q, 3]: (cand
    [..., Q, 27*S, 3], cand_ok [..., Q, 27*S]), the contract of
    ``voxel_grid.neighborhood_candidates``."""
    capacity = vm.keys.shape[0]
    slots = vm.points.shape[1]
    qkey = _pack_coords(queries, vm.voxel_size, vm.origin)
    nk = torch.stack([_shift_key(qkey, d) for d in _OFFSETS], dim=-1)
    bucket = _find_buckets(vm.keys, nk, capacity, max_probes)
    safe = torch.clamp_min(bucket, 0)
    cand = vm.points[safe]                                # [..., Q, 27, S, 3]
    cnt = vm.n_pts[safe]
    slot_idx = torch.arange(slots, device=queries.device)
    ok = (bucket[..., None] >= 0) & (slot_idx < cnt[..., None])
    lead = queries.shape[:-1]
    return (cand.reshape(lead + (27 * slots, 3)),
            ok.reshape(lead + (27 * slots,)))


def knn(vm: VoxelHashMap, queries: torch.Tensor, k: int,
        max_probes: int = 16):
    """The k nearest neighbours of each query [..., Q, 3] among the
    points of the 27 voxels around it: (nbrs [..., Q, k, 3], sq_dists
    [..., Q, k], valid [..., Q, k]), invalid lanes zero at +inf. A query
    in a sparse neighbourhood may find fewer than k."""
    cand, ok = neighborhood_candidates(vm, queries, max_probes)
    return topk_from_candidates(cand, ok, queries, k)
