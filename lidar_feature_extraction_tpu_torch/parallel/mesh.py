"""The device mesh: the ranks of a ``torch.distributed`` process group,
one device each, along one named axis.

Port of ``lidar_feature_extraction_tpu/parallel/mesh.py``. The
reference's ``Mesh`` lists the devices of one program and lets XLA place
a sharded array on them; here every rank is its own process on its own
device, so a ``Mesh`` is this process's view of the group: the group,
the axis name, the number of ranks, this rank and its device. A batch is
sharded by each rank taking its contiguous slice of the leading axis
(``shard_batch``); a replicated operand is the same tree on every rank's
device (``replicated``). Reductions over the mesh are ``psum``, an
``all_reduce`` on ``Mesh.group`` (the graph solvers' ``group=``).

The group is a plain process group (``multihost.initialize``), not
``init_device_mesh``: that helper picks NCCL for CUDA, and NCCL refuses
two ranks on one card, which is how the mesh runs on a single card
(gloo).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist


class Mesh(NamedTuple):
    """One rank's view of the mesh. ``group`` is None on a one-rank mesh
    without a process group (nothing to reduce over)."""

    group: Any
    axis: str
    size: int
    rank: int
    device: torch.device


def _default_device() -> torch.device:
    """The card this process works on (the current CUDA device; raises
    without one, like every entry point's default)."""
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=None) -> Mesh:
    """The mesh over the initialized process group (every rank of it),
    or a one-rank mesh when no group is up. ``n_devices``, when given,
    must be the group's size: a torch process group is its processes,
    and a mesh over some of them would be another group that every rank
    creates. ``device`` is this rank's device (the current CUDA device
    unless the caller passes another, e.g. ``"cpu"``)."""
    device = _default_device() if device is None else torch.device(device)
    if dist.is_available() and dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), \
            dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"process group has {size} ranks")
    return Mesh(group=group, axis=axis, size=size, rank=rank, device=device)


def psum(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """``x`` summed (or reduced by ``op``) over ``group``'s ranks, in
    place: ``all_reduce``, the reference's ``psum``. Without a group,
    ``x`` itself."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                        group=group)
    return x


def tree_map(fn, tree):
    """``fn`` over every tensor of a tree of tuples / NamedTuples /
    lists; other leaves (ints, None, dims tuples of ints) stay as they
    are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, a) for a in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, a) for a in tree)
    return tree


def tree_leaves(tree) -> list:
    """The tensors of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def shard_range(mesh: Mesh, n: int) -> slice:
    """This rank's contiguous slice of a leading axis of ``n``; raises
    unless ``n`` is a multiple of the mesh size (the reference's
    sharding requires even division)."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over a mesh of "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous shard of a leading-axis batch (a tensor or
    a tree of them, every leading axis the same), on its device."""
    leaves = tree_leaves(batch)
    n = {a.shape[0] for a in leaves}
    if len(n) != 1:
        raise ValueError(f"shard_batch: leading axes {sorted(n)} differ")
    sl = shard_range(mesh, n.pop())
    return tree_map(lambda a: a[sl].to(mesh.device), batch)


def replicated(mesh: Mesh, tree):
    """A tree every rank holds whole, on this rank's device."""
    return tree_map(lambda a: a.to(mesh.device), tree)
