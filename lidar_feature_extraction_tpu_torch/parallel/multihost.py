"""Bringing up the process group, and feeding per-rank scan shards.

Port of ``lidar_feature_extraction_tpu/parallel/multihost.py``. The
reference runs one ``jax.distributed.initialize`` per host and assembles
host-local shards into global arrays; here each rank is one process
with one device, so:

- ``initialize`` starts ``torch.distributed`` from torch's own
  environment contract (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``, as ``torchrun`` sets them) with the
  caller's backend: ``"nccl"`` on the cards, ``"gloo"`` on the CPU or for
  several ranks sharing one card (NCCL refuses two ranks on one device).
  A backend that is not available raises; none is swapped for another;
- ``host_local_batch_to_global`` keeps each rank's shard on its own
  device, ``replicate_to_global`` moves a tree every rank holds to its
  device and checks with one ``all_reduce`` that the ranks hold the same
  bits, and ``gather_to_host`` assembles a sharded result where a caller
  needs the whole batch. Every collective is an ``all_reduce``, the one
  that gloo also takes on CUDA tensors;
- ``spawn`` runs a function on N local ranks (fresh ``spawn`` processes,
  the environment contract set for each), returns what each rank
  returned, and raises when a rank fails or the ranks outlive their
  time: it kills them rather than wait on a hung collective.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lidar_feature_extraction_tpu_torch.parallel.mesh import (
    Mesh, make_mesh, psum, tree_leaves, tree_map)

# How long a collective may wait for the other ranks before it fails.
DEFAULT_TIMEOUT_S = 600.0


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str = "nccl",
               local_rank: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group (nothing at one process).

    Arguments default to torch's environment contract:
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK``; explicit arguments win. With ``"nccl"`` this rank's
    card, ``cuda:LOCAL_RANK``, becomes the current device first. Every
    collective of the group fails after ``timeout_s`` instead of waiting
    forever. Returns whether a group was started."""
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(f"initialize: {num_processes} processes need a "
                         f"coordinator address and this process's rank")
    if not dist.is_available() or not dist.is_backend_available(backend):
        raise RuntimeError(f"initialize: the {backend!r} backend is not "
                           f"available in this build of torch")
    if backend == "nccl":
        torch.cuda.set_device(process_id if local_rank is None
                              else local_rank)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(axis: str = "data", device=None) -> Mesh:
    """The mesh over every rank of the group (this rank's device: the
    current CUDA device unless the caller passes another)."""
    return make_mesh(axis=axis, device=device)


def host_local_batch_to_global(mesh: Mesh, local_batch):
    """This rank's scans as its shard of the global batch: the tree on
    its device, the global batch being the ranks' shards in rank order.
    Every rank must bring the same number of scans (the reference's
    ``make_array_from_process_local_data`` requires it); one
    ``all_reduce`` checks it."""
    leaves = tree_leaves(local_batch)
    n = {a.shape[0] for a in leaves}
    if len(n) != 1:
        raise ValueError(f"host_local_batch_to_global: leading axes "
                         f"{sorted(n)} differ")
    n = n.pop()
    both = psum(torch.tensor([n, -n], dtype=torch.int64, device=mesh.device),
                mesh.group, dist.ReduceOp.MAX)
    if int(both[0]) != -int(both[1]):
        raise ValueError(f"host_local_batch_to_global: the ranks hold "
                         f"{-int(both[1])} to {int(both[0])} scans")
    return tree_map(lambda a: a.to(mesh.device), local_batch)


def _checksum(a: torch.Tensor) -> torch.Tensor:
    """A position-weighted sum of a tensor's bytes (int64, exact)."""
    b = a.detach().contiguous().reshape(-1).view(torch.uint8).to(torch.int64)
    w = torch.arange(b.numel(), device=b.device, dtype=torch.int64) \
        % 65521 + 1
    return torch.sum(b * w)


def replicate_to_global(mesh: Mesh, tree):
    """A tree every rank must hold with the same bits (maps loaded from
    the same file, a deterministic graph), on this rank's device. One
    ``all_reduce`` of the leaves' checksums checks that they agree; a
    rank whose tree differs makes every rank raise."""
    tree = tree_map(lambda a: a.to(mesh.device), tree)
    sums = [_checksum(a) for a in tree_leaves(tree)]
    if not sums:
        return tree
    v = torch.stack(sums)
    both = psum(torch.cat([v, -v]), mesh.group, dist.ReduceOp.MAX)
    k = v.numel()
    if not torch.equal(both[:k], -both[k:]):
        raise ValueError("replicate_to_global: the ranks' trees differ")
    return tree


_BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
         torch.float16: torch.int16, torch.bfloat16: torch.int16,
         torch.bool: torch.uint8}


def gather_to_host(mesh: Mesh, tree):
    """The whole batch of a sharded result on the host: every leaf's
    shards ([n, ...] on each rank, in rank order) as one CPU tensor
    [n * size, ...]. Built on one ``all_reduce`` per leaf: each rank
    writes its shard's bits (floats viewed as integers, so the sum with
    the other ranks' zeros is exact) into a zeroed global tensor."""
    def gather(a: torch.Tensor) -> torch.Tensor:
        n = a.shape[0]
        bits = _BITS.get(a.dtype)
        src = a.contiguous() if bits is None else a.contiguous().view(bits)
        full = torch.zeros((n * mesh.size,) + tuple(a.shape[1:]),
                           dtype=src.dtype, device=mesh.device)
        full[mesh.rank * n:(mesh.rank + 1) * n] = src
        psum(full, mesh.group)
        full = full.cpu()
        return full if bits is None else full.view(a.dtype)

    return tree_map(gather, tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, timeout_s, fn, args, results):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    try:
        initialize(backend=backend, timeout_s=timeout_s)
        results.put((rank, True, fn(*args)))
    except BaseException:   # reported to the parent, then re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, backend: str = "nccl",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """``fn(*args)`` on ``nprocs`` local ranks, each a fresh ``spawn``
    process (a process that has started CUDA cannot fork) with
    ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
    ``LOCAL_RANK`` set and ``initialize(backend=...)`` called. ``fn``
    must be importable by name. Returns the ranks' return values in rank
    order. Raises with the rank's traceback when a rank fails, and kills
    every rank and raises ``TimeoutError`` when they have not all
    finished within ``timeout_s``."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        rank, nprocs, port, backend, timeout_s, fn, args, results))
        for rank in range(nprocs)]
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < nprocs:
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn: ranks "
                                   f"{sorted(set(range(nprocs)) - set(out))}"
                                   f" still running after {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"spawn: ranks {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}"
                                       f" before reporting")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
            if p.exitcode != 0:
                raise RuntimeError(f"spawn: a rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.pid is None:
                continue        # never started
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
    return [out[r] for r in range(nprocs)]
