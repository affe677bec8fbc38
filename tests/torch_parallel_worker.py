"""One rank of tests/test_torch_parallel.py's process group (NOT a pytest
module). ``multihost.spawn`` runs ``run_checks`` on each rank of a gloo
group on the CPU; it imports the port only (no JAX), takes the inputs
the parent builds meanwhile from ``inbox`` (warming ``torch.func`` up
while it waits), and returns numpy arrays for the parent to hold
against the JAX package and against the other rank.

What each rank runs:
- the environment contract ``initialize`` read (rank, world size);
- the sharded dense and CG pose graph and the sharded IMU graph in
  float32 (each sharded call twice, to see the same bits again) and in
  float64; rank r also solves the dtype r problems in one process (the
  comparison the parent makes for both ranks, whose sharded results it
  holds equal);
- the batched localizer over the mesh (its shard of B lanes), the lone
  ``localize_scan`` of each of its lanes, and the whole batch assembled
  by ``gather_to_host``;
- the errors: a batch or constraint count that does not divide over the
  ranks, trees that differ between ranks, shards of unequal sizes.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from lidar_feature_extraction_tpu_torch import interop
from lidar_feature_extraction_tpu_torch.parallel import imu_graph as tig
from lidar_feature_extraction_tpu_torch.parallel import multihost
from lidar_feature_extraction_tpu_torch.parallel import pose_graph as tpg
from lidar_feature_extraction_tpu_torch.parallel.distributed import (
    make_batched_localizer)
from lidar_feature_extraction_tpu_torch.parallel.mesh import (
    make_mesh, shard_batch)
from lidar_feature_extraction_tpu_torch.pipeline.localization import (
    localize_scan)

CPU = "cpu"


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy()


def _cast(nt, dtype):
    """A NamedTuple's float tensors in ``dtype``."""
    return type(nt)(*[None if a is None else
                      a.to(dtype) if a.is_floating_point() else a
                      for a in nt])


def _twice(fn, repeat: bool):
    """``fn()`` and, with ``repeat``, whether a second call gave the same
    bits (None without)."""
    a = fn()
    if not repeat:
        return a, None
    b = fn()
    return a, all(torch.equal(x, y) for x, y in zip(a, b) if x is not None)


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _flat_poses(g) -> np.ndarray:
    return np.concatenate([_np(g.poses_q), _np(g.poses_t)], -1)


def _pose_graph(mesh, inp, dtype, solver, n_cg, repeat, single):
    """The dense solver through ``make_distributed_pose_graph_optimizer``,
    or the CG solver at ``n_cg`` steps through ``group=`` on a strided
    shard fed by ``host_local_batch_to_global``; with ``single`` beside
    its one-process solve."""
    graph = _cast(interop.pose_graph_from_numpy(*inp["graph"], device=CPU),
                  dtype)
    cons = _cast(interop.constraints_from_numpy(*inp["cons"], device=CPU),
                 dtype)
    k = graph.poses_q.shape[0]
    out = {}
    if solver == "dense":
        run = tpg.make_distributed_pose_graph_optimizer(mesh, k)
        out["dense"], out["dense_repeats"] = _twice(
            lambda: run(graph, cons), repeat)
        if single:
            out["dense_single"] = tpg.optimize_pose_graph(graph, cons)
    else:
        shard = multihost.host_local_batch_to_global(mesh, type(cons)(*[
            None if a is None else a[mesh.rank::mesh.size] for a in cons]))
        out["cg"], out["cg_repeats"] = _twice(
            lambda: tpg.optimize_pose_graph_cg(graph, shard, n_cg=n_cg,
                                               group=mesh.group), repeat)
        if single:
            out["cg_single"] = tpg.optimize_pose_graph_cg(graph, cons,
                                                          n_cg=n_cg)
    return {name: v if v is None or isinstance(v, bool) else _flat_poses(v)
            for name, v in out.items()}


def _shard_fields(mesh, nt):
    """This rank's contiguous shard of every field of a NamedTuple."""
    return type(nt)(*[None if a is None else shard_batch(mesh, a)
                      for a in nt])


def _imu_graph(mesh, inp, dtype, repeat, single, n_iterations):
    graph = _cast(interop.imu_graph_from_numpy(*inp["graph"], device=CPU),
                  dtype)
    cons = _cast(interop.constraints_from_numpy(*inp["cons"], device=CPU),
                 dtype)
    imu = _cast(interop.imu_factors_from_numpy(*inp["imu"], device=CPU),
                dtype)

    def sharded():
        c, f = (_shard_fields(mesh, x) for x in (cons, imu))
        return tig.optimize_imu_graph(graph, c, f, n_iterations=n_iterations,
                                      group=mesh.group)

    dist_out, repeats = _twice(sharded, repeat)

    def flat(g):
        return np.concatenate([_np(g.poses_q).ravel(), _np(g.poses_t).ravel(),
                               _np(g.vels).ravel(), _np(g.bg)])
    out = {"imu": flat(dist_out), "imu_repeats": repeats}
    if single:
        out["imu_single"] = flat(tig.optimize_imu_graph(
            graph, cons, imu, n_iterations=n_iterations))
    return out


def _localizer(mesh, inp):
    cfg = inp["cfg"]
    maps = multihost.replicate_to_global(
        mesh, interop.geometry_maps_from_numpy(*inp["maps"], device=CPU))
    images = interop.range_images_from_numpy(*inp["images"], device=CPU)
    priors = interop.poses_from_numpy(*inp["priors"], device=CPU)
    run = make_batched_localizer(cfg, mesh=mesh)
    result, _ = run(maps, images, priors)
    n = images.xyz.shape[0] // mesh.size
    lone = []
    for b in range(mesh.rank * n, (mesh.rank + 1) * n):
        r, _ = localize_scan(maps, type(images)(*(a[b] for a in images)),
                             type(priors)(priors.q[b], priors.t[b]), cfg)
        lone.append(r)

    def fields(r, stack=False):
        get = (lambda f: torch.stack([f(x) for x in r])) if stack else \
            (lambda f: f(r))
        return {"status": _np(get(lambda x: x.status)),
                "iterations": _np(get(lambda x: x.iterations)),
                "q": _np(get(lambda x: x.pose.q)),
                "t": _np(get(lambda x: x.pose.t))}

    whole = multihost.gather_to_host(
        mesh, (result.status, result.iterations, result.pose.q,
               result.pose.t))
    three = type(images)(*(a[:3] for a in images))
    return {"shard": fields(result), "lone": fields(lone, stack=True),
            "gathered": [a.numpy() for a in whole],
            "odd_batch_raises": _raises(lambda: run(
                maps, three, type(priors)(priors.q[:3], priors.t[:3])))}


def _warm_up():
    """One tiny solve: ``torch.func`` loads its decompositions on first
    use (seconds), here while the parent builds the inputs."""
    q = torch.tensor([[1.0, 0, 0, 0]] * 2)
    t = torch.zeros(2, 3)
    tpg.optimize_pose_graph(
        tpg.PoseGraph(q, t), tpg.Constraints(
            torch.tensor([0], dtype=torch.int32),
            torch.tensor([1], dtype=torch.int32), q[:1], t[:1] + 1,
            torch.ones(1)), n_iterations=1)


def run_checks(inbox, timeout_s: float) -> dict:
    torch.set_num_threads(1)
    mesh = make_mesh(device=CPU)
    _warm_up()
    inputs = inbox.get(timeout=timeout_s)
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "env": {k: os.environ[k] for k in ("RANK", "WORLD_SIZE",
                                               "LOCAL_RANK")},
           "mesh": (mesh.size, mesh.rank, mesh.axis)}
    # float32, the pipeline's type, twice; float64 once, for the tight
    # comparison; the one-process solves of dtype n on rank n.
    for n, (dtype, repeat) in enumerate(((torch.float32, True),
                                         (torch.float64, False))):
        name = str(dtype).split(".")[-1]
        single = n % mesh.size == mesh.rank
        for solver in ("dense", "cg"):
            out[solver, name] = _pose_graph(mesh, inputs[solver], dtype,
                                            solver, inputs["n_cg"], repeat,
                                            single)
        out["imu", name] = _imu_graph(mesh, inputs["imu"], dtype, repeat,
                                      single, inputs["imu_iterations"])
    out["localizer"] = _localizer(mesh, inputs["localizer"])
    cons = interop.constraints_from_numpy(*inputs["dense"]["cons"],
                                          device=CPU)
    graph = interop.pose_graph_from_numpy(*inputs["dense"]["graph"],
                                          device=CPU)
    odd = type(cons)(*[None if a is None else a[:-1] for a in cons])
    out["odd_constraints_raise"] = _raises(
        lambda: tpg.make_distributed_pose_graph_optimizer(
            mesh, graph.poses_q.shape[0])(graph, odd))
    out["differing_trees_raise"] = _raises(
        lambda: multihost.replicate_to_global(
            mesh, (torch.zeros(3), torch.full((2,), float(mesh.rank)))))
    out["unequal_shards_raise"] = _raises(
        lambda: multihost.host_local_batch_to_global(
            mesh, torch.zeros(2 + mesh.rank, 3)))
    return out
