"""Keyframe pose-graph optimization, on one device or sharded over a
mesh.

Port of ``lidar_feature_extraction_tpu/parallel/pose_graph.py``.

State: poses [K] as (wxyz quaternion, translation). Constraints: (i, j,
Z_ij), Z_ij the measured relative pose i -> j. Residual per constraint
r = log(Z_ij^-1 (T_i^-1 T_j)) in R^6 (rotation, local translation);
its Jacobians with respect to right tangent perturbations of T_i and T_j
are ``torch.func.jacfwd`` at zero under ``torch.func.vmap``, the
reference's ``jax.vmap(jax.jacfwd(...))``, cast back to the state's
dtype (``_jac``). The exponential and logarithmic maps and the
rotations there are torch's plain functions (``plain=True``):
``torch.func`` cannot batch or differentiate the float32 forms that the
registration's maps use (``core/_xla_f32.py``; on the card they are a
kernel without a derivative), so the linearization is not yet the
reference's bits (ROADMAP §C23). From the linearization on, float32
follows the reference's optimizer program: the robust weights, the 6x6
blocks and g as in-order FMA chains, scattered onto the gauge prior and
damping (XLA folds the reference's ``h + diag`` into its scatter), and
the pose update in its jitted forms. The blocks scatter into the normal
equations, and the CG solver's rows through ``ops/scatter.py``, in a
fixed order on the card and on the CPU (``scatter_normal_equations``),
so a solve gives the same bits every run. The dense float32 solve is
OpenBLAS's unblocked ``getf2`` + ``strsm`` order (``ops/lu_cuda.py``: a
kernel of this package on the card), float64 ``torch.linalg.solve_ex``.
The reference's
``fori_loop`` / ``scan`` are Python loops of device steps with no host
read.

Sharded (the reference's ``axis_name``): with ``group=`` a process
group, each rank holds the poses whole and its own shard of the
constraints, assembles its part of the normal equations, and the global
system is their ``all_reduce`` sum over the group (``mesh.psum``), at the
reference's places: H and g in the dense solver; the Hessian-vector
product, g and the Jacobi diagonal in the CG solver. Every rank then
solves the same system and takes the same step.
``make_distributed_pose_graph_optimizer`` shards the constraints of one
call over a ``mesh.Mesh``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.func import jacfwd, vmap

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.ops import lu_cuda
from lidar_feature_extraction_tpu_torch.ops.scatter import index_add_rows
from lidar_feature_extraction_tpu_torch.parallel.mesh import (
    Mesh, psum, replicated, shard_batch)


class PoseGraph(NamedTuple):
    poses_q: torch.Tensor   # [K, 4]
    poses_t: torch.Tensor   # [K, 3]


class Constraints(NamedTuple):
    i: torch.Tensor         # [M] source keyframe index
    j: torch.Tensor         # [M] target keyframe index
    z_q: torch.Tensor       # [M, 4] measured relative rotation
    z_t: torch.Tensor       # [M, 3] measured relative translation
    weight: torch.Tensor    # [M] information scale (0 masks a lane)
    # Optional [M, 6, 6] information in the residual tangent (rotation,
    # local translation); None = isotropic (scalar ``weight`` only).
    info: torch.Tensor | None = None


def _perturb(q, t, xi):
    """Right perturbation T * Exp(xi): xi = (dtheta, dt_local)."""
    q2 = quat.quat_multiply(q, quat.exp_so3(xi[:3], plain=True))
    return q2, t + quat.quat_rotate(q, xi[3:], plain=True)


def constraint_residual(qi, ti, qj, tj, z_q, z_t):
    """r = log(Z^-1 (T_i^-1 T_j)) in R^6."""
    rel_q = quat.quat_multiply(quat.quat_conjugate(qi), qj)
    rel_t = quat.quat_rotate(quat.quat_conjugate(qi), tj - ti, plain=True)
    err_q = quat.quat_multiply(quat.quat_conjugate(z_q), rel_q)
    err_t = quat.quat_rotate(quat.quat_conjugate(z_q), rel_t - z_t,
                             plain=True)
    return torch.cat([quat.log_so3(err_q, plain=True), err_t], dim=-1)


def _linearize_one(qi, ti, qj, tj, z_q, z_t):
    """Residual + Jacobians w.r.t. tangent perturbations of T_i, T_j."""
    r = constraint_residual(qi, ti, qj, tj, z_q, z_t)

    def fi(xi):
        q2, t2 = _perturb(qi, ti, xi)
        return constraint_residual(q2, t2, qj, tj, z_q, z_t)

    def fj(xi):
        q2, t2 = _perturb(qj, tj, xi)
        return constraint_residual(qi, ti, q2, t2, z_q, z_t)

    zero = torch.zeros(6, dtype=qi.dtype, device=qi.device)
    return r, _jac(fi, zero), _jac(fj, zero)


def _jac(f, x):
    """``jacfwd(f)(x)`` in ``x``'s dtype: forward mode promotes a Python
    float times a 0-d float32 tensor to a float64 tangent, so some
    columns would come out in float64."""
    return jacfwd(f)(x).to(x.dtype)


_linearize = vmap(_linearize_one)


def _robust_weights(cons: Constraints, r, robust_delta):
    """Scalar weights, times the Geman-McClure IRLS weight
    (d^2 / (d^2 + |r|^2))^2 when ``robust_delta`` is set."""
    w = cons.weight
    if robust_delta is not None:
        d2 = robust_delta * robust_delta
        r2 = xf.sum_squares(r)
        w = w * torch.square(d2 / (d2 + r2))
    return w


def _weighted_jacobians(cons: Constraints, w, ji, jj):
    """(Lambda Ji, Lambda Jj) with Lambda = w * info (or w)."""
    if cons.info is not None:
        lam = w[:, None, None] * cons.info
        return xf.matmul(lam, ji), xf.matmul(lam, jj)
    return w[:, None, None] * ji, w[:, None, None] * jj


def _block_index(bi, bj, d: int):
    """Row and column index grids [M, d, d] of the (bi, bj) blocks."""
    ar = torch.arange(d, device=bi.device)
    rows = (bi.long()[:, None] * d + ar[None, :])
    cols = (bj.long()[:, None] * d + ar[None, :])
    return (rows[:, :, None].expand(-1, d, d),
            cols[:, None, :].expand(-1, d, d))


def _scatter_add(out: torch.Tensor, index: tuple, src: torch.Tensor):
    """``out`` with ``src`` added at ``index`` (index grids of ``src``'s
    shape), out of place, in a fixed order: on the card
    ``index_put(accumulate=True)`` (sorted by destination, ROADMAP §C16);
    on the CPU ``index_add`` on the flattened tensor, which adds in index
    order, where ``index_put`` splits a large input between threads."""
    if out.is_cuda:
        return out.index_put(index, src, accumulate=True)
    flat = index[0]
    for idx, n in zip(index[1:], out.shape[1:]):
        flat = flat * n + idx
    return out.reshape(-1).index_add(0, flat.reshape(-1),
                                     src.reshape(-1)).reshape(out.shape)


def scatter_normal_equations(h, g, bi, bj, r, ji, jj, wji, wjj, d: int):
    """Accumulate one factor family's blocks into H [dK, dK] and g [dK]:
    H_ii = Ji^T Lambda Ji etc., ``wji = Lambda Ji``; in float32 each
    entry an in-order FMA chain (``xf.matmul``), the blocks added in the
    reference's scatter order (H_ii, H_ij, H_ji, H_jj, constraint by
    constraint)."""
    wti, wtj = wji.transpose(1, 2), wjj.transpose(1, 2)
    hii = xf.matmul(wti, ji)
    hij = xf.matmul(wti, jj)
    hjj = xf.matmul(wtj, jj)
    gi = xf.matmul(wti, r[..., None])[..., 0]
    gj = xf.matmul(wtj, r[..., None])[..., 0]
    h = _scatter_add(h, _block_index(bi, bi, d), hii)
    h = _scatter_add(h, _block_index(bi, bj, d), hij)
    h = _scatter_add(h, _block_index(bj, bi, d), hij.transpose(1, 2))
    h = _scatter_add(h, _block_index(bj, bj, d), hjj)
    ar = torch.arange(d, device=bi.device)
    g = _scatter_add(g, (bi.long()[:, None] * d + ar,), gi)
    g = _scatter_add(g, (bj.long()[:, None] * d + ar,), gj)
    return h, g


def _gather(graph: PoseGraph, cons: Constraints):
    i, j = cons.i.long(), cons.j.long()
    return (graph.poses_q[i], graph.poses_t[i], graph.poses_q[j],
            graph.poses_t[j], cons.z_q, cons.z_t)


def _normal_equations(cons: Constraints, r, ji, jj, h0: torch.Tensor,
                      robust_delta: float | None = None):
    """H (``h0`` plus the constraints' blocks) and g [6K] from the
    linearization (r, Ji, Jj). ``robust_delta`` applies the redescending
    Geman-McClure kernel on the 6-dim residual norm; with ``info`` the
    kernel stays on the plain norm and the information rides in
    Lambda."""
    w = _robust_weights(cons, r, robust_delta)
    wji, wjj = _weighted_jacobians(cons, w, ji, jj)
    return scatter_normal_equations(
        h0, torch.zeros(h0.shape[:1], dtype=h0.dtype, device=h0.device),
        cons.i, cons.j, r, ji, jj, wji, wjj, 6)


def _local_normal_equations(graph: PoseGraph, cons: Constraints,
                            n_poses: int,
                            robust_delta: float | None = None,
                            h0: torch.Tensor | None = None):
    """H [6K, 6K] (``h0`` plus the blocks; zeros by default) and g [6K]
    of the constraints at the current poses."""
    if h0 is None:
        k6 = 6 * n_poses
        h0 = torch.zeros((k6, k6), dtype=graph.poses_t.dtype,
                         device=graph.poses_t.device)
    return _normal_equations(cons, *_linearize(*_gather(graph, cons)), h0,
                             robust_delta)


def _apply_update(graph: PoseGraph, dx: torch.Tensor) -> PoseGraph:
    """The poses moved by the tangent step ``dx`` [6K], in float32 in the
    forms of the reference's optimizer program."""
    k = graph.poses_q.shape[0]
    xi = dx.reshape(k, 6)
    dq = quat.exp_so3(xi[:, :3])
    q2 = quat.quat_normalize(quat.quat_multiply_fma(graph.poses_q, dq))
    t2 = graph.poses_t + quat.quat_rotate_fma(graph.poses_q, xi[:, 3:])
    return PoseGraph(poses_q=q2, poses_t=t2)


def _solve(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The dense solve: in float32 the reference's LAPACK order
    (``ops/lu_cuda.solve``: the ``lu_solve`` kernel on the card, its plain
    version on the CPU); other dtypes ``torch.linalg.solve_ex`` (``solve``
    would read the device to check for errors)."""
    if h.dtype == torch.float32:
        return lu_cuda.solve(h, g)
    return torch.linalg.solve_ex(h, g)[0]


def optimize_pose_graph(graph: PoseGraph, cons: Constraints,
                        n_iterations: int = 10,
                        prior_weight: float = 1e6,
                        damping: float = 1e-6,
                        robust_delta: float | None = None,
                        group=None) -> PoseGraph:
    """Gauss-Newton over the whole pose graph with a dense [6K, 6K]
    solve per iteration. Pose 0 is gauge-fixed by a strong prior; the
    robust weights are recomputed every iteration at the current
    estimate. With ``group`` (a process group; ``cons`` this rank's
    shard) H and g are summed over its ranks."""
    k = graph.poses_q.shape[0]
    dtype, dev = graph.poses_t.dtype, graph.poses_t.device
    prior = torch.zeros(6 * k, dtype=dtype, device=dev)
    prior[:6] = prior_weight
    diag = torch.diag(prior + damping)
    # XLA folds the reference's H + diag(prior + damping) into its
    # scatter, so the blocks are added onto the diagonal; over ranks the
    # sum comes first, as the reference's psum.
    one_rank = group is None or dist.get_world_size(group) == 1
    for _ in range(n_iterations):
        if one_rank:
            h, g = _local_normal_equations(graph, cons, k, robust_delta,
                                           h0=diag)
            h, g = psum(h, group), psum(g, group)
        else:
            h, g = _local_normal_equations(graph, cons, k, robust_delta)
            h, g = psum(h, group) + diag, psum(g, group)
        dx = -_solve(h, g)
        graph = _apply_update(graph, dx)
    return graph


def _scatter_rows(k: int, cons: Constraints, a, b, like):
    """[K, 6]: a's rows added at cons.i, b's at cons.j."""
    out = torch.zeros((k, 6), dtype=like.dtype, device=like.device)
    index_add_rows(out, cons.i.long(), a)
    return index_add_rows(out, cons.j.long(), b)


def optimize_pose_graph_cg(graph: PoseGraph, cons: Constraints,
                           n_iterations: int = 10,
                           n_cg: int = 50,
                           prior_weight: float = 1e6,
                           damping: float = 1e-6,
                           robust_delta: float | None = None,
                           group=None) -> PoseGraph:
    """Matrix-free Gauss-Newton, the large-K companion of
    ``optimize_pose_graph``: each step solves the normal equations by
    ``n_cg`` Jacobi-preconditioned conjugate-gradient steps, one
    Hessian-vector product being two block einsums and a scatter-add;
    H is never formed. With ``group`` each CG step sums one [K, 6]
    vector over the ranks instead of the dense path's [6K, 6K]
    matrix."""
    k = graph.poses_q.shape[0]
    dtype, dev = graph.poses_t.dtype, graph.poses_t.device
    prior_diag = torch.zeros((k, 6), dtype=dtype, device=dev)
    prior_diag[0] = prior_weight
    prior_diag = prior_diag + damping
    i, j = cons.i.long(), cons.j.long()

    for _ in range(n_iterations):
        r, ji, jj = _linearize(*_gather(graph, cons))
        w = _robust_weights(cons, r, robust_delta)
        wji, wjj = _weighted_jacobians(cons, w, ji, jj)

        def hvp(x):                     # x: [K, 6] -> H x
            y = torch.einsum("mab,mb->ma", ji, x[i]) \
                + torch.einsum("mab,mb->ma", jj, x[j])
            return psum(_scatter_rows(
                k, cons, torch.einsum("mab,ma->mb", wji, y),
                torch.einsum("mab,ma->mb", wjj, y), x),
                group) + prior_diag * x

        g = psum(_scatter_rows(k, cons, torch.einsum("mab,ma->mb", wji, r),
                                torch.einsum("mab,ma->mb", wjj, r), r), group)
        # Jacobi preconditioner: diag(H) per tangent coordinate.
        dh = psum(_scatter_rows(
            k, cons, torch.einsum("mab,mab->mb", wji, ji),
            torch.einsum("mab,mab->mb", wjj, jj), r), group) + prior_diag

        # CG on H dx = -g from x0 = 0.
        x = torch.zeros_like(g)
        res = -g
        z = res / dh
        p = z
        for _ in range(n_cg):
            hp = hvp(p)
            rz = torch.sum(res * z)
            alpha = rz / torch.clamp_min(torch.sum(p * hp), 1e-30)
            x = x + alpha * p
            res = res - alpha * hp
            z = res / dh
            beta = torch.sum(res * z) / torch.clamp_min(rz, 1e-30)
            p = z + beta * p
        graph = _apply_update(graph, x.reshape(-1))
    return graph


def make_distributed_pose_graph_optimizer(mesh: Mesh, n_poses: int,
                                          solver: str = "dense"):
    """``run(graph, cons)`` sharded over ``mesh``: the poses replicated,
    the constraints split by rank (their number must divide over the
    mesh; pad with zero-weight lanes), the normal equations summed over
    the ranks. ``solver="dense"`` sums the [6K, 6K] system once per GN
    step (right at mapping scale, K <= 512); ``"cg"`` runs the
    matrix-free solver, one [K, 6] sum per CG step (K in the thousands).
    Every rank makes the same call with the whole graph and constraints
    and gets the same optimized graph."""
    if solver not in ("dense", "cg"):
        raise ValueError(f"solver {solver!r}: 'dense' or 'cg'")
    optimize = optimize_pose_graph_cg if solver == "cg" \
        else optimize_pose_graph

    def run(graph: PoseGraph, cons: Constraints) -> PoseGraph:
        if graph.poses_q.shape[0] != n_poses:
            raise ValueError(f"the optimizer was made for {n_poses} poses, "
                             f"the graph has {graph.poses_q.shape[0]}")
        if cons.info is None:
            # Identity information is the scalar-weight path exactly;
            # materialized so every rank's shard has the same fields.
            m = cons.i.shape[0]
            cons = cons._replace(info=torch.eye(
                6, dtype=cons.z_t.dtype, device=cons.z_t.device).expand(
                    m, 6, 6))
        return optimize(replicated(mesh, graph), shard_batch(mesh, cons),
                        group=mesh.group)

    return run
