"""Keyframe pose-graph optimization, on one device or sharded over a
mesh.

Port of ``lidar_feature_extraction_tpu/parallel/pose_graph.py``.

State: poses [K] as (wxyz quaternion, translation). Constraints: (i, j,
Z_ij), Z_ij the measured relative pose i -> j. Residual per constraint
r = log(Z_ij^-1 (T_i^-1 T_j)) in R^6 (rotation, local translation);
its Jacobians with respect to right tangent perturbations of T_i and T_j
are the forward mode of the reference's ``jax.vmap(jax.jacfwd(...))``
written out (``_linearize``), its six tangent columns in one tensor.

In float32 every step is the reference's optimizer program, the loop
``MappingPipeline.optimize`` runs (ROADMAP §C23): the linearization's
forms, which XLA:CPU contracts per copy of each subexpression; the
robust weights, the 6x6 blocks and g as in-order FMA chains, scattered
onto the gauge prior and damping (XLA folds the reference's ``h + diag``
into its scatter); the dense solve in OpenBLAS's blocked, threaded
``sgetrf`` + ``strsm`` order (``ops/lu_cuda.py``: a kernel of this
package on the card); the pose update in the forms of the program's
vectorized loops. Those loops round otherwise in their 8-wide part and
their remainder, so a few forms depend on a lane's position and on the
number of poses or constraints. Float64 rounds each operation and solves
with ``torch.linalg.solve_ex``. The blocks scatter into the normal
equations each destination's in turn, as XLA's scatter adds them, on
the card and on the CPU alike (``scatter_normal_equations``, through
``ops/scatter.py::index_add_rows_in_order``), so a solve gives the same
bits every run, and the card's the CPU's; the CG solver's rows in a
fixed order (``index_add_rows``). The reference's ``fori_loop`` /
``scan`` are Python loops of device steps; the dense path's one host
read per scatter is its number of passes.

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

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.ops import lu_cuda
from lidar_feature_extraction_tpu_torch.ops.scatter import (
    index_add_rows, index_add_rows_in_order)
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


def constraint_residual(qi, ti, qj, tj, z_q, z_t):
    """r = log(Z^-1 (T_i^-1 T_j)) in R^6, in float32 as the reference's
    optimizer program computes it (``_linearize``)."""
    zc, ci = quat.quat_conjugate(z_q), quat.quat_conjugate(qi)
    err_q = quat.quat_multiply_nested(zc, ci, qj, _RESIDUAL_SECOND)
    err_t = quat.quat_rotate_fma(zc, quat.quat_rotate_fma(ci, tj - ti) - z_t)
    return torch.cat([quat.log_so3(err_q), err_t], dim=-1)


# Which inner components of Z^-1 (A B) fuse their second product first,
# as (outer, inner) pairs (``quat.quat_multiply_nested``), in the loops of
# the reference's optimizer program: the residual's and the perturbation
# of T_i's error quaternion, and the tangents of the error quaternion for
# the perturbations of T_j and T_i.
_RESIDUAL_SECOND = {(0, 3), (2, 1)}
_TANGENT_J_SECOND = {(0, 1), (2, 3)}
_TANGENT_I_SECOND = {(0, 1), (0, 3), (2, 1), (2, 3)}


def _linearize(qi, ti, qj, tj, z_q, z_t):
    """Residual [M, 6] and Jacobians [M, 6, 6] with respect to right
    tangent perturbations (dtheta, dt_local) of T_i and T_j, at zero:
    the forward mode that ``jax.jacfwd`` runs, written out. The six
    tangent columns of each Jacobian ride in one [M, 6, .] tensor, the
    basis itself as data (the reference's program keeps the identity as
    a loop input, so every product with its zeros and ones is
    computed): Exp's tangent at zero is (0, e/2) and the translation's
    e. In float32 every entry is the program's expression: the primal
    values of the perturbed poses recomputed (T * Exp(0)), the nested
    products' orders above, ``log_so3_jvp``'s and ``quat_rotate_jvp``'s
    forms. Steps whose forms the two perturbations share run once on
    both, stacked (elementwise, so each lane's bits are its own)."""
    dt, dev = qi.dtype, qi.device
    eye = torch.eye(6, dtype=dt, device=dev)
    ident = eye[0, :4]
    d_exp = torch.cat([torch.zeros_like(eye[:, :1]), eye[:, :3] * 0.5], -1)
    zc, ci = quat.quat_conjugate(z_q), quat.quat_conjugate(qi)
    zc6 = zc[:, None]
    r = constraint_residual(qi, ti, qj, tj, z_q, z_t)

    # T_j * Exp(xi): err = Z^-1 (T_i^-1 T_j Exp(xi))
    err_j = quat.quat_multiply_nested(zc, ci, quat.quat_multiply_fma(
        qj, ident))
    derr_j = quat.quat_multiply_nested(
        zc6, ci[:, None], quat.quat_multiply_fma(qj[:, None], d_exp),
        _TANGENT_J_SECOND)
    # T_i * Exp(xi): err = Z^-1 ((T_i Exp(xi))^-1 T_j)
    ci2 = quat.quat_conjugate(quat.quat_multiply_fma(qi, ident))
    err_i = quat.quat_multiply_nested(zc, ci2, qj, _RESIDUAL_SECOND)
    dci = quat.quat_conjugate(quat.quat_multiply_fma(qi[:, None], d_exp))
    derr_i = quat.quat_multiply_nested(zc6, dci, qj[:, None],
                                       _TANGENT_I_SECOND)
    # R(q_j) e and R(q_i) e for the translation's tangents e
    rot_j, rot_i = quat.quat_rotate_fma(
        torch.stack([qj, qi])[:, :, None], eye[:, 3:]).unbind(0)
    uv = xf.cross(qi[:, 1:], torch.zeros_like(ti))
    t2 = ti + xf.fma(qi[:, :1], uv, xf.cross(qi[:, 1:], uv)) * 2.0
    drel = torch.stack([
        quat.quat_rotate_fma(ci[:, None], rot_j),
        quat.quat_rotate_jvp(ci2[:, None], (tj - t2)[:, None], dci, -rot_i)])
    jac = torch.cat([
        quat.log_so3_jvp(torch.stack([err_j, err_i]),
                         torch.stack([derr_j, derr_i])),
        quat.quat_rotate_fma(zc6, drel)], dim=-1)
    # [M, tangent, residual] -> jacfwd's [M, residual, tangent]
    jj, ji = jac.transpose(2, 3).unbind(0)
    return r, ji, jj


def _robust_weights(cons: Constraints, r, robust_delta, r2=None):
    """Scalar weights, times the Geman-McClure IRLS weight
    (d^2 / (d^2 + |r|^2))^2 when ``robust_delta`` is set; |r|^2 is
    ``r2`` where given, else ``xf.sum_squares(r)``."""
    w = cons.weight
    if robust_delta is not None:
        d2 = robust_delta * robust_delta
        if r2 is None:
            r2 = xf.sum_squares(r)
        w = w * torch.square(d2 / (d2 + r2))
    return w


def _graph_weights(cons: Constraints, r, robust_delta):
    """``_robust_weights`` with |r|^2 in float32 as the pose graph's
    optimizer program reduces it: 8 constraints at a time as a plain sum
    of rounded squares, the last M mod 8 as the fused chain."""
    if robust_delta is None:
        return cons.weight
    m = r.shape[0]
    wide = torch.arange(m, device=r.device) < 8 * (m // 8)
    return _robust_weights(cons, r, robust_delta, torch.where(
        wide, xf.sum_in_order(r * r, -1), xf.sum_squares(r)))


def _weighted_jacobians(cons: Constraints, w, ji, jj):
    """(Lambda Ji, Lambda Jj) with Lambda = w * info (or w)."""
    if cons.info is not None:
        lam = w[:, None, None] * cons.info
        return xf.matmul(lam, ji), xf.matmul(lam, jj)
    return w[:, None, None] * ji, w[:, None, None] * jj


def scatter_normal_equations(h, g, bi, bj, r, ji, jj, wji, wjj, d: int):
    """Accumulate one factor family's blocks into H [dK, dK] and g [dK]:
    H_ii = Ji^T Lambda Ji etc., ``wji = Lambda Ji``; in float32 each
    entry an in-order FMA chain (``xf.matmul``), the blocks added in the
    reference's scatter order (H_ii, H_ij, H_ji, H_jj, constraint by
    constraint), a d x d block or a pose's d entries of g a row of a
    scatter that adds each destination's rows in turn
    (``index_add_rows_in_order``)."""
    wti, wtj = wji.transpose(1, 2), wjj.transpose(1, 2)
    hii = xf.matmul(wti, ji)
    hij = xf.matmul(wti, jj)
    hjj = xf.matmul(wtj, jj)
    gi = xf.matmul(wti, r[..., None])[..., 0]
    gj = xf.matmul(wtj, r[..., None])[..., 0]
    k = g.shape[0] // d
    bi, bj = bi.long(), bj.long()
    # H as rows of blocks: block (a, b) is row a * K + b
    hb = index_add_rows_in_order(
        h.reshape(k, d, k, d).transpose(1, 2).reshape(k * k, d * d),
        torch.cat([bi * k + bi, bi * k + bj, bj * k + bi, bj * k + bj]),
        torch.cat([hii, hij, hij.transpose(1, 2), hjj]).reshape(-1, d * d))
    gb = index_add_rows_in_order(g.reshape(k, d), torch.cat([bi, bj]),
                                 torch.cat([gi, gj]))
    return (hb.reshape(k, k, d, d).transpose(1, 2).reshape(k * d, k * d),
            gb.reshape(-1))


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
    w = _graph_weights(cons, r, robust_delta)
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
    forms of the reference's optimizer program. Two of its loops over the
    poses run 8 wide over all but the last 1-8 poses and one at a time
    over those (``_vector_poses``), and contract otherwise: the rotation
    step's norm is a plain sum of rounded squares in the 8-wide part and
    the fused chain after it; ``q * Exp`` takes ``quat_multiply_fma``'s
    order in the 8-wide part and the second order for its x and y
    components after it. ``v x dt`` fuses each component's second product
    everywhere, and so do the x and y components of ``v x (v x dt)`` where
    the translation's loop is unrolled whole (8 poses or fewer)."""
    k = graph.poses_q.shape[0]
    xi = dx.reshape(k, 6)
    rot = xi[:, :3]
    sq = rot * rot
    wide = torch.arange(k, device=dx.device)[:, None] < _vector_poses(k)
    norm = torch.where(wide, xf.sqrt((sq[:, :1] + sq[:, 1:2]) + sq[:, 2:]),
                       quat._norm(rot, keepdim=True))
    dq = quat.exp_so3(rot, norm=norm)
    q = graph.poses_q
    q2 = torch.where(wide, quat.quat_multiply_fma(q, dq),
                     quat.quat_multiply_fma(q, dq, fuse_second={1, 2}))
    uv = xf.cross(q[:, 1:], xi[:, 3:], fuse_second=True)
    uuv = xf.cross(q[:, 1:], uv)
    if k <= 8:
        uuv = torch.cat([xf.cross(q[:, 1:], uv, fuse_second=True)[:, :2],
                         uuv[:, 2:]], dim=-1)
    t2 = graph.poses_t + (xi[:, 3:] + xf.fma(q[:, :1], uv, uuv) * 2.0)
    return PoseGraph(poses_q=quat.quat_normalize(q2), poses_t=t2)


def _vector_poses(k: int) -> int:
    """How many of ``k`` poses the update's 8-wide loops take: they read
    3 of each pose's 6 step entries, and a vectorized loop with such gaps
    keeps a scalar remainder of at least one pose."""
    return 8 * ((k - 1) // 8)


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
        w = _graph_weights(cons, r, robust_delta)
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
