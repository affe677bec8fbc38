"""IMU-aware keyframe graph: poses + velocities, relative-pose
constraints and preintegrated-IMU factors, on one device or sharded over
a process group.

Port of ``lidar_feature_extraction_tpu/parallel/imu_graph.py``. Both
factor families are linearized with ``torch.func.jacfwd`` under
``torch.func.vmap``, in torch's plain exponential and logarithmic maps
(``plain=True``), not yet in the forms of the reference's program
(ROADMAP §C24; ``pose_graph.py`` writes its forward mode out), and
reduced to dense [9K, 9K] normal equations by ``pose_graph.py``'s
scatter. With ``group=`` (the reference's ``axis_name``) each
rank holds the graph whole and its shard of the factors and constraints
(each IMU factor on the same rank as the chain constraint over its
pair), and the sums are ``all_reduce``d where the reference ``psum``s:
the gyro-bias normal equations, H and g, and the cost that decides the
Levenberg-Marquardt accept, so every rank takes the same decision.

The numerical choices are the reference's: the shared gyro bias is
estimated first by the decoupled rotation-only solve
(``estimate_gyro_bias``) and folded into the factor deltas through the
first-order bias Jacobians; the trajectory step then runs on the
Jacobi-equilibrated system with a Levenberg-Marquardt ``lam`` that stays
at zero until a step is rejected, and a step is accepted when it raises
the cost by at most 0.1%. The accept decision is a ``torch.where`` on
the device: no step reads the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.fusion.imu import GRAVITY
from lidar_feature_extraction_tpu_torch.parallel.mesh import psum
from lidar_feature_extraction_tpu_torch.parallel.pose_graph import (
    Constraints, _robust_weights, _weighted_jacobians,
    scatter_normal_equations)


def _pose_residual(qi, ti, qj, tj, z_q, z_t):
    """``pose_graph.constraint_residual`` in torch's plain forms, which
    ``torch.func`` batches and differentiates."""
    rel_q = quat.quat_multiply(quat.quat_conjugate(qi), qj)
    rel_t = quat.quat_rotate(quat.quat_conjugate(qi), tj - ti, plain=True)
    err_q = quat.quat_multiply(quat.quat_conjugate(z_q), rel_q)
    err_t = quat.quat_rotate(quat.quat_conjugate(z_q), rel_t - z_t,
                             plain=True)
    return torch.cat([quat.log_so3(err_q, plain=True), err_t], dim=-1)


def _jac(f, x):
    """``jacfwd(f)(x)`` in ``x``'s dtype: forward mode promotes a Python
    float times a 0-d float32 tensor to a float64 tangent, so some
    columns would come out in float64."""
    return jacfwd(f)(x).to(x.dtype)


class ImuGraph(NamedTuple):
    poses_q: torch.Tensor   # [K, 4]
    poses_t: torch.Tensor   # [K, 3]
    vels: torch.Tensor      # [K, 3] world-frame velocities
    # Shared IMU biases ([3]; None disables). A non-None ``bg`` enables
    # the decoupled gyro-bias estimate, seeded with its value (relative
    # to the factors' linearization bias); ``ba`` is a fixed first-order
    # correction, never estimated. Both need the factors' bias Jacobians.
    bg: torch.Tensor | None = None
    ba: torch.Tensor | None = None


class ImuFactors(NamedTuple):
    """Batched preintegrated-IMU factors between keyframes i and j.
    w_rot / w_vel / w_pos: per-block scalar information (1/sigma^2);
    weight 0 masks a lane; the optional [M, 3, 3] blocks are the stacked
    first-order bias Jacobians, needed for bias estimation."""

    i: torch.Tensor        # [M]
    j: torch.Tensor        # [M]
    dq: torch.Tensor       # [M, 4]
    dv: torch.Tensor       # [M, 3]
    dp: torch.Tensor       # [M, 3]
    dt: torch.Tensor       # [M]
    w_rot: torch.Tensor    # [M]
    w_vel: torch.Tensor    # [M]
    w_pos: torch.Tensor    # [M]
    weight: torch.Tensor   # [M] overall scale (0 masks)
    dq_dbg: torch.Tensor | None = None
    dv_dbg: torch.Tensor | None = None
    dv_dba: torch.Tensor | None = None
    dp_dbg: torch.Tensor | None = None
    dp_dba: torch.Tensor | None = None


def imu_residual_9(qi, ti, vi, qj, tj, vj, dq, dv, dp, dt, gravity=GRAVITY):
    """[9] residual (theta, v, p) of one preintegrated factor."""
    gravity = torch.as_tensor(gravity, dtype=ti.dtype, device=ti.device)
    qi_inv = quat.quat_conjugate(qi)
    rel_q = quat.quat_multiply(qi_inv, qj)
    r_theta = quat.log_so3(quat.quat_multiply(quat.quat_conjugate(dq), rel_q),
                           plain=True)
    r_v = quat.quat_rotate(qi_inv, vj - vi - gravity * dt, plain=True) - dv
    r_p = quat.quat_rotate(
        qi_inv, tj - ti - vi * dt - 0.5 * gravity * dt * dt, plain=True) - dp
    return torch.cat([r_theta, r_v, r_p], dim=-1)


def _perturb9(q, t, v, xi):
    """Right perturbation of a 9-dim state: (dtheta, dt_local, dv)."""
    return (quat.quat_multiply(q, quat.exp_so3(xi[:3], plain=True)),
            t + quat.quat_rotate(q, xi[3:6], plain=True), v + xi[6:9])


def _linearize_imu_one(qi, ti, vi, qj, tj, vj, dq, dv, dp, dt):
    r = imu_residual_9(qi, ti, vi, qj, tj, vj, dq, dv, dp, dt)

    def fi(xi):
        return imu_residual_9(*_perturb9(qi, ti, vi, xi), qj, tj, vj, dq, dv,
                              dp, dt)

    def fj(xi):
        return imu_residual_9(qi, ti, vi, *_perturb9(qj, tj, vj, xi), dq, dv,
                              dp, dt)

    zero = torch.zeros(9, dtype=qi.dtype, device=qi.device)
    return r, _jac(fi, zero), _jac(fj, zero)


_linearize_imu = vmap(_linearize_imu_one)


def _linearize_pose_one(qi, ti, qj, tj, z_q, z_t):
    r = _pose_residual(qi, ti, qj, tj, z_q, z_t)
    v0 = torch.zeros(3, dtype=qi.dtype, device=qi.device)

    def fi(xi):
        q2, t2, _ = _perturb9(qi, ti, v0, xi)
        return _pose_residual(q2, t2, qj, tj, z_q, z_t)

    def fj(xi):
        q2, t2, _ = _perturb9(qj, tj, v0, xi)
        return _pose_residual(qi, ti, q2, t2, z_q, z_t)

    zero = torch.zeros(9, dtype=qi.dtype, device=qi.device)
    return r, _jac(fi, zero), _jac(fj, zero)


_linearize_pose = vmap(_linearize_pose_one)


def _scatter(h, g, bi, bj, r, ji, jj, wji, wjj):
    """Accumulate one factor family's weighted blocks into H [9K, 9K],
    g [9K] (``wji = Lambda Ji``)."""
    return scatter_normal_equations(h, g, bi, bj, r, ji, jj, wji, wjj, 9)


def fold_bias_into_factors(imu: ImuFactors, dbg, dba) -> ImuFactors:
    """Move the factors' linearization point by (dbg, dba) through the
    stored first-order Jacobians (re-linearization without
    re-integration); the Jacobians are kept for further shifts."""
    dtheta = torch.einsum("mij,j->mi", imu.dq_dbg, dbg)
    dq2 = quat.quat_normalize(quat.quat_multiply(
        imu.dq, quat.exp_so3(dtheta, plain=True)))
    dv2 = imu.dv + torch.einsum("mij,j->mi", imu.dv_dbg, dbg) \
        + torch.einsum("mij,j->mi", imu.dv_dba, dba)
    dp2 = imu.dp + torch.einsum("mij,j->mi", imu.dp_dbg, dbg) \
        + torch.einsum("mij,j->mi", imu.dp_dba, dba)
    return imu._replace(dq=dq2, dv=dv2, dp=dp2)


def _bias_residual(dq, j_dbg, z, bg):
    dq_b = quat.quat_multiply(dq, quat.exp_so3(j_dbg @ bg, plain=True))
    return quat.log_so3(quat.quat_multiply(quat.quat_conjugate(dq_b), z),
                        plain=True)


def _bias_linearize_one(dq, j_dbg, z, bg):
    r = _bias_residual(dq, j_dbg, z, bg)
    return r, _jac(lambda b: _bias_residual(dq, j_dbg, z, b), bg)


_bias_linearize = vmap(_bias_linearize_one, in_dims=(0, 0, 0, None))


def estimate_gyro_bias(imu: ImuFactors, cons: Constraints, bg0=None,
                       prior_weight: float = 2500.0,
                       n_iterations: int = 8, group=None) -> torch.Tensor:
    """Decoupled rotation-only gyro-bias estimate (the VINS-Mono
    initialization scheme): Newton steps on

        sum_m w_m || log( (dq_m exp(J_m bg))^-1 z_q_m ) ||^2
            + prior_weight ||bg||^2

    with z_q_m the measured rotation of the chain constraint over the
    same keyframe pair (factors with none drop out). With ``group`` the
    3x3 normal equations are summed over its ranks."""
    dtype, dev = imu.dq.dtype, imu.dq.device
    bg = torch.zeros(3, dtype=dtype, device=dev) if bg0 is None else bg0
    same = (cons.i[None, :] == imu.i[:, None]) \
        & (cons.j[None, :] == imu.j[:, None]) \
        & (cons.weight[None, :] > 0)
    has = torch.any(same, dim=1)
    idx = torch.argmax(same.to(torch.int32), dim=1)
    z_q = cons.z_q[idx]
    w = imu.weight * imu.w_rot * has.to(dtype)
    eye = torch.eye(3, dtype=dtype, device=dev)
    for _ in range(n_iterations):
        r, j = _bias_linearize(imu.dq, imu.dq_dbg, z_q, bg)
        h = psum(torch.einsum("mki,m,mkj->ij", j, w, j), group) \
            + prior_weight * eye
        g = psum(torch.einsum("mki,m,mk->i", j, w, r), group) \
            + prior_weight * bg
        bg = bg - torch.linalg.solve_ex(h, g)[0]
    return bg


def _cast_floats(nt, dtype, device):
    """Floating fields of a NamedTuple in ``dtype`` (host-built factors
    must not promote the state), every field on ``device``."""
    if nt is None:
        return None
    return type(nt)(*[
        None if a is None else torch.as_tensor(
            a, dtype=dtype if torch.as_tensor(a).is_floating_point()
            else None, device=device)
        for a in nt])


def optimize_imu_graph(graph: ImuGraph, cons: Constraints | None,
                       imu: ImuFactors | None,
                       n_iterations: int = 10,
                       prior_weight: float = 1e6,
                       damping: float = 1e-4,
                       robust_delta: float | None = None,
                       bias_prior_weight: float = 2500.0,
                       group=None) -> ImuGraph:
    """Gauss-Newton over (pose, velocity) keyframe states with
    relative-pose constraints and IMU factors: the gauge prior on pose 0,
    Levenberg damping, an optional Geman-McClure kernel on the pose
    constraints, and, with ``graph.bg`` set, the decoupled gyro-bias
    estimate folded into the factors first. With ``group`` (``cons``
    and ``imu`` this rank's shards) the bias solve, H, g and the accept
    cost are summed over its ranks."""
    k = graph.poses_q.shape[0]
    dim = 9 * k
    dtype, dev = graph.poses_t.dtype, graph.poses_t.device
    cons = _cast_floats(cons, dtype, dev)
    imu = _cast_floats(imu, dtype, dev)

    have_jac = imu is not None and imu.dq_dbg is not None
    bg_out = graph.bg
    if have_jac and (graph.bg is not None or graph.ba is not None):
        zero3 = torch.zeros(3, dtype=dtype, device=dev)
        ba = zero3 if graph.ba is None else graph.ba
        if graph.bg is not None and cons is not None:
            bg_out = estimate_gyro_bias(imu, cons, bg0=graph.bg,
                                        prior_weight=bias_prior_weight,
                                        group=group)
        imu = fold_bias_into_factors(
            imu, zero3 if bg_out is None else bg_out, ba)

    def imu_w9():
        m = imu.i.shape[0]
        return torch.cat([
            (imu.weight * imu.w_rot)[:, None].expand(m, 3),
            (imu.weight * imu.w_vel)[:, None].expand(m, 3),
            (imu.weight * imu.w_pos)[:, None].expand(m, 3)], dim=-1)

    def pose_args(g):
        i, j = cons.i.long(), cons.j.long()
        return (g.poses_q[i], g.poses_t[i], g.poses_q[j], g.poses_t[j],
                cons.z_q, cons.z_t)

    def imu_args(g):
        i, j = imu.i.long(), imu.j.long()
        return (g.poses_q[i], g.poses_t[i], g.vels[i], g.poses_q[j],
                g.poses_t[j], g.vels[j], imu.dq, imu.dv, imu.dp, imu.dt)

    def cost(g, w_cons):
        """Weighted squared cost at frozen IRLS weights, summed over the
        ranks (the same on each, so the accept below is too)."""
        c = torch.zeros((), dtype=dtype, device=dev)
        if cons is not None:
            r = _pose_residual(*pose_args(g))
            if cons.info is not None:
                rr = torch.einsum("mi,mij,mj->m", r, cons.info, r)
            else:
                rr = torch.sum(r * r, dim=-1)
            c = c + torch.sum(w_cons * rr)
        if imu is not None:
            r = vmap(imu_residual_9)(*imu_args(g))
            c = c + torch.sum(imu_w9() * r * r)
        return psum(c, group)

    prior = torch.zeros(dim, dtype=dtype, device=dev)
    prior[:6] = prior_weight
    diag = torch.diag(prior + damping)
    eye = torch.eye(dim, dtype=dtype, device=dev)
    graph = graph._replace(bg=bg_out)
    lam = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(n_iterations):
        h = torch.zeros((dim, dim), dtype=dtype, device=dev)
        g = torch.zeros((dim,), dtype=dtype, device=dev)
        w_cons = None
        if cons is not None:
            r, ji, jj = _linearize_pose(*pose_args(graph))
            w_cons = _robust_weights(cons, r, robust_delta)
            wji, wjj = _weighted_jacobians(cons, w_cons, ji, jj)
            h, g = _scatter(h, g, cons.i, cons.j, r, ji, jj, wji, wjj)
        if imu is not None:
            r, ji, jj = _linearize_imu(*imu_args(graph))
            w9 = imu_w9()
            h, g = _scatter(h, g, imu.i, imu.j, r, ji, jj,
                            w9[:, :, None] * ji, w9[:, :, None] * jj)

        h = psum(h, group) + diag
        g = psum(g, group)
        # Jacobi equilibration: the raw system spans ~10 orders of
        # magnitude (gauge prior 1e6, IMU information ~1e5, damping 1e-4),
        # beyond a float32 solve; LM's lam rides on the unit diagonal.
        d = torch.sqrt(torch.clamp_min(torch.diagonal(h), 1e-12))
        hn = h / d[:, None] / d[None, :]
        hn = hn + lam * eye
        dx = -torch.linalg.solve_ex(hn, g / d)[0] / d

        xi = dx.reshape(k, 9)
        dq = quat.exp_so3(xi[:, :3], plain=True)
        cand = ImuGraph(
            poses_q=quat.quat_normalize(quat.quat_multiply(graph.poses_q,
                                                           dq)),
            poses_t=graph.poses_t + quat.quat_rotate(
                graph.poses_q, xi[:, 3:6], plain=True),
            vels=graph.vels + xi[:, 6:9], bg=graph.bg, ba=graph.ba)
        # Near-neutral acceptance (0.1% slack): plateau-crossing steps
        # pass, blow-ups (orders of magnitude) do not.
        accept = cost(cand, w_cons) <= cost(graph, w_cons) * 1.001
        graph = ImuGraph(*[None if a is None else torch.where(accept, a, b)
                           for a, b in zip(cand, graph)])
        # lam stays zero (pure Gauss-Newton) until a step is rejected,
        # then classic LM escalation until steps accept again.
        lam = torch.where(accept, lam / 3.0,
                          torch.clamp(lam * 4.0, 1e-4, 1e6))
    return graph


def weights_from_covariance(cov: torch.Tensor,
                            max_weight: float = 1e5) -> tuple:
    """(w_rot, w_vel, w_pos) scalar information from a [..., 9, 9]
    preintegration covariance: the inverse mean diagonal of each
    3-block, capped at ``max_weight``."""
    d = torch.diagonal(cov, dim1=-2, dim2=-1)
    eps = 1e-12
    return tuple(
        torch.clamp_max(1.0 / (torch.mean(d[..., a:a + 3], dim=-1) + eps),
                        max_weight)
        for a in (0, 3, 6))
