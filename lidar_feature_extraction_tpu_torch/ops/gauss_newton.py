"""Robust Gauss-Newton pose optimizer.

Port of ``lidar_feature_extraction_tpu/ops/gauss_newton.py:41-347``:
Huber-IRLS on MAD-normalized squared residual norms, the 7->6 quaternion
lift, an unrolled Cholesky solve behind the degeneracy guard, and the
reference's five status codes. One iteration is ``gn_iteration`` on the
device. Two loops drive it:

- ``run_gauss_newton``, the reference's ``lax.while_loop``: a Python
  loop around ``_gn_body`` (the iteration plus the loop's status logic on
  the device), reading the status back once per iteration; an abort
  reports the last accepted iteration's error and scale;
- ``run_gauss_newton_host``, the reference's host-stepped loop: the
  checks run in Python on the five scalars of each step, read in one go;
  an abort reports the aborting iteration's error and scale.

Every function here but the host-stepped loop also takes a leading
batch dimension: B scans registered in lock-step by
``run_gauss_newton_batched``, which does what JAX's ``vmap`` of the
reference's while-loop does (the body runs while any lane's condition
holds; a lane whose condition is false keeps its whole carry), with one
read per iteration of "is any lane still running".
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.core import stats
from lidar_feature_extraction_tpu_torch.core.pose import Pose
from lidar_feature_extraction_tpu_torch.ops import smallalg

# Status codes (parity: the reference's OptimizationResult constructors).
CONVERGED = 0
MAX_ITERATIONS = 1
ERROR_INCREASED = 2
SCALE_INCREASED = 3
EMPTY_INPUT = 4


class GNResult(NamedTuple):
    pose: Pose
    status: torch.Tensor      # int32 code above
    iterations: torch.Tensor  # int32
    error: torch.Tensor       # sum of squared residual norms
    scale: torch.Tensor       # MAD scale of the error vector
    # Weighted manifold Hessian M^T A M [6, 6] at the returned pose, in
    # tangent coordinates (dtheta_right, dt_world).
    hessian: torch.Tensor | None = None
    # Per-residual-block lower-middle median of the squared residual
    # norms at the returned pose ([n_blocks], make_problem's order).
    block_errors: torch.Tensor | None = None


class Problem(NamedTuple):
    """Stacked correspondences in row form (a batch adds a leading
    dimension to every tensor).

    jac_rows:  [M, 7] all jacobian rows (M = sum of N_b * D_b)
    res_rows:  [M] residual entries matching the rows
    errors:    [N] r_i . r_i per correspondence
    valid:     [N] per-correspondence validity
    shape:     ((N_b, D_b), ...) block structure
    """

    jac_rows: torch.Tensor
    res_rows: torch.Tensor
    errors: torch.Tensor
    valid: torch.Tensor
    shape: tuple


def rows_from_corr(problem: Problem, values: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-correspondence [..., N] vector to the [..., M]
    rows."""
    out = []
    offset = 0
    lead = values.shape[:-1]
    for n, d in problem.shape:
        seg = values[..., offset:offset + n]
        out.append(seg[..., None].expand(lead + (n, d)).reshape(
            lead + (n * d,)))
        offset += n
    return torch.cat(out, dim=-1)


def make_problem(blocks) -> Problem:
    """Stack ResidualBlocks (possibly of different row-dims D) into one
    row-form problem. Blocks of a batch ([..., N, D, 7] Jacobians) stack
    lane by lane."""
    jacs, ress, errs, valids, shape = [], [], [], [], []
    for b in blocks:
        *lead, n, d, _ = b.jacobian.shape
        jacs.append(b.jacobian.reshape(*lead, n * d, 7))
        ress.append(b.residual.reshape(*lead, n * d))
        errs.append(xf.sum_squares(b.residual))
        valids.append(b.valid)
        shape.append((n, d))
    return Problem(jac_rows=torch.cat(jacs, dim=-2),
                   res_rows=torch.cat(ress, dim=-1),
                   errors=torch.cat(errs, dim=-1),
                   valid=torch.cat(valids, dim=-1),
                   shape=tuple(shape))


def make_m(q: torch.Tensor) -> torch.Tensor:
    """7x6 manifold lift: dx(6) -> d(q, t)(7); top-left 4x3 is
    0.5 * L(q)[:, 1:]."""
    L = quat.left_multiplication_matrix(q)
    z43 = torch.zeros(L.shape[:-2] + (4, 3), dtype=L.dtype, device=L.device)
    z33 = torch.zeros(L.shape[:-2] + (3, 3), dtype=L.dtype, device=L.device)
    eye = torch.eye(3, dtype=L.dtype, device=L.device).expand(
        L.shape[:-2] + (3, 3))
    top = torch.cat([0.5 * L[..., :, 1:], z43], dim=-1)
    bot = torch.cat([z33, eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _lanewise(batched: bool, fn, *args):
    """``fn`` of one problem's tensors; for a batch (``batched``: a
    leading lane dimension on every argument), lane by lane on slices of
    the very shapes a lone problem has, the results stacked.
    The float sums of a reduction or a matmul run in an order that the
    kernel picks from the whole tensor's shape (a batch of 32 is summed
    otherwise than one problem), so only lane-by-lane calls give every
    lane the bits of its lone run. Elementwise work needs none of
    this."""
    if not batched:
        return fn(*args)
    lanes = [fn(*(a[b] for a in args)) for b in range(args[0].shape[0])]
    return tuple(torch.stack(out) for out in zip(*lanes))


def _normal_equations(jv, jw, j, wr, M):
    """(D, H, g) of one problem: the unweighted 7x7 Hessian, the
    weighted manifold Hessian M^T A M and gradient M^T b."""
    D = jv.T @ j
    A = jw.T @ j
    b = j.T @ wr
    return D, M.T @ A @ M, M.T @ b


def weighted_update(q: torch.Tensor, weights: torch.Tensor,
                    problem: Problem, degeneracy_threshold: float):
    """One GN solve: dx = -(M^T A M)^{-1} M^T b, or zero when the
    unweighted Hessian is degenerate or the solve is not finite.
    Returns ``(dx [..., 6], H [..., 6, 6])``.

    In float32 every step is the reference's jitted arithmetic
    (``core/_xla_dot.py``, ROADMAP §C21): D, A and b in XLA:CPU's
    summation order (on CUDA one launch of ``csrc/normal_equations.cu``
    for a problem or a batch, each lane summed in the lone problem's
    tree), ``M^T A M`` and ``M^T b`` as in-order FMA chains, and the
    Cholesky solve in its fused forms. Other dtypes sum a batch's normal
    equations lane by lane (``_lanewise``)."""
    w = torch.where(problem.valid, weights, 0.0)
    vf = problem.valid.to(problem.jac_rows.dtype)
    w_rows = rows_from_corr(problem, w)[..., None]
    v_rows = rows_from_corr(problem, vf)[..., None]
    j = problem.jac_rows
    jv, jw, wr = j * v_rows, j * w_rows, w_rows[..., 0] * problem.res_rows
    M = make_m(q)
    if j.dtype == torch.float32:
        D, A, b = xd.normal_equations(jv, jw, j, wr)
        mt = M.transpose(-1, -2)
        H = xf.matmul(xf.matmul(mt, A), M)
        dx = -xd.cholesky_solve(H, xf.matmul(mt, b[..., None])[..., 0])
    else:
        D, H, g = _lanewise(j.dim() == 3, _normal_equations, jv, jw, j, wr,
                            M)
        dx = -smallalg.cholesky_solve(H, g)

    degenerate = smallalg.min_eigval_below(D, degeneracy_threshold)
    bad = degenerate | ~torch.all(torch.isfinite(dx), dim=-1)
    return torch.where(bad[..., None], torch.zeros_like(dx), dx), H


class GNStep(NamedTuple):
    """Device outputs of one Gauss-Newton iteration (``gn_iteration``)."""

    pose: Pose              # the updated pose
    error: torch.Tensor     # sum of squared residual norms (this problem)
    scale: torch.Tensor     # MAD scale
    n_valid: torch.Tensor   # valid correspondence count, int32
    dq_norm: torch.Tensor   # |dq.vec| of the update
    dt_norm: torch.Tensor   # |dt|
    hessian: torch.Tensor | None = None  # M^T A M [6, 6] at the input pose


def gn_iteration(problem: Problem, pose: Pose, huber_k: float = 1.345,
                 degeneracy_threshold: float = 0.1) -> GNStep:
    """One Gauss-Newton iteration at ``pose`` on the device: the error,
    the MAD scale, the Huber-weighted solve and the updated pose, with no
    status logic (``_gn_body`` adds the fused loop's,
    ``run_gauss_newton_host`` runs the reference's on the host). In
    float32 the error total, the Huber weights and the pose update are
    the reference's jitted forms too (``core/_xla_dot.py``)."""
    n_valid = torch.sum(problem.valid, dim=-1, dtype=torch.int32)
    errors = torch.where(problem.valid, problem.errors, 0.0)
    if errors.dtype == torch.float32:
        error = xd.reduce_sum(errors)
    else:
        error, = _lanewise(errors.dim() == 2, lambda e: (torch.sum(e),),
                           errors)
    scale = stats.masked_scale_bisect(problem.errors, problem.valid)
    normalized = errors / (scale[..., None] + 1e-16)
    weights = stats.huber_derivative(normalized, huber_k)
    dx, hess = weighted_update(pose.q, weights, problem, degeneracy_threshold)
    dt = dx[..., 3:]
    if dx.dtype == torch.float32:
        q_new, dq = xd.pose_update(pose.q, dx)
    else:
        dq = quat.exp_so3(dx[..., :3])
        q_new = quat.quat_normalize(quat.quat_multiply(pose.q, dq))
    return GNStep(pose=Pose(q_new, pose.t + dt), error=error, scale=scale,
                  n_valid=n_valid, dq_norm=quat._norm(dq[..., 1:]),
                  dt_norm=quat._norm(dt), hessian=hess)


class _GNState(NamedTuple):
    q: torch.Tensor
    t: torch.Tensor
    prev_error: torch.Tensor
    prev_scale: torch.Tensor
    status: torch.Tensor
    hess: torch.Tensor
    block_meds: torch.Tensor


def _gn_body(problem_fn, state: _GNState, convergence_tol, huber_k,
             degeneracy_threshold, abort_on_increase) -> _GNState:
    """One iteration of the reference's while-loop body, on the device
    (for a batch, of every lane at once)."""
    q, t, prev_error, prev_scale = state.q, state.t, state.prev_error, \
        state.prev_scale
    problem = problem_fn(Pose(q, t))
    step = gn_iteration(problem, Pose(q, t), huber_k, degeneracy_threshold)

    meds, off = [], 0
    for n_b, _ in problem.shape:
        meds.append(stats._wide_median(problem.errors[..., off:off + n_b],
                                       problem.valid[..., off:off + n_b]))
        off += n_b
    block_meds = torch.stack(meds, dim=-1)

    empty = step.n_valid == 0
    err_up = (step.error > prev_error) & abort_on_increase
    scale_up = (step.scale > prev_scale) & abort_on_increase
    converged = ((step.dq_norm < convergence_tol)
                 & (step.dt_norm < convergence_tol))

    # Aborts keep the pre-update pose.
    abort = empty | err_up | scale_up
    abort_v = abort[..., None]
    code = lambda c: torch.full_like(state.status, c)  # noqa: E731
    status = torch.where(
        empty, code(EMPTY_INPUT),
        torch.where(err_up, code(ERROR_INCREASED),
                    torch.where(scale_up, code(SCALE_INCREASED),
                                torch.where(converged, code(CONVERGED),
                                            code(-1)))))
    return _GNState(q=torch.where(abort_v, q, step.pose.q),
                    t=torch.where(abort_v, t, step.pose.t),
                    prev_error=torch.where(abort, prev_error, step.error),
                    prev_scale=torch.where(abort, prev_scale, step.scale),
                    status=status, hess=step.hessian, block_meds=block_meds)


def run_gauss_newton(
    problem_fn: Callable[[Pose], Problem],
    initial_pose: Pose,
    max_iterations: int,
    convergence_tol: float = 1e-3,
    huber_k: float = 1.345,
    degeneracy_threshold: float = 0.1,
    abort_on_increase: bool = True,
) -> GNResult:
    """Iterate GN with correspondences recomputed by ``problem_fn`` at
    every pose, until a status is set or ``max_iterations`` bodies ran.
    ``abort_on_increase=False`` disables the error/scale-increase aborts
    (EMPTY_INPUT still terminates)."""
    dtype = initial_pose.t.dtype
    dev = initial_pose.t.device
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=dev)
    state = _GNState(q=initial_pose.q.to(dtype), t=initial_pose.t.to(dtype),
                     prev_error=big, prev_scale=big,
                     status=torch.full((), -1, dtype=torch.int32, device=dev),
                     hess=torch.zeros((6, 6), dtype=dtype, device=dev),
                     block_meds=None)
    it = 0
    while it < max_iterations:
        state = _gn_body(problem_fn, state, convergence_tol, huber_k,
                         degeneracy_threshold, abort_on_increase)
        it += 1
        if int(state.status) >= 0:   # the one readback per iteration
            break
    if state.block_meds is None:
        # No body ran: the reference reports its initial carry.
        n_blocks = len(problem_fn(initial_pose).shape)
        state = state._replace(block_meds=big.expand(n_blocks).clone())
    status = torch.where(state.status < 0,
                         torch.full_like(state.status, MAX_ITERATIONS),
                         state.status)
    return GNResult(pose=Pose(state.q, state.t), status=status,
                    iterations=torch.tensor(it, dtype=torch.int32,
                                            device=dev),
                    error=state.prev_error, scale=state.prev_scale,
                    hessian=state.hess, block_errors=state.block_meds)


def run_gauss_newton_batched(
    problem_fn: Callable[[Pose], Problem],
    initial_poses: Pose,
    max_iterations: int,
    convergence_tol: float = 1e-3,
    huber_k: float = 1.345,
    degeneracy_threshold: float = 0.1,
    abort_on_increase: bool = True,
) -> GNResult:
    """``run_gauss_newton`` for B problems in lock-step: ``initial_poses``
    holds q [B, 4] and t [B, 3], ``problem_fn`` maps such poses to a
    Problem with a leading batch dimension. Returns a GNResult whose
    fields have a leading [B].

    The semantics of JAX's ``vmap`` over the reference's while-loop: the
    body runs for every lane while any lane still runs (status < 0 and
    fewer than ``max_iterations`` bodies), and a lane that has stopped
    keeps its whole carry (pose, errors, status, Hessian, block
    medians, iteration count). So each lane's result is the one it
    would get alone. One host read per iteration."""
    dtype = initial_poses.t.dtype
    dev = initial_poses.t.device
    B = initial_poses.t.shape[0]
    big = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=dev)
    state = _GNState(q=initial_poses.q.to(dtype),
                     t=initial_poses.t.to(dtype),
                     prev_error=big.expand(B).clone(),
                     prev_scale=big.expand(B).clone(),
                     status=torch.full((B,), -1, dtype=torch.int32,
                                       device=dev),
                     hess=torch.zeros((B, 6, 6), dtype=dtype, device=dev),
                     block_meds=None)
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    for k in range(max_iterations):
        # A lane still running has run exactly k bodies, so its
        # "it < max_iterations" holds: running is status < 0.
        running = state.status < 0
        new = _gn_body(problem_fn, state, convergence_tol, huber_k,
                       degeneracy_threshold, abort_on_increase)
        # At k = 0 every lane runs.
        state = new if k == 0 else _GNState(*(
            torch.where(running.reshape((B,) + (1,) * (n.dim() - 1)), n, o)
            for n, o in zip(new, state)))
        it = it + running.to(torch.int32)
        if not bool((state.status < 0).any()):   # the one readback
            break
    if state.block_meds is None:
        # No body ran: the reference reports its initial carry.
        n_blocks = len(problem_fn(initial_poses).shape)
        state = state._replace(block_meds=big.expand(B, n_blocks).clone())
    status = torch.where(state.status < 0,
                         torch.full_like(state.status, MAX_ITERATIONS),
                         state.status)
    return GNResult(pose=Pose(state.q, state.t), status=status,
                    iterations=it, error=state.prev_error,
                    scale=state.prev_scale, hessian=state.hess,
                    block_errors=state.block_meds)


def _run_host(step_fn: Callable[[Pose], GNStep], initial_pose: Pose,
              max_iterations: int, convergence_tol: float):
    """``run_gauss_newton_host`` and its status as a Python int (the
    caller's round control reads it without another device read)."""
    dtype, dev = initial_pose.t.dtype, initial_pose.t.device
    pose, out = initial_pose, None
    prev_error = prev_scale = float("inf")
    error = scale = 0.0
    status, it = MAX_ITERATIONS, 0
    for it in range(1, max_iterations + 1):
        out = step_fn(pose)
        # The one read per iteration; float32 to float is exact.
        n_valid, error, scale, dq_norm, dt_norm = torch.stack([
            v.to(torch.float64) for v in (out.n_valid, out.error, out.scale,
                                          out.dq_norm, out.dt_norm)
        ]).tolist()
        if n_valid == 0:
            status = EMPTY_INPUT
            break
        if error > prev_error:
            status = ERROR_INCREASED
            break
        prev_error = error
        if scale > prev_scale:
            status = SCALE_INCREASED
            break
        prev_scale = scale
        pose = out.pose
        if dq_norm < convergence_tol and dt_norm < convergence_tol:
            status = CONVERGED
            break
    result = GNResult(
        pose=pose,
        status=torch.full((), status, dtype=torch.int32, device=dev),
        iterations=torch.full((), it, dtype=torch.int32, device=dev),
        error=torch.full((), error, dtype=dtype, device=dev),
        scale=torch.full((), scale, dtype=dtype, device=dev),
        hessian=None if out is None else out.hessian)
    return result, status


def run_gauss_newton_host(step_fn: Callable[[Pose], GNStep],
                          initial_pose: Pose, max_iterations: int,
                          convergence_tol: float = 1e-3) -> GNResult:
    """Gauss-Newton with the reference's loop control on the host:
    ``step_fn(pose) -> GNStep`` is one device iteration, and the checks
    run in Python in ``Optimizer::Run``'s order (empty input, error up,
    scale up, accept, convergence). An abort keeps the pre-update pose
    and reports the aborting iteration's error and scale; running out of
    iterations is MAX_ITERATIONS, with no Hessian when no step ran. No
    block errors. One device read per iteration."""
    return _run_host(step_fn, initial_pose, max_iterations,
                     convergence_tol)[0]
