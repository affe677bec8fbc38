"""The float32 Gauss-Newton update as the JAX package's jitted code
computes it on the CPU, for the sites where the port's results must
equal the reference's bit for bit (ROADMAP §C21).

XLA:CPU runs ``weighted_update``'s (``ops/gauss_newton.py``) products
in three ways, each with its own order of float32 sums:

- the Hessians ``D = (j v)^T j`` and ``A = (j w)^T j`` ([7, M] x [M, 7])
  are Eigen tensor contractions on XLA's intra-op thread pool, with a
  oneDNN ``sgemm`` inside each task. The summation tree is a function of
  M and of the thread count (``contraction_tree``); within each chunk of
  rows the sum is a fused multiply-add chain from +0 in row order;
- the gradient ``b = j^T (w r)`` (``w r`` rounded first, in a fusion of
  its own) is, from 4,096 rows, XLA's tiled row-major matrix-vector
  loop: eight lanes, lane l an FMA chain over rows l, l + 8, ..., the
  lanes added as (l, l + 4), then (l, l + 2), then (0, 1), and the last
  M mod 8 rows an FMA chain of their own added last; below 4,096 rows
  XLA fuses the transpose into a naive dot loop that LLVM vectorizes:
  a rounded product at one row, one FMA chain per column up to 49
  rows, else 8-lane registers (2 or 4 a trip) with an epilogue loop and
  a scalar tail, whose order ``gemv_loop`` and ``_gemv_fused`` give
  (``gemv_plain``; ROADMAP §C22);
- the small products after them (``M^T A M``, ``M^T b``) are FMA chains
  from the first product in index order (``_xla_f32.matmul``), and the
  unrolled Cholesky solve, the exponential map and the quaternion update
  are fused as ``cholesky_solve`` and ``pose_update`` say; the error
  total is XLA's tree reduction (``reduce_sum``).

The order of the contraction was read from ±2^40 probe pairs (the
leftover of ``a.T @ b`` counts the rows summed after the pair met) and
confirmed bit for bit on random data at 49 row counts from 1 to 40,960
and on every update of eval_ate.py's two drives, read from the jitted
program with ``jax.debug.callback`` (the drive record,
``tests/data/torch_reference_drive.npz``, keeps the reference's sums and
its manifest these parameters). The small gradient's order was read
from the fusion's optimized LLVM IR and its x86 code (the backend
reassociates a loop that is unrolled whole) and confirmed bit for bit at
every row count from 1 to 4,199 and on the first update of the jitted
``localize_scan`` at two cut widths (also in the drive record).

In float32 every function here computes those forms; ``normal_equations``
sends CUDA tensors to the kernel ``csrc/normal_equations.cu`` (one launch
for a problem or a batch) and CPU tensors to ``normal_equations_plain``,
and ``gn_update`` (everything after the normal equations: the solve, the
degeneracy guard and the pose update) sends them to ``csrc/gn_update.cu``
and to ``gn_update_plain``. Other dtypes keep one rounding per operation
in torch's order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
from lidar_feature_extraction_tpu_torch.core import quaternion as quat
from lidar_feature_extraction_tpu_torch.ops import smallalg

# The intra-op threads XLA:CPU's Eigen pool had on the machine that wrote
# the drive record (its manifest's cpu_count): the contraction tree below
# is the one this many threads give.
XLA_CPU_THREADS = 8

# The contraction of [M, 7]^T [M, 7] at XLA_CPU_THREADS threads:
# - M <= SHARD_ABOVE: one task. Eigen's single-threaded block size k_c is
#   SINGLE_KC with its "last block as large as possible" adjustment,
#   TensorFlow's contraction kernel evens the slices (a multiple of 8),
#   and oneDNN's sgemm splits a slice longer than DNNL_K_BLOCK in two
#   (the first half the larger);
# - above it Eigen shards the rows: 6 blocks up to EIGHT_ABOVE, then
#   XLA_CPU_THREADS, each a multiple of 8 rows; a block is sliced as
#   above with k_c = THREADED_KC; the blocks' partial sums are added in
#   groups of four as (b0 + b1) + (b2 + b3) for the first
#   PACKET_ENTRIES entries of the row-major 7 x 7 output (its packets)
#   and as b0 + ((b1 + b2) + b3) for the last; a short group in order;
#   the groups in order.
SINGLE_KC = 608
THREADED_KC = 320
DNNL_K_BLOCK = 384
SHARD_ABOVE = 7990
EIGHT_ABOVE = 8197
GROUP = 4
PACKET_ENTRIES = 48

# The gradient b = j^T (w r) ([M, 7]^T [M]). From GEMV_TILED_FROM rows
# XLA:CPU runs its tiled matrix-vector loop. Below, it fuses the transpose
# into the dot and emits a naive loop (per column, acc += j[k] * v[k]
# with a reassociable add), which LLVM vectorizes for the x86 target
# (8 float32 lanes, the product fused into the add):
# - 1 row: one rounded product; up to GEMV_SERIAL_MAX rows the row loop is
#   unrolled first and the columns vectorized: one FMA chain per column
#   from +0 in row order;
# - above, a vector loop of 2 registers (16 rows) a trip up to
#   GEMV_INTERLEAVE2_MAX rows, else 4 (32 rows), over (M - 1) // width
#   trips, one row always left to the scalar loop; lane l of register u
#   is an FMA chain over rows width * i + 8u + l, lane 0 of register 0
#   from +0 and every other lane from -0; the registers are added in
#   order and the lanes as (l, l + 4), (l, l + 2), (0, 1);
# - up to GEMV_FULL_UNROLL trips the loop is unrolled whole and the
#   backend reassociates: one register's chain from the start vector
#   over register 0's trips in order, then each other register's trips
#   with the first two swapped (trips 1, 0, 2, 3, ...);
# - an epilogue loop of 2, 4 or 8 lanes (by the cost of the M mod width
#   rows left, gemv_loop) starts from the sum in lane 0 and -0 in the
#   others, and is reduced the same way; the scalar loop then goes on
#   as one FMA chain from that sum.
GEMV_TILED_FROM = 4096
GEMV_SERIAL_MAX = 49
GEMV_INTERLEAVE2_MAX = 64
GEMV_FULL_UNROLL = 10


def _slices(k: int, kc: int) -> list[tuple[int, int]]:
    """TensorFlow's contraction kernel: ``k`` rows in slices of about
    ``kc``, evened to a multiple of 8."""
    n = max(1, -(-k // kc))
    bk = min(k, -(-(k // n) // 8) * 8)
    return [(lo, min(lo + bk, k)) for lo in range(0, k, bk)]


def _single_kc(k: int) -> int:
    """Eigen's single-threaded k_c for ``k`` rows."""
    if k <= SINGLE_KC or k % SINGLE_KC == 0:
        return min(k, SINGLE_KC)
    return SINGLE_KC - 8 * ((SINGLE_KC - 1 - k % SINGLE_KC)
                            // (8 * (k // SINGLE_KC + 1)))


@functools.lru_cache(maxsize=64)
def contraction_tree(m: int) -> tuple[bool, tuple]:
    """(sharded, blocks): the chunks of rows ``[lo, hi)`` of each block,
    in order, of XLA:CPU's [M, 7]^T [M, 7] contraction at
    ``XLA_CPU_THREADS`` threads. Unsharded there is one block."""
    if m <= SHARD_ABOVE:
        chunks = []
        for lo, hi in _slices(m, _single_kc(m)):
            if hi - lo > DNNL_K_BLOCK:
                mid = lo + -(-(hi - lo) // 2)
                chunks += [(lo, mid), (mid, hi)]
            else:
                chunks.append((lo, hi))
        return False, (tuple(chunks),)
    threads = 6 if m <= EIGHT_ABOVE else XLA_CPU_THREADS
    bs = max(96, -(-(-(-m // threads)) // 8) * 8)
    blocks = []
    for b0 in range(0, m, bs):
        size = min(bs, m - b0)
        kc = THREADED_KC if size > THREADED_KC else size
        blocks.append(tuple((b0 + lo, b0 + hi)
                            for lo, hi in _slices(size, kc)))
    return True, tuple(blocks)


def _chains(a: torch.Tensor, b: torch.Tensor, rows: tuple,
            init: torch.Tensor | None = None) -> torch.Tensor:
    """Float32 FMA chains from ``init`` (float32, broadcast to
    [..., C, I, J]; +0 when None): for each chain c (``rows[c]``, row
    indices in order), ``acc = fma(a[k, i], b[k, j], acc)`` over its
    rows. ``a`` [..., M, I], ``b`` [..., M, J] -> [..., C, I, J].

    Each step adds the exact float64 product to the float64 accumulator
    and rounds to float32; that is the correctly rounded FMA unless the
    float64 sum was inexact and landed exactly on a float32 halfway
    point (or in the float32 subnormal range), which is checked after
    the loop and then the chains are recomputed with
    ``_xla_f32._fma_plain``. Chains of unequal length are padded with -0
    products, which add nothing. On the CPU the work runs in numpy,
    whose calls on small arrays cost a fraction of torch's (a chain has
    up to M / 8 steps)."""
    out_shape = (*a.shape[:-2], len(rows), a.shape[-1], b.shape[-1])
    init = (a.new_zeros(out_shape) if init is None
            else init.to(a.device).expand(out_shape))
    if max((len(r) for r in rows), default=0) == 0:
        return init.clone()
    index, pad = _chain_index(rows)
    cpu = a.device.type == "cpu"
    if cpu:
        lib, f64 = np, np.float64
        ga, gb = a.numpy()[..., index, :], b.numpy()[..., index, :]
    else:
        lib, f64 = torch, torch.float64
        index = torch.as_tensor(index, device=a.device)
        ga, gb = a[..., index, :], b[..., index, :]
    # step-major: ga [..., L, C, I], gb [..., L, C, J]
    prod = np.multiply(ga[..., :, None], gb[..., None, :], dtype=f64) \
        if cpu else ga[..., :, None].to(f64) * gb[..., None, :].to(f64)
    if pad is not None:
        prod[..., torch.as_tensor(pad) if not cpu else pad, :, :] = -0.0
    sums = lib.empty_like(prod)
    acc = init.numpy().astype(f64) if cpu else init.double()
    for k in range(index.shape[0]):
        step = sums[..., k, :, :, :]
        lib.add(prod[..., k, :, :, :], acc, out=step)
        acc = (step.astype(np.float32).astype(f64) if cpu
               else step.float().double())
    if _inexact(sums, prod, init, cpu):
        return _chains_exact(torch.as_tensor(ga), torch.as_tensor(gb), pad,
                             init)
    last = sums[..., -1, :, :, :]
    return torch.from_numpy(last.astype(np.float32)) if cpu else last.float()


def _inexact(sums, prod, init: torch.Tensor, cpu: bool) -> bool:
    """Whether a step of ``_chains`` may have rounded otherwise than one
    FMA: its float64 sum lies in the float32 subnormal range, or it is a
    float32 halfway point that the float64 addition reached inexactly
    (TwoSum's error, checked on those steps only)."""
    if cpu:
        magnitude = np.abs(sums)
        if np.count_nonzero((magnitude < 2.0 ** -126) & (magnitude > 0)):
            return True
        halfway = np.bitwise_and(sums.view(np.int64), 0x1FFFFFFF) \
            == 0x10000000
        if not np.count_nonzero(halfway):
            return False
    else:
        bits = sums.view(torch.int64)
        magnitude = bits & 0x7FFFFFFFFFFFFFFF
        if bool(((magnitude != 0) & (magnitude < 0x3810000000000000)).any()):
            return True                                   # below 2^-126
        halfway = (bits & 0x1FFFFFFF) == 0x10000000
        if not bool(halfway.any()):
            return False
    at = halfway.nonzero() if cpu else halfway.nonzero(as_tuple=True)
    step = at[-4]
    prev_at = (*at[:-4], step - 1, *at[-3:])
    prev = sums[prev_at]
    prev = (prev.astype(np.float32).astype(np.float64) if cpu
            else prev.float().double())
    first = step == 0
    if first.any():
        start = (init.numpy() if cpu else init)[tuple(
            i[first] for i in (*at[:-4], *at[-3:]))]
        prev[first] = start.astype(np.float64) if cpu else start.double()
    s, p = sums[at], prod[at]
    v = s - p
    return bool((((p - (s - v)) + (prev - v)) != 0).any())


def _chains_exact(ga, gb, pad, init) -> torch.Tensor:
    """``_chains`` by ``_xla_f32._fma_plain`` step by step (the slow,
    always exact path) from the gathered operands."""
    acc = init.clone()
    for k in range(ga.shape[-3]):
        nxt = xf._fma_plain(ga[..., k, :, :, None], gb[..., k, :, None, :],
                            acc)
        acc = nxt if pad is None else torch.where(
            torch.as_tensor(pad[k], device=acc.device)[:, None, None], acc,
            nxt)
    return acc


@functools.lru_cache(maxsize=64)
def _chain_index(rows: tuple):
    """The step-major row index [L, C] of the chains ``rows`` (numpy), and
    the mask of their padding steps (None when all have L rows)."""
    length = max(len(r) for r in rows)
    index = np.array([list(r) + [0] * (length - len(r)) for r in rows]).T
    pad = np.array([[k >= len(r) for r in rows] for k in range(length)])
    return np.ascontiguousarray(index), (pad if pad.any() else None)


def _fold(terms):
    """``((t0 + t1) + t2) + ...`` in float32."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _add_blocks(parts: list[torch.Tensor]) -> torch.Tensor:
    """Eigen's sum of the sharded blocks' partial sums [..., 14, 7] (two
    7 x 7 outputs side by side): groups of four, then the groups."""
    groups = []
    for g in range(0, len(parts), GROUP):
        b = parts[g:g + GROUP]
        if len(b) < GROUP:
            groups.append(_fold(b))
            continue
        packets = (b[0] + b[1]) + (b[2] + b[3])
        tail = b[0] + ((b[1] + b[2]) + b[3])
        flat = packets.unflatten(-2, (2, 7)).flatten(-2)
        flat[..., PACKET_ENTRIES:] = tail.unflatten(
            -2, (2, 7)).flatten(-2)[..., PACKET_ENTRIES:]
        groups.append(flat.unflatten(-1, (7, 7)).flatten(-3, -2))
    return _fold(groups)


def _lane_tree(s: torch.Tensor) -> torch.Tensor:
    """The horizontal sum of a vector register, lanes on axis -3
    ([..., L, I, J], L a power of two): lane l plus lane l + L/2, then
    the same on the lower half, down to one (x86's shuffle reduction)."""
    while s.shape[-3] > 1:
        half = s.shape[-3] // 2
        s = s[..., :half, :, :] + s[..., half:, :, :]
    return s[..., 0, :, :]


def _lane_init(lanes: int, first: torch.Tensor | None,
               like: torch.Tensor) -> torch.Tensor:
    """A reduction's start vector [..., lanes, 7, 1]: ``first`` (or +0)
    in lane 0, -0 (the identity of a reassociable sum) in the others."""
    init = like.new_full((*like.shape[:-2], lanes, like.shape[-1], 1), -0.0)
    init[..., 0, :, :] = 0.0 if first is None else first[..., None]
    return init


def gemv_loop(m: int) -> tuple:
    """The loop LLVM makes of XLA:CPU's gradient fusion for ``m`` rows
    (1 < ``m`` < ``GEMV_TILED_FROM``): (width, trips, unrolled,
    epilogue width, epilogue trips), where ``width`` rows (``width`` / 8
    registers of 8 lanes) go in each of the vector loop's ``trips``, the
    ``epilogue`` loop takes ``epilogue`` rows at a time and the scalar
    loop the rest; (0, 0, False, 0, 0) for a scalar loop."""
    if m <= GEMV_SERIAL_MAX:
        return 0, 0, False, 0, 0
    width = 8 * (2 if m <= GEMV_INTERLEAVE2_MAX else 4)
    trips = (m - 1) // width         # one row is always left to the scalar
    rem = m % width
    if rem < 2:
        epilogue = 0
    elif rem < 4 or rem in (6, 7):
        epilogue = 2
    else:
        epilogue = 8 if rem >= 8 and rem % 8 < 4 else 4
    etrips = (m - 1 - trips * width) // epilogue if epilogue else 0
    return width, trips, trips <= GEMV_FULL_UNROLL, epilogue, etrips


def _gemv_fused(jt_rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``gemv_plain`` below ``GEMV_TILED_FROM`` rows: the vectorized loop
    of ``gemv_loop(M)``, per output column (float32)."""
    m = jt_rows.shape[-2]
    b = v[..., None]
    if m == 1:
        return jt_rows[..., 0, :] * v[..., :1]
    width, trips, unrolled, epilogue, etrips = gemv_loop(m)
    s, done = None, 0
    if trips:
        regs = width // 8
        block = lambda i, u: range(width * i + 8 * u,  # noqa: E731
                                   width * i + 8 * u + 8)
        if unrolled:
            order = lambda u: (range(trips) if u == 0 or trips == 1  # noqa: E731
                               else (1, 0, *range(2, trips)))
            lanes = tuple(zip(*(block(i, u) for u in range(regs)
                                for i in order(u))))
            acc = _chains(jt_rows, b, lanes, _lane_init(8, None, jt_rows))
        else:
            lanes = tuple(tuple(range(8 * u + l, width * trips, width))
                          for u in range(regs) for l in range(8))
            parts = _chains(jt_rows, b, lanes,
                            _lane_init(width, None, jt_rows))
            acc = _fold([parts[..., 8 * u:8 * u + 8, :, :]
                         for u in range(regs)])
        s = _lane_tree(acc)[..., 0]
        done = width * trips
    if etrips:
        lanes = tuple(tuple(range(done + l, done + epilogue * etrips,
                                  epilogue)) for l in range(epilogue))
        acc = _chains(jt_rows, b, lanes, _lane_init(epilogue, s, jt_rows))
        s = _lane_tree(acc)[..., 0]
        done += epilogue * etrips
    tail = _chains(jt_rows, b, (tuple(range(done, m)),),
                   None if s is None else s[..., None, :, None])
    return tail[..., 0, :, 0]


def gemv_plain(jt_rows: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``sum_k j[k, r] v[k]`` ([..., M, 7], [..., M] -> [..., 7]) as
    XLA:CPU computes ``j.T @ v`` in the reference's update (float32):
    from ``GEMV_TILED_FROM`` rows its tiled row-major matrix-vector loop,
    below it the loop fusion that LLVM vectorizes (``_gemv_fused``)."""
    m = jt_rows.shape[-2]
    if m < GEMV_TILED_FROM:
        return _gemv_fused(jt_rows, v)
    k8 = (m // 8) * 8
    lanes = tuple(tuple(range(lane, k8, 8)) for lane in range(8))
    s1 = _lane_tree(_chains(jt_rows, v[..., None], lanes))[..., 0]
    tail = _chains(jt_rows, v[..., None], (tuple(range(k8, m)),))
    return s1 + tail[..., 0, :, 0]


def normal_equations_plain(jv: torch.Tensor, jw: torch.Tensor,
                           j: torch.Tensor, wr: torch.Tensor):
    """(D, A, b) of float32 problems ``jv``, ``jw``, ``j`` [..., M, 7] and
    ``wr`` [..., M] in XLA:CPU's order: D = jv^T j and A = jw^T j summed
    in ``contraction_tree(M)`` (at every M), b = j^T wr in
    ``gemv_plain``'s (its loop depends on M). Leading
    dimensions are a batch; every lane is summed in the lone problem's
    tree. The plain version of ``csrc/normal_equations.cu``."""
    sharded, blocks = contraction_tree(j.shape[-2])
    chunks = tuple(tuple(range(lo, hi)) for blk in blocks for lo, hi in blk)
    sums = _chains(torch.cat([jv, jw], dim=-1), j, chunks)  # [..., C, 14, 7]
    parts, c = [], 0
    for blk in blocks:
        parts.append(_fold([sums[..., c + i, :, :] for i in range(len(blk))]))
        c += len(blk)
    da = _add_blocks(parts) if sharded else parts[0]
    return da[..., :7, :], da[..., 7:, :], gemv_plain(j, wr)


def normal_equations(jv: torch.Tensor, jw: torch.Tensor, j: torch.Tensor,
                     wr: torch.Tensor):
    """``normal_equations_plain`` on CPU tensors; on CUDA tensors the
    kernel ``csrc/normal_equations.cu`` (``ops/normal_equations_cuda``),
    which computes the same bits in one launch."""
    if j.is_cuda:
        from lidar_feature_extraction_tpu_torch.ops.normal_equations_cuda \
            import normal_equations_cuda
        return normal_equations_cuda(jv, jw, j, wr)
    return normal_equations_plain(jv, jw, j, wr)


def reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``sum`` over the last axis as XLA:CPU reduces a long float32 row:
    its tree-reduction rewrite pads the row with zeros to a multiple of
    32 (half of the padding in front, the larger half behind), sums each
    window of 32 in order, and repeats on the window sums until at most
    32 are left, which it sums in order. Leading dimensions are a batch
    (each lane summed alike). Other dtypes: ``torch.sum``."""
    if x.dtype != torch.float32:
        return torch.sum(x, dim=-1)
    while x.shape[-1] > 32:
        n = x.shape[-1]
        pad = -n % 32
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = xf.sum_in_order(x.unflatten(-1, (-1, 32)), -1)
    return xf.sum_in_order(torch.cat([torch.zeros_like(x[..., :1]), x], -1),
                           -1)


def cholesky_solve(a: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-30) -> torch.Tensor:
    """``smallalg.cholesky_solve`` (a [..., n, n] SPD, b [..., n]) as the
    reference's jitted update computes it in float32: every ``s - l*m``
    fused (``fma(-l, m, s)``) in index order, and the last unknown
    divided once by the rounded square of the last pivot, XLA's
    algebraic simplifier having turned ``(s / l) / l`` into
    ``s / (l * l)``."""
    n = a.shape[-1]
    rows = [a[..., i, :] for i in range(n)]
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = rows[i][..., j]
            for k in range(j):
                s = xf.fma(-l[i][k], l[j][k], s)
            if i == j:
                l[i][i] = xf.sqrt(s)
            else:
                ljj = l[j][j]
                l[i][j] = s / torch.where(torch.abs(ljj) < eps,
                                          torch.full_like(ljj, eps), ljj)
    y, last = [None] * n, None
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = xf.fma(-l[i][k], y[k], s)
        last = s
        y[i] = s / l[i][i]
    x = [None] * n
    x[n - 1] = last / (l[n - 1][n - 1] * l[n - 1][n - 1])
    for i in reversed(range(n - 1)):
        s = y[i]
        for k in range(i + 1, n):
            s = xf.fma(-l[k][i], x[k], s)
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Hamilton product ``a * b`` as the reference's update fuses it
    (the operand order of the optimized IR: in x the product ``ax bw`` is
    the fused one of the first pair)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    f = xf.fma
    return torch.stack([
        f(-az, bz, f(-ay, by, f(aw, bw, -(ax * bx)))),
        f(-az, by, f(ay, bz, f(ax, bw, aw * bx))),
        f(az, bx, f(ay, bw, f(aw, by, -(ax * bz)))),
        f(az, bw, f(-ay, bx, f(aw, bz, ax * by))),
    ], dim=-1)


def pose_update(q: torch.Tensor, dx: torch.Tensor):
    """The Gauss-Newton step's rotation update in float32:
    ``(normalize(q * exp(dx[:3])), exp(dx[:3]))`` with the fused
    ``quat_multiply``."""
    dq = quat.exp_so3(dx[..., :3])
    return quat.quat_normalize(quat_multiply(q, dq)), dq


def gn_update_plain(D: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                    q: torch.Tensor, t: torch.Tensor, tau: float):
    """The float32 Gauss-Newton update after the normal equations D, A
    [..., 7, 7], b [..., 7], as the reference's jitted step computes it:
    at the lift M = ``make_m(q)``, ``H = M^T A M`` and ``g = M^T b`` as
    in-order FMA chains (``_xla_f32.matmul``), ``dx = -H^{-1} g`` by
    ``cholesky_solve``, a zero step where D's smallest eigenvalue is below
    ``tau`` (plain arithmetic, ``smallalg.min_eigval_below``) or the solve
    is not finite, then ``pose_update`` and ``t + dt``. Returns
    ``(q_new [..., 4], t_new [..., 3], H [..., 6, 6], |dq.vec|, |dt|)``,
    the norms as ``xf.sqrt`` of the in-order sums of squares. Leading
    dimensions are a batch. The plain version of ``csrc/gn_update.cu``."""
    # ops/gauss_newton.py imports this module: import its lift lazily.
    from lidar_feature_extraction_tpu_torch.ops.gauss_newton import make_m

    M = make_m(q)
    mt = M.transpose(-1, -2)
    H = xf.matmul(xf.matmul(mt, A), M)
    dx = -cholesky_solve(H, xf.matmul(mt, b[..., None])[..., 0])
    bad = smallalg.min_eigval_below(D, tau) | ~torch.all(torch.isfinite(dx),
                                                         dim=-1)
    dx = torch.where(bad[..., None], torch.zeros_like(dx), dx)
    q_new, dq = pose_update(q, dx)
    dt = dx[..., 3:]
    return q_new, t + dt, H, quat._norm(dq[..., 1:]), quat._norm(dt)


def gn_update(D: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
              q: torch.Tensor, t: torch.Tensor, tau: float):
    """``gn_update_plain`` on CPU tensors; on CUDA tensors the kernel
    ``csrc/gn_update.cu`` (``ops/gn_kernels_cuda``), which computes the same
    bits in one launch for a problem or a batch."""
    if D.is_cuda:
        from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
            gn_update_cuda)
        return gn_update_cuda(D, A, b, q, t, tau)
    return gn_update_plain(D, A, b, q, t, tau)
