"""Seeded cases and bit-for-bit comparisons for the Gauss-Newton step's two
fused kernels, ``gn_update`` (``csrc/gn_update.cu``) and
``robust_weights`` (``csrc/robust_weights.cu``), shared by
``chip_smoke.py``, ``tests/test_torch_cuda.py`` (kernel against plain
version on the card) and ``tests/test_torch_gn_kernels.py`` (plain versions' lanes against lone
calls, and the edge lanes, on the CPU). numpy and torch only.

Every case is made with numpy from a seed, so the CPU and the card see the
same inputs. A batch of B >= 8 lanes starts with the edge cases:

- ``gn_update``: a regular problem, an empty one (D, A, b zero: degenerate),
  a degenerate D (a Jacobian column zero), a solve that is not finite
  (A zero), the small-angle branch (b scaled by 1e-12), a large rotation
  (b scaled up, so that glibc's reduction takes n != 0), an A that is not
  positive definite (a NaN pivot), and a regular one at another pose;
- ``robust_weights``: all valid, no valid correspondence (NaN medians and
  scale), one residual block all invalid, ties (a run of equal errors),
  zeros, errors over twelve orders of magnitude, a single valid one, and
  errors on the first round's 256 thresholds and one ulp either side.

``robust_weights``' kernel spreads a lane over a cluster of CTAs whose
size follows B and the tasks; ``RW_CLUSTER_CASES`` puts one more error in
a lane than each cluster size holds in shared memory. Beside the cases, the
kernels' parts in numpy and torch, for the CPU tests: ``robust_weights``'
bucket search (``bucket_guess_correct``, against the definition
``bucket_first``) and its rsqrt from a table (``rsqrt_from_table``);
``gn_update``'s lift from packed constants (``lift_from_constants``), its
order of H's entries over the lanes (``h_entry``), and its solve and
eigenvalue test in the kernel's order, column by column
(``cholesky_solve_by_columns``, ``min_eigval_below_by_columns``).
"""

from __future__ import annotations

import numpy as np

# The rows of the problems behind gn_update's D, A, b, and the
# correspondences of robust_weights' errors: under 4,096, the faithful
# drive's (10,240) and the production rows (14,336); the batch sizes.
ROWS = (2047, 10240, 14336)
BATCHES = (1, 8, 32)
# robust_weights' edge sizes: one error, one over a window of 32, and a
# lane that a cluster of 4 or 2 CTAs does not hold in shared memory (the
# rest read from memory on each pass).
EDGE_N = (1, 33, 81920)
# robust_weights' sizes one past what a cluster of C CTAs holds in shared
# memory (C x 512 threads x 32 values), at a B whose launch takes that C
# with the block medians (C = 8, 4, 2, 2 at 1, 8, 16, 32 lanes of three
# tasks).
RW_CLUSTER_CASES = ((131073, 1), (65537, 8), (32769, 16), (32769, 32))
TAU = 0.1
HUBER_K = 1.345
GN_EDGE_LANES = 8
RW_EDGE_LANES = 8


def _unit_quaternions(rng, batch: int) -> np.ndarray:
    q = rng.normal(size=(batch, 4))
    q[:, 0] = np.abs(q[:, 0]) + 4.0       # near the identity, as a GN pose
    return np.float32(q / np.linalg.norm(q, axis=1, keepdims=True))


def gn_update_case(m: int, batch: int, seed: int = 0) -> tuple:
    """(D [B, 7, 7], A [B, 7, 7], b [B, 7], q [B, 4], t [B, 3]) float32:
    the normal equations of ``batch`` seeded problems of ``m`` rows (each
    float32 sum rounded once from float64: any float32 values are inputs
    the update must take), the first ``GN_EDGE_LANES`` lanes the edge
    cases of the module's note when ``batch`` has room for them."""
    rng = np.random.default_rng(1000 * m + batch + seed)
    j = np.float32(rng.normal(size=(batch, m, 7)) * 0.3)
    w = np.float32(rng.exponential(size=(batch, m, 1))
                   * (rng.random((batch, m, 1)) < 0.9))
    r = np.float32(rng.normal(size=(batch, m)) * 0.05)
    if batch >= GN_EDGE_LANES:
        j[2, :, 4] = 0.0                      # degenerate D
    j64, w64 = j.astype(np.float64), w.astype(np.float64)
    d = np.float32(np.einsum("bmi,bmj->bij", j64, j64))
    a = np.float32(np.einsum("bmi,bmj->bij", j64 * w64, j64))
    b = np.float32(np.einsum("bmi,bm->bi", j64, w64[..., 0] * r))
    q = _unit_quaternions(rng, batch)
    t = np.float32(rng.normal(size=(batch, 3)))
    if batch >= GN_EDGE_LANES:
        d[1] = a[1] = b[1] = 0.0              # empty
        a[3] = 0.0                            # not finite
        b[4] *= np.float32(1e-12)             # small angle
        b[5] *= np.float32(3e3)               # large rotation
        a[6] = -a[6]                          # not positive definite
    return d, a, b, q, t


def robust_weights_shape(n: int) -> tuple:
    """A Problem's block shape for ``n`` correspondences: edges (three
    rows each) one fifth, as ``kitti_hdl64()``'s 2,048 of 10,240, and
    surfaces; one block under five."""
    n_edge = n // 5
    return ((n_edge, 3), (n - n_edge, 1)) if n_edge else ((n, 1),)


def robust_weights_case(n: int, batch: int, seed: int = 0) -> tuple:
    """(errors [B, N] float32, valid [B, N] bool, shape): squared residual
    norms (exponential, scaled per lane), 90% valid, the first
    ``RW_EDGE_LANES`` lanes the edge cases of the module's note when
    ``batch`` has room for them."""
    rng = np.random.default_rng(7000 * n + batch + seed)
    shape = robust_weights_shape(n)
    errors = np.float32(rng.exponential(size=(batch, n))
                        * 10.0 ** rng.uniform(-4, 0, (batch, 1)))
    valid = rng.random((batch, n)) < 0.9
    if batch >= RW_EDGE_LANES:
        valid[0] = True                                   # all valid
        valid[1] = False                                  # empty
        valid[2, :shape[0][0]] = False                    # a block empty
        errors[3, : (n + 1) // 2] = errors[3, 0]          # ties
        errors[4, ::3] = 0.0                              # zeros
        errors[5] = np.float32(10.0 ** rng.uniform(-8, 4, n))
        valid[6] = False                                  # one valid
        valid[6, n // 2] = True
        errors[7], valid[7] = _on_thresholds(rng, n), True
    return errors, valid, shape


def _on_thresholds(rng, n: int) -> np.ndarray:
    """A lane of ``n`` errors in [0.25, 3.3] that holds both ends, then
    the first round's 256 thresholds fma(w, k + 1, lo) and their float32
    neighbours (within the ends), as many as fit, in a shuffled order."""
    lo, hi = np.float32(0.25), np.float32(3.3)
    t = _fma32(np.float32((hi - lo) / np.float32(256)),
               np.arange(1, 257, dtype=np.float32), lo)
    on = np.clip(np.concatenate([t, np.nextafter(t, np.float32(-np.inf)),
                                 np.nextafter(t, np.float32(np.inf))]),
                 lo, hi)
    lane = np.float32(rng.uniform(lo, hi, n))
    m = max(0, min(n - 2, on.size))
    lane[2:2 + m] = on[:m]
    lane[: min(n, 2)] = (lo, hi)[: min(n, 2)]
    return lane[rng.permutation(n)]


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (``_xla_f32``'s plain fma), on
    numpy values broadcast together."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf

    a, b, c = np.broadcast_arrays(*(np.asarray(x, np.float32)
                                    for x in (a, b, c)))
    return xf._fma_plain(torch.as_tensor(a.copy()), torch.as_tensor(b.copy()),
                         torch.as_tensor(c.copy())).numpy()


def bucket_first(v, lo, hi) -> np.ndarray:
    """The definition of a value's bucket in a round of the wide median
    over [lo, hi] (float32): the first k in [0, 256) with v <= t_k =
    fma(w, k + 1, lo), w = (hi - lo) / 256, or 256."""
    v = np.asarray(v, np.float32)
    lo, hi = np.float32(lo), np.float32(hi)
    with np.errstate(all="ignore"):
        w = np.float32((hi - lo) / np.float32(256))
    t = _fma32(w, np.arange(1, 257, dtype=np.float32), lo)
    below = v[:, None] <= t[None, :]
    return np.where(below.any(axis=1), below.argmax(axis=1), 256)


def bucket_guess_correct(v, lo, hi) -> np.ndarray:
    """``csrc/robust_weights.cu``'s ``bucket`` of each float32 value:
    0 where v <= t_0; 256 where not v <= t_255 (a NaN value, NaN
    thresholds, or above them all); else the guess g = ceil((v - lo) *
    (1 / w)) - 1 (divided by w where w is subnormal; clamped to [1, 255],
    a NaN guess to 1), walked down while v <= t_{g-1} and up while not
    v <= t_g."""
    v = np.asarray(v, np.float32)
    lo, hi = np.float32(lo), np.float32(hi)
    one = np.float32(1)
    with np.errstate(all="ignore"):
        w = np.float32((hi - lo) / np.float32(256))

        def t(g):
            return _fma32(w, np.asarray(g, np.float32) + one, lo)

        out = np.full(v.shape, -1)
        out[v <= t(0)] = 0
        out[(out < 0) & ~(v <= t(255))] = 256
        rest = np.flatnonzero(out < 0)
        x = np.float32(v[rest] - lo)
        q = np.ceil(x / w if w < np.finfo(np.float32).tiny
                    else x * np.float32(one / w)) - one
        g = np.where(q >= 255, 255, np.where(q >= 1, q, 1)).astype(np.int64)
        x = v[rest]
        while True:
            down = (g > 1) & (x <= t(g - 1))
            if not down.any():
                break
            g[down] -= 1
        while True:
            up = (g < 255) & ~(x <= t(g))
            if not up.any():
                break
            g[up] += 1
        out[rest] = g
    return out


def rsqrt_from_table(v, table: np.ndarray):
    """float32 ``1 / sqrt(v)`` as ``csrc/robust_weights.cu`` computes it:
    the estimate's 12-bit mantissa from ``table`` (``gn_kernels_cuda.
    rsqrt_table``) at (exponent parity << 10 | top ten mantissa bits), its
    exponent 126 - (e - 127 or 128) / 2, then two fused Newton steps; a
    torch tensor in and out."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf

    bits = v.view(torch.int32)
    exponent = (bits >> 23) & 0xFF
    odd = exponent & 1
    m12 = torch.as_tensor(table.astype(np.int32))[
        (odd << 10) | ((bits >> 13) & 0x3FF)]
    scale = 126 - (exponent - torch.where(odd == 1, 127, 128)) // 2
    y = ((scale << 23) | (m12 << 11)).to(torch.int32).view(torch.float32)
    for _ in range(2):
        y = xf.fma(y * -0.5, xf.fma(v * y, y, torch.full_like(y, -1.0)), y)
    return y


def differing(got, want) -> int:
    """Elements of two float32 or int32 tensors whose bits differ, a NaN
    against a NaN counting as equal (NaN payloads differ between
    devices)."""
    import torch

    got, want = got.contiguous(), want.contiguous()
    if got.dtype == torch.float32:
        same = (got.view(torch.int32) == want.view(torch.int32)) \
            | (torch.isnan(got) & torch.isnan(want))
    else:
        same = got == want
    return int((~same).sum())


def compare(got: tuple, want: tuple, names: tuple) -> dict:
    """``{name: elements that differ}`` over the outputs (None matches
    None)."""
    out = {}
    for name, g, w in zip(names, got, want):
        if g is None or w is None:
            out[name] = int((g is None) != (w is None))
        else:
            out[name] = differing(g.cpu(), w.cpu())
    return out


# gn_update's lift (csrc/gn_update.cu::lift): in row k < 4 of make_m's
# top-left 4 x 3, column i is 0.5 q[nibble i of LIFT_INDEX[k]], negated
# where bit i of LIFT_NEGATE[k] is set.
LIFT_INDEX = (0x321, 0x230, 0x103, 0x012)
LIFT_NEGATE = (7, 2, 4, 1)


def lift_from_constants(q):
    """``make_m(q)`` [..., 7, 6] as ``gn_update`` reads it from q and the
    packed constants (a torch tensor in and out)."""
    import torch

    m = torch.zeros(q.shape[:-1] + (7, 6), dtype=q.dtype)
    for k in range(4):
        for i in range(3):
            v = q[..., (LIFT_INDEX[k] >> (4 * i)) & 0xF]
            m[..., k, i] = 0.5 * (-v if (LIFT_NEGATE[k] >> i) & 1 else v)
    for k in range(4, 7):
        m[..., k, k - 1] = 1.0
    return m


def h_entry(e: int) -> tuple[int, int]:
    """The (row, column) of H that ``gn_update``'s lane or thread ``e``
    (0-35) computes: the lower triangle in row order first (lanes 0-20,
    which the factor reads), then the upper one: (c, r) for the
    (e - 21)-th entry (r, c) of the strict lower triangle."""
    if e < 21:
        r = sum(e >= x for x in (1, 3, 6, 10, 15))
        return r, e - r * (r + 1) // 2
    u = e - 21
    r = 1 + sum(u >= x for x in (1, 3, 6, 10))
    return u - r * (r - 1) // 2, r


def cholesky_solve_by_columns(h, g, eps: float = 1e-30):
    """``_xla_dot.cholesky_solve(h, g)`` (float32 torch, [..., 6, 6] and
    [..., 6]) in ``gn_update``'s order: the fused factor column by column
    (each column's root, its divisions by the guarded pivot beside the
    forward substitution's y[k] = s[k] / l[k][k], then every later diagonal
    chain, row entry and s[i] updated by it; the unused y[5] not divided),
    the last unknown divided by l*l, the back substitution. Every entry
    still runs its terms in ascending index order."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf

    n = h.shape[-1]
    diag = [h[..., j, j] for j in range(n)]
    row = {(i, j): h[..., i, j] for i in range(n) for j in range(i)}
    s = [g[..., i] for i in range(n)]
    L, y = {}, [None] * (n - 1)
    for k in range(n - 1):
        L[k, k] = xf.sqrt(diag[k])
        pivot = torch.where(L[k, k].abs() < eps,
                            torch.full_like(L[k, k], eps), L[k, k])
        y[k] = s[k] / L[k, k]
        for i in range(k + 1, n):
            L[i, k] = row[i, k] / pivot
        for j in range(k + 1, n):
            diag[j] = xf.fma(-L[j, k], L[j, k], diag[j])
            for i in range(j + 1, n):
                row[i, j] = xf.fma(-L[i, k], L[j, k], row[i, j])
            s[j] = xf.fma(-L[j, k], y[k], s[j])
    L[n - 1, n - 1] = xf.sqrt(diag[n - 1])
    x = [None] * n
    x[n - 1] = s[n - 1] / (L[n - 1, n - 1] * L[n - 1, n - 1])
    for i in reversed(range(n - 1)):
        v = y[i]
        for k in range(i + 1, n):
            v = xf.fma(-L[k, i], x[k], v)
        x[i] = v / L[i, i]
    return torch.stack(x, dim=-1)


def min_eigval_below_by_columns(d, tau: float):
    """``smallalg.min_eigval_below(d, tau)`` (float32 torch [..., n, n]) in
    ``gn_update``'s order: plain arithmetic, column by column as
    ``cholesky_solve_by_columns`` factors (the last root not taken)."""
    import torch

    n = d.shape[-1]
    diag = [d[..., j, j] - tau for j in range(n)]
    row = {(i, j): d[..., i, j] - 0.0 for i in range(n) for j in range(i)}
    ok = torch.ones(d.shape[:-2], dtype=torch.bool)
    for k in range(n):
        ok = ok & (diag[k] > 0)
        if k == n - 1:
            break
        lkk = torch.sqrt(torch.clamp_min(diag[k], 1e-30))
        col = {i: row[i, k] / lkk for i in range(k + 1, n)}
        for j in range(k + 1, n):
            diag[j] = diag[j] - col[j] * col[j]
            for i in range(j + 1, n):
                row[i, j] = row[i, j] - col[i] * col[j]
    return ~ok


GN_OUTPUTS = ("q", "t", "H", "dq_norm", "dt_norm")
RW_OUTPUTS = ("n_valid", "error", "scale", "weights", "block_meds")
