"""The plain versions of the Gauss-Newton step's two fused kernels on the
CPU, bit for bit (a NaN against a NaN: an empty lane's medians).

``core/_xla_dot.py::gn_update_plain`` (``csrc/gn_update.cu``'s plain
version) and ``core/stats.py::robust_weights_plain``
(``csrc/robust_weights.cu``'s): on ``gn_kernels_check.py``'s seeded cases
at B = 1, 8 and 32 (the edge cases in the first eight lanes of a batch)
every lane of a batch equals its lone call, and the edge lanes do what
the module's note says. A float32 iteration calls each once. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``); here their
wrappers must refuse CPU tensors rather than compute anything, and two of
``robust_weights``' parts are held in their numpy and torch mirrors: its
exact guess-and-correct bucket search against the definition (the first
threshold at or above a value), and its rsqrt from a host-built table
against ``xf.rsqrt``; and ``gn_update``'s: its lift from packed
constants, its order of H's entries, and its factor, substitutions and
eigenvalue test column by column against the serial order.
The float32 step's parity with the JAX package is held by the existing
tests (``test_torch_localization.py``, ``test_torch_drive.py``,
``test_torch_host_localizer.py``, ``test_torch_xla_dot.py``).
"""

import numpy as np
import pytest
import torch

import gn_kernels_check as gk
from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf
from lidar_feature_extraction_tpu_torch.core import stats
from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
from lidar_feature_extraction_tpu_torch.ops import smallalg


def _gn_args(m, batch):
    return tuple(torch.as_tensor(a) for a in gk.gn_update_case(m, batch))


def _rw_args(n, batch):
    errors, valid, shape = gk.robust_weights_case(n, batch)
    return torch.as_tensor(errors), torch.as_tensor(valid), shape


def _assert_equal(got, want, names):
    assert gk.compare(got, want, names) == dict.fromkeys(names, 0)


@pytest.mark.parametrize("m,batch", [(2047, 1), (10240, 8), (14336, 32)])
def test_gn_update_plain_lanes_are_lone_calls(m, batch):
    args = _gn_args(m, batch)
    got = xd.gn_update_plain(*args, gk.TAU)
    for lane in range(batch):
        lone = xd.gn_update_plain(*(a[lane] for a in args), gk.TAU)
        _assert_equal([g[lane] for g in got], lone, gk.GN_OUTPUTS)


def test_gn_update_edge_lanes():
    """The edge lanes do what the module's note says: the empty,
    degenerate, non-finite and non-positive-definite lanes keep their
    pose (a zero step, the quaternion renormalized), the small-angle lane
    takes exp_so3's branch, the large rotation turns by more than 1 rad."""
    D, A, b, q, t = _gn_args(10240, gk.GN_EDGE_LANES)
    q_new, t_new, H, dq_norm, dt_norm = xd.gn_update_plain(D, A, b, q, t,
                                                           gk.TAU)
    for lane in (1, 2, 3, 6):
        assert torch.equal(t_new[lane], t[lane]), lane
        assert dq_norm[lane] == 0 and dt_norm[lane] == 0, lane
    assert bool(smallalg.min_eigval_below(D[2], gk.TAU))
    dx = -xd.cholesky_solve(H[3], torch.zeros(6))
    assert not bool(torch.isfinite(dx).all())
    assert 0 < float(dq_norm[4]) < 1e-8 / 2
    assert float(dq_norm[5]) > np.sin(0.5)
    for lane in (0, 7):
        assert 0 < float(dq_norm[lane]) < 0.5 and float(dt_norm[lane]) > 0


def test_gn_update_lift_constants_build_make_m():
    """csrc/gn_update.cu reads the lift's entries from q through packed
    constants: they give make_m(q) bit for bit."""
    q = torch.as_tensor(gk._unit_quaternions(np.random.default_rng(3), 64))
    assert torch.equal(gk.lift_from_constants(q).view(torch.int32),
                       gn.make_m(q).view(torch.int32))


def test_gn_update_h_entries_cover_h_once():
    """The kernel's 36 H entries: each entry of H once, the factor's lower
    triangle on the first 21 lanes."""
    entries = [gk.h_entry(e) for e in range(36)]
    assert sorted(entries) == [(i, j) for i in range(6) for j in range(6)]
    assert all(i >= j for i, j in entries[:21])


@pytest.mark.parametrize("m", gk.ROWS)
def test_gn_update_column_order_equals_the_serial_order(m):
    """The kernel's factor, substitutions and eigenvalue test, column by
    column across lanes, give the serial order's bits (a NaN against a
    NaN) on the seeded lanes, the edge lanes among them: each entry still
    runs its terms in ascending index order."""
    D, A, b, q, _ = _gn_args(m, 32)
    M = gn.make_m(q)
    mt = M.transpose(-1, -2)
    H = xf.matmul(xf.matmul(mt, A), M)
    g = xf.matmul(mt, b[..., None])[..., 0]
    _assert_equal([gk.cholesky_solve_by_columns(H, g)],
                  [xd.cholesky_solve(H, g)], ("x",))
    for S in (D, A, -D):
        assert torch.equal(gk.min_eigval_below_by_columns(S, gk.TAU),
                           smallalg.min_eigval_below(S, gk.TAU))


@pytest.mark.parametrize("n,batch", [(1, 1), (33, 8), (2047, 32),
                                     (10240, 8)])
@pytest.mark.parametrize("medians", [False, True], ids=["step", "loop"])
def test_robust_weights_plain_lanes_are_lone_calls(n, batch, medians):
    errors, valid, shape = _rw_args(n, batch)
    got = stats.robust_weights_plain(errors, valid, shape, gk.HUBER_K,
                                     medians)
    for lane in range(batch):
        lone = stats.robust_weights_plain(errors[lane], valid[lane], shape,
                                          gk.HUBER_K, medians)
        _assert_equal([None if g is None else g[lane] for g in got], lone,
                      gk.RW_OUTPUTS)


def test_robust_weights_edge_lanes():
    """An empty lane gives n_valid 0 and NaN medians and scale (so the
    loop sets EMPTY_INPUT); a lane with one empty block a NaN median for
    it alone; one valid error is its own median and has a zero MAD."""
    errors, valid, shape = _rw_args(10240, gk.RW_EDGE_LANES)
    n_valid, error, scale, weights, meds = stats.robust_weights_plain(
        errors, valid, shape, gk.HUBER_K, True)
    assert int(n_valid[1]) == 0 and float(error[1]) == 0
    assert bool(torch.isnan(scale[1])) and bool(torch.isnan(meds[1]).all())
    assert bool(torch.isnan(meds[2, 0])) and not bool(torch.isnan(meds[2, 1]))
    assert int(n_valid[6]) == 1 and float(scale[6]) == 0
    assert torch.isfinite(scale[[0, 2, 3, 4, 5, 7]]).all()
    assert n_valid[0] == errors.shape[1]


def test_robust_weights_threshold_lane():
    """Lane 7 holds its ends and the first round's 256 thresholds and
    their neighbours, all valid, so the median's first round sees values
    on every threshold."""
    errors, valid, shape = _rw_args(10240, gk.RW_EDGE_LANES)
    lane = errors[7].numpy()
    lo, hi = np.float32(lane.min()), np.float32(lane.max())
    t = gk._fma32(np.float32((hi - lo) / np.float32(256)),
                  np.arange(1, 257, dtype=np.float32), lo)
    assert bool(valid[7].all()) and (lo, hi) == (np.float32(0.25),
                                                np.float32(3.3))
    assert np.isin(t[t <= hi], lane).all()
    assert np.isin(np.nextafter(t[:-1], np.float32(0)), lane).all()


_F32 = np.float32
# (lo, hi) of a median's round: w = 0, subnormal w (from 0 and across 0),
# a span of 1e-8..1e4, w below an ulp of lo, and NaN thresholds (lo -inf
# or NaN) or infinite ones (hi +inf).
_BUCKET_RANGES = {
    "w0": (1.5, 1.5), "subnormal": (0.0, _F32(3 * 2.0 ** -149 * 256)),
    "subnormal_across_0": (_F32(-1e-40), _F32(1e-40)),
    "span_1e-8_1e4": (1e-8, 1e4), "below_ulp": (1e4, _F32(1e4) + _F32(1e-3)),
    "negative": (-7.5, -0.125), "nan_from_-inf": (-np.inf, 1.0),
    "nan_lo": (np.nan, 1.0), "inf_hi": (0.0, np.inf)}


@pytest.mark.parametrize("lo,hi", list(_BUCKET_RANGES.values()),
                         ids=list(_BUCKET_RANGES))
def test_bucket_guess_correct_is_the_first_threshold_at_or_above(lo, hi):
    """csrc/robust_weights.cu's bucket search (its numpy mirror) gives
    every value the bucket of the definition, the first k with v <= t_k
    (else 256): values on each of the 256 fma-computed thresholds, one ulp
    below and above, the ends, NaN, +-inf, +-0 and seeded values around
    the range."""
    lo, hi = _F32(lo), _F32(hi)
    with np.errstate(all="ignore"):
        w = _F32((hi - lo) / _F32(256))
        t = gk._fma32(w, np.arange(1, 257, dtype=_F32), lo)
        rng = np.random.default_rng(11)
        span = hi - lo if np.isfinite(hi - lo) else _F32(1)
        base = lo if np.isfinite(lo) else _F32(0)
        seeded = _F32(base + span * rng.uniform(-0.5, 1.5, 2000))
    values = np.concatenate([
        t, np.nextafter(t, _F32(-np.inf)), np.nextafter(t, _F32(np.inf)),
        _F32([lo, hi, np.nan, np.inf, -np.inf, 0.0, -0.0]), seeded]
    ).astype(_F32)
    want = gk.bucket_first(values, lo, hi)
    assert np.array_equal(gk.bucket_guess_correct(values, lo, hi), want)
    if np.isnan(t).any():
        assert (want == 256).all()


def test_rsqrt_table_is_xf_rsqrt_estimate():
    """The host-built table holds ``xf.rsqrt``'s 12-bit estimate for each
    of the 2,048 classes (the exponent's parity, the top ten mantissa
    bits), at two exponents each."""
    from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
        rsqrt_table)

    table = rsqrt_table()
    assert table.shape == (2048,) and table.dtype == np.uint16
    index = np.arange(2048)
    for exponent in (127, 201):   # odd, then even
        parity = np.where(index >> 10 == 1, exponent, exponent + 1)
        bits = (parity << 23) | ((index & 0x3FF) << 13) | 0x1357
        v = torch.as_tensor(bits.astype(np.int32)).view(torch.float32)
        assert np.array_equal(xf._rsqrt_m12(v).numpy(),
                              table.astype(np.int32))


def test_rsqrt_from_table_matches_xf_rsqrt():
    """The kernel's rsqrt (its torch mirror: the table's estimate and two
    fused Newton steps) equals ``xf.rsqrt`` bit for bit on seeded normals
    over the whole exponent range, the smallest and largest normals and
    every power of two."""
    from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
        rsqrt_table)

    rng = np.random.default_rng(17)
    finfo = np.finfo(np.float32)
    v = np.concatenate([
        _F32(np.exp2(rng.uniform(-126, 128, 200_000))),
        [finfo.tiny, finfo.max, np.nextafter(finfo.tiny, _F32(1))],
        _F32(2.0) ** np.arange(-126, 128)]).astype(_F32)
    v = torch.as_tensor(v[np.isfinite(v)])
    got = gk.rsqrt_from_table(v, rsqrt_table())
    assert torch.equal(got.view(torch.int32), xf.rsqrt(v).view(torch.int32))


def test_gn_iteration_calls_each_fused_step_once(monkeypatch):
    """A float32 iteration makes one call of each (one launch each on the
    card), and the fused loop asks robust_weights for the block medians;
    float64 calls neither."""
    calls = {"robust_weights": [], "gn_update": 0}
    rw, gu = stats.robust_weights, xd.gn_update

    def counting_rw(*args):
        calls["robust_weights"].append(args[-1])
        return rw(*args)

    def counting_gu(*args):
        calls["gn_update"] += 1
        return gu(*args)

    monkeypatch.setattr(stats, "robust_weights", counting_rw)
    monkeypatch.setattr(xd, "gn_update", counting_gu)
    rng = np.random.default_rng(5)
    n = 40
    problem = gn.Problem(
        jac_rows=torch.as_tensor(np.float32(rng.normal(size=(n, 7)))),
        res_rows=torch.as_tensor(np.float32(rng.normal(size=n) * 0.1)),
        errors=torch.as_tensor(np.float32(rng.exponential(size=n))),
        valid=torch.ones(n, dtype=torch.bool), shape=((10, 1), (30, 1)))
    pose = gn.Pose(torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(3))
    gn.gn_iteration(problem, pose)
    gn.run_gauss_newton(lambda p: problem, pose, max_iterations=1)
    assert calls == {"robust_weights": [False, True], "gn_update": 2}
    as64 = problem._replace(jac_rows=problem.jac_rows.double(),
                            res_rows=problem.res_rows.double(),
                            errors=problem.errors.double())
    gn.gn_iteration(as64, gn.Pose(pose.q.double(), pose.t.double()))
    assert calls["gn_update"] == 2 and len(calls["robust_weights"]) == 2


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch or raise: on CPU tensors they raise before
    building anything (the dispatchers send those to the plain
    versions)."""
    from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
        gn_update_cuda, robust_weights_cuda)

    errors, valid, shape = _rw_args(33, 1)
    with pytest.raises(ValueError, match="CUDA"):
        robust_weights_cuda(errors, valid, shape)
    with pytest.raises(ValueError, match="CUDA"):
        gn_update_cuda(*_gn_args(2047, 1), gk.TAU)
    assert robust_weights_cuda.launches == 0 and gn_update_cuda.launches == 0
