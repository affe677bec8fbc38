"""Port parity: small algebra (eigh3x3, smallalg) and the geometry map
build against the JAX reference.

Tolerances: eigenvalues, the Cholesky solve and the Jacobi spectrum
rtol 1e-5 (float32 closed forms, rounded in another order); eigenvectors
of well-separated eigenvalues (gap above 1% of the largest) within 1e-4,
up to sign; degeneracy decisions are equal. Geometry records: unit
directions and normals within 1e-4 (up to sign), line points and plane
offsets within 1e-4 per metre of map extent (an offset is a dot product
with a point that far away); voxel counts exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import np32, t32, to_np  # noqa: E402
from lidar_feature_extraction_tpu.config import (  # noqa: E402
    PipelineConfig as JPipe)
from lidar_feature_extraction_tpu.ops import (  # noqa: E402
    eig3 as jeig, smallalg as jsa)
from lidar_feature_extraction_tpu.pipeline.localization import (  # noqa: E402
    build_geometry_maps as j_build)
from lidar_feature_extraction_tpu_torch.config import (  # noqa: E402
    PipelineConfig as TPipe)
from lidar_feature_extraction_tpu_torch.ops import (  # noqa: E402
    eig3 as teig, smallalg as tsa)
from lidar_feature_extraction_tpu_torch.pipeline.localization import (  # noqa: E402
    build_geometry_maps as t_build)

RTOL = 1e-5
REC_ATOL = 1e-4


def _spd(rng, n, dim, cond=1e3):
    a = rng.normal(size=(n, dim, dim))
    w = np.exp(rng.uniform(0, np.log(cond), size=(n, dim)))
    q, _ = np.linalg.qr(a)
    return np32(q @ (w[..., None] * np.swapaxes(q, -1, -2)))


def _sign_align(got, want, axis=-2):
    """Flip each vector of ``got`` (vectors along ``axis``) to agree in
    sign with ``want``."""
    s = np.sign(np.sum(got * want, axis=axis, keepdims=True))
    return got * np.where(s == 0, 1.0, s)


def test_eigh3x3_matches_reference():
    """Against the jitted reference, whose float32 forms the port computes
    (ROADMAP §C20): on the rank-one matrices its zero eigenvalues are
    -9e-4, not the eager function's -2.4e-7."""
    rng = np.random.default_rng(0)
    a = _spd(rng, 256, 3)
    a[:8] = np32(np.eye(3) * 2.0)           # isotropic branch
    line = rng.normal(size=(8, 3))
    a[8:16] = np32(line[:, :, None] * line[:, None, :])   # rank one
    jw, jv = jax.jit(jeig.eigh3x3)(jnp.asarray(a))
    tw, tv = teig.eigh3x3(t32(a))
    np.testing.assert_allclose(to_np(tw), np32(jw), rtol=RTOL, atol=1e-5)
    # Eigenvectors of well-separated eigenvalues, compared up to sign.
    w = np.asarray(jw, np.float64)
    for k in (0, 2):
        others = np.delete(w, k, axis=-1)
        gap = np.min(np.abs(others - w[:, k:k + 1]), axis=-1)
        sep = gap > 1e-2 * np.max(np.abs(w), axis=-1)
        assert sep.sum() > 200
        got = to_np(tv)[sep, :, k]
        want = np32(jv)[sep, :, k]
        np.testing.assert_allclose(_sign_align(got, want, -1), want,
                                   atol=1e-4)


def test_cholesky_solve_matches_reference():
    rng = np.random.default_rng(1)
    for a in _spd(rng, 8, 6):
        b = np32(rng.normal(size=6))
        want = np32(jsa.cholesky_solve(jnp.asarray(a), jnp.asarray(b)))
        got = to_np(tsa.cholesky_solve(t32(a), t32(b)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("tau", [1e-3, 0.1, 10.0])
def test_min_eigval_below_matches_reference(tau):
    rng = np.random.default_rng(2)
    for a in _spd(rng, 16, 7, cond=1e4):
        want = bool(jsa.min_eigval_below(jnp.asarray(a), tau))
        assert bool(tsa.min_eigval_below(t32(a), tau)) == want


def test_jacobi_eigvalsh_matches_reference():
    rng = np.random.default_rng(3)
    a = _spd(rng, 1, 7)[0]
    want = np.sort(np32(jsa.jacobi_eigvalsh(jnp.asarray(a))))
    got = np.sort(to_np(tsa.jacobi_eigvalsh(t32(a))))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


def _world(rng):
    """Edge poles and a ground + wall surface map, float32."""
    poles = []
    for px, py in rng.uniform(-12, 12, size=(10, 2)):
        z = rng.uniform(0, 4, size=40)
        poles.append(np.stack([np.full(40, px), np.full(40, py), z], -1))
    edge = np.concatenate(poles) + rng.normal(scale=0.02, size=(400, 3))
    g = rng.uniform(-14, 14, size=(3000, 2))
    ground = np.concatenate([g, rng.normal(scale=0.02, size=(3000, 1))], -1)
    wy, wz = rng.uniform(-14, 14, size=800), rng.uniform(0, 5, size=800)
    wall = np.stack([np.full(800, 9.0), wy, wz], -1)
    return np32(edge), np32(np.concatenate([ground, wall]))


@pytest.mark.parametrize("kind", ["edge", "surface"])
def test_geometry_map_records_match_reference(kind):
    rng = np.random.default_rng(4)
    edge, surf = _world(rng)
    em = rng.random(len(edge)) < 0.95
    sm = rng.random(len(surf)) < 0.95
    want = getattr(j_build(jnp.asarray(edge), jnp.asarray(em),
                           jnp.asarray(surf), jnp.asarray(sm), JPipe()),
                   kind)
    got = getattr(t_build(t32(edge), torch.as_tensor(em), t32(surf),
                          torch.as_tensor(sm), TPipe()), kind)
    assert got.dims == tuple(want.dims)
    np.testing.assert_array_equal(to_np(got.origin), np32(want.origin))
    rec_t, rec_j = to_np(got.rec), np32(want.rec)
    cnt_col = 6 if kind == "edge" else 4
    np.testing.assert_array_equal(rec_t[:, cnt_col], rec_j[:, cnt_col])
    occupied = rec_j[:, cnt_col] >= 3
    assert occupied.sum() > 50
    pos_atol = REC_ATOL * float(np.abs(np.concatenate([edge, surf])).max())
    if kind == "edge":
        # (mean, direction): the direction up to sign.
        np.testing.assert_allclose(rec_t[occupied, 0:3],
                                   rec_j[occupied, 0:3], atol=pos_atol)
        v = _sign_align(rec_t[occupied, 3:6], rec_j[occupied, 3:6], -1)
        np.testing.assert_allclose(v, rec_j[occupied, 3:6], atol=REC_ATOL)
    else:
        # (normal, offset): flip both with the normal's sign.
        s = np.sign(np.sum(rec_t[occupied, 0:3] * rec_j[occupied, 0:3],
                           axis=-1, keepdims=True))
        np.testing.assert_allclose(s * rec_t[occupied, 0:3],
                                   rec_j[occupied, 0:3], atol=REC_ATOL)
        np.testing.assert_allclose(s[:, 0] * rec_t[occupied, 3],
                                   rec_j[occupied, 3], atol=pos_atol)
