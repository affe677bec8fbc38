"""Port parity: feature extraction (the plain version of kernel K1 and
the compact extraction around it) against the JAX reference, its Pallas
kernel in interpret mode, and the sequential numpy oracle.

Tolerances: labels, compaction columns, validity masks and compacted
points are bit-equal (integer results; points are moved, not computed),
and so is the float32 curvature against the reference's jitted
labelling: XLA:CPU contracts its ``x*x + y*y`` and ``-2p*r + r[i-1]``
into FMAs, and the port computes the same fused operations
(tests/test_torch_fma.py; ROADMAP §C18).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import np_ref  # noqa: E402
from torch_parity import np32, t32, to_np  # noqa: E402
from test_extraction import (  # noqa: E402
    _multi_ring_image, _nms_device, _nms_oracle)
from lidar_feature_extraction_tpu.config import (  # noqa: E402
    ExtractionConfig as JCfg, kitti_hdl64 as j_kitti)
from lidar_feature_extraction_tpu.core.scan import (  # noqa: E402
    RangeImage as JImage)
from lidar_feature_extraction_tpu.ops import extraction as jex  # noqa: E402
from lidar_feature_extraction_tpu.ops.extraction_pallas import (  # noqa: E402
    label_and_columns_pallas)
from lidar_feature_extraction_tpu_torch.config import (  # noqa: E402
    ExtractionConfig as TCfg, kitti_hdl64 as t_kitti)
from lidar_feature_extraction_tpu_torch.interop import (  # noqa: E402
    range_image_from_numpy)
from lidar_feature_extraction_tpu_torch.ops import (  # noqa: E402
    extraction as tex)
from lidar_feature_extraction_tpu_torch.ops.extraction_cuda import (  # noqa: E402
    label_and_columns)


def assert_curvature_equal(got, want):
    got, want = to_np(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


CFG_KW = dict(n_rings=4, max_points_per_ring=512, nms_rounds=96,
              surface_threshold=0.3)
LEAF, CE, CS = 1.0, 16, 24


def _image(seed):
    """float32 4x512 multi-ring image as numpy (xyz, mask, count)."""
    img = _multi_ring_image(np.random.default_rng(seed), 4, 512)
    return (np32(img.xyz), np.array(img.mask),
            np.array(img.count, dtype=np.int32))


def _jimage(xyz, mask, count):
    return JImage(jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(count))


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_plain_k1_matches_reference_and_pallas_interpret(seed):
    xyz, mask, count = _image(seed)
    jcfg, tcfg = JCfg(**CFG_KW), TCfg(**CFG_KW)

    labels, curv = jax.jit(jex.label_range_image, static_argnums=1)(
        _jimage(xyz, mask, count), jcfg)
    key = jex._voxel_run_key(jnp.asarray(xyz), LEAF)
    col, _, _, _ = jex.compact_columns(labels, jnp.asarray(mask), key, CE, CS)
    pl_labels, _, pl_col = label_and_columns_pallas(
        *[jnp.asarray(xyz[..., i]) for i in range(3)], jnp.asarray(count),
        jcfg, LEAF, CE, CS, ring_group=2, interpret=True)

    got = tex.label_and_columns_plain(
        *[t32(xyz[..., i]) for i in range(3)], torch.as_tensor(count),
        tcfg, LEAF, CE, CS)
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(labels))
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(col))
    np.testing.assert_array_equal(to_np(got[0]), np.asarray(pl_labels))
    np.testing.assert_array_equal(to_np(got[2]), np.asarray(pl_col))
    assert_curvature_equal(got[1], curv)


def test_cpu_dispatch_takes_the_plain_version():
    xyz, _, count = _image(10)
    cfg = TCfg(**CFG_KW)
    planes = [t32(xyz[..., i]) for i in range(3)]
    a = label_and_columns(*planes, torch.as_tensor(count), cfg, LEAF, CE, CS)
    b = tex.label_and_columns_plain(*planes, torch.as_tensor(count), cfg,
                                    LEAF, CE, CS)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _nms_torch(curvature, nb, n, cfg, max_pts=128):
    curv = torch.zeros((1, max_pts), dtype=torch.float64)
    curv[0, :n] = torch.as_tensor(curvature)
    nbt = torch.zeros((1, max_pts), dtype=torch.bool)
    nbt[0, :n - 1] = torch.as_tensor(nb)
    g = tex.gap_prefix(nbt)
    count = torch.tensor([n], dtype=torch.int32)
    blk = tex.block_ids(count, max_pts, cfg.padding, cfg.n_blocks)
    labels = torch.full((1, max_pts), tex.DEFAULT, dtype=torch.int32)
    for pick_max in (True, False):
        labels = tex._nms_pass(
            labels, curv, blk, g, count, padding=cfg.padding,
            n_blocks=cfg.n_blocks,
            threshold=cfg.edge_threshold if pick_max
            else cfg.surface_threshold,
            pick_max=pick_max,
            point_code=tex.EDGE if pick_max else tex.SURFACE,
            neighbor_code=tex.EDGE_NEIGHBOR if pick_max
            else tex.SURFACE_NEIGHBOR,
            n_iter=cfg.nms_rounds)
    return to_np(labels)[0, :n]


def _nms_case(name, seed=0):
    n = 100
    if name == "ties_surface":
        kw = dict(nms_rounds=128, n_blocks=2, padding=3,
                  edge_threshold=1e9, surface_threshold=1e12)
        return kw, np.zeros(n), np.ones(n - 1, bool), n
    if name == "ties_edge":
        kw = dict(nms_rounds=128, n_blocks=2, padding=3,
                  edge_threshold=1.0, surface_threshold=-1.0)
        return kw, np.ones(n), np.ones(n - 1, bool), n
    if name == "adversarial_chain":
        kw = dict(nms_rounds=128, n_blocks=1, padding=4,
                  edge_threshold=1.0, surface_threshold=-1.0)
        return kw, np.arange(n, 0, -1).astype(float), np.ones(n - 1, bool), n
    rng = np.random.default_rng(seed)
    n = int(rng.integers(30, 120))
    kw = dict(nms_rounds=128, n_blocks=int(rng.integers(1, 4)),
              padding=int(rng.integers(1, 5)),
              edge_threshold=6.0, surface_threshold=3.0)
    return (kw, rng.integers(0, 10, size=n).astype(float),
            rng.random(n - 1) < 0.8, n)


@pytest.mark.parametrize("name,seed", [
    ("ties_surface", 0), ("ties_edge", 0), ("adversarial_chain", 0),
    ("random_integer", 1), ("random_integer", 4)])
def test_nms_matches_sequential_oracle(name, seed):
    kw, curvature, nb, n = _nms_case(name, seed)
    want = _nms_oracle(curvature, nb, n, JCfg(**kw))
    np.testing.assert_array_equal(_nms_torch(curvature, nb, n, TCfg(**kw)),
                                  want)
    np.testing.assert_array_equal(
        _nms_device(curvature, nb, n, JCfg(**kw)), want)


def test_round_cap_matches_reference():
    """With the NMS round cap hit, the port still follows the reference's
    multi-select rounds (not the sequential order)."""
    kw, curvature, nb, n = _nms_case("adversarial_chain")
    kw["nms_rounds"] = 5
    np.testing.assert_array_equal(
        _nms_torch(curvature, nb, n, TCfg(**kw)),
        _nms_device(curvature, nb, n, JCfg(**kw)))


def test_full_ring_labels_match_oracle_in_float64():
    """The float64 oracle against the port run in float64 (the plain
    version is dtype-generic; the kernel is float32 only)."""
    img = _multi_ring_image(np.random.default_rng(11), 4, 512)
    xyz, count = np.asarray(img.xyz, np.float64), np.asarray(img.count)
    labels, _ = tex.label_range_image(
        tex.RangeImage(torch.as_tensor(xyz), torch.as_tensor(
            np.asarray(img.mask)), torch.as_tensor(count, dtype=torch.int32)),
        TCfg(**CFG_KW))
    for r in range(4):
        want = np_ref.extract_ring_labels(xyz[r, :count[r]], JCfg(**CFG_KW))
        np.testing.assert_array_equal(to_np(labels)[r, :count[r]], want)


def _nms_masks(labels, curvature, blk, g, *, padding, threshold, pick_max,
               point_code, neighbor_code, n_iter):
    """The NMS pass as kernel K1 computes it: 2p-bit masks per lane
    built once from static data (bit k is offset k - p below p, k - p + 1
    from p on), alive bits gathered over the window each round, and the
    labels written once at the end of the pass."""
    P = curvature.shape[-1]
    lane = torch.arange(P)
    p = padding
    offsets = [k - p if k < p else k - p + 1 for k in range(2 * p)]

    def at(a, dd, fill):
        """a[..., lane + dd], ``fill`` outside the ring."""
        j = lane + dd
        inside = (j >= 0) & (j < P)
        return torch.where(inside, a[..., j.clamp(0, P - 1)],
                           torch.full_like(a, fill))

    score = curvature if pick_max else -curvature
    win = torch.zeros(blk.shape, dtype=torch.int64)
    beats = torch.zeros(blk.shape, dtype=torch.int64)
    for k, dd in enumerate(offsets):
        in_win = ((lane + dd >= 0) & (lane + dd < P) & (at(g, dd, -1) == g)
                  & (at(blk, dd, -2) == blk))
        s_n = at(score, dd, float("-inf"))
        tie_win = dd > 0 if pick_max else dd < 0
        better = ((s_n > score) | ((s_n == score) & tie_win)) \
            & (s_n > float("-inf"))
        win |= in_win.to(torch.int64) << k
        beats |= (in_win & better).to(torch.int64) << k

    def window(bits):
        out = torch.zeros(bits.shape, dtype=torch.int64)
        for k, dd in enumerate(offsets):
            out |= at(bits, dd, False).to(torch.int64) << k
        return out

    thr_ok = (curvature >= threshold) if pick_max else \
        (curvature <= threshold)
    alive = (blk >= 0) & thr_ok & (labels == tex.DEFAULT)
    ever_sel = torch.zeros_like(alive)
    ever_win = torch.zeros_like(alive)
    for _ in range(n_iter):
        sel = alive & ((beats & window(alive)) == 0)
        if not bool(sel.any()):
            break
        hit = (win & window(sel)) != 0
        ever_sel |= sel
        ever_win |= hit
        alive = alive & ~sel & ~hit
    labels = torch.where(ever_win, neighbor_code, labels)
    return torch.where(ever_sel, point_code, labels)


@st.composite
def _nms_rings(draw):
    """One ring for an NMS pass: ties, monotone chains, infinities,
    segment breaks, rings too short for any block."""
    p = draw(st.integers(1, 16))
    n_blocks = draw(st.integers(1, 6))
    P = draw(st.integers(1, 96))
    n = draw(st.integers(0, P))
    kind = draw(st.sampled_from(["ties", "chain_up", "chain_down",
                                 "levels", "random"]))
    if kind == "ties":
        c = np.full(P, draw(st.sampled_from([0.0, 1.0, 7.0])))
    elif kind in ("chain_up", "chain_down"):
        c = np.arange(P, dtype=np.float64)
        c = c if kind == "chain_up" else c[::-1].copy()
    elif kind == "levels":
        c = np.array(draw(st.lists(st.sampled_from(
            [0.0, 1.0, 2.0, 3.0, np.inf]), min_size=P, max_size=P)))
    else:
        c = np.array(draw(st.lists(st.floats(0.0, 10.0, width=32),
                                   min_size=P, max_size=P)))
    nb = np.array(draw(st.lists(st.booleans() | st.just(True),
                                min_size=P, max_size=P)))
    nb[max(n - 1, 0):] = False
    labels = np.array(draw(st.lists(st.sampled_from(
        [tex.DEFAULT, tex.DEFAULT, tex.EDGE, tex.EDGE_NEIGHBOR]),
        min_size=P, max_size=P)))
    return dict(p=p, n_blocks=n_blocks, n=n, curvature=c, nb=nb,
                labels=labels, pick_max=draw(st.booleans()),
                threshold=draw(st.sampled_from([0.0, 1.0, 2.5, 1e9])),
                n_iter=draw(st.sampled_from([1, 2, 3, 5, 64])))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_nms_rings())
def test_nms_ballot_mask_form_matches_nms_pass(ring):
    """K1's NMS (masks built once, labels written once per pass) gives
    the labels of the port's per-round ``_nms_pass``, with and without
    the round cap hit."""
    P = len(ring["curvature"])
    count = torch.tensor([ring["n"]], dtype=torch.int32)
    curv = torch.as_tensor(ring["curvature"], dtype=torch.float32)[None]
    g = tex.gap_prefix(torch.as_tensor(ring["nb"])[None])
    blk = tex.block_ids(count, P, ring["p"], ring["n_blocks"])
    labels = torch.as_tensor(ring["labels"], dtype=torch.int32)[None]
    codes = ((tex.EDGE, tex.EDGE_NEIGHBOR) if ring["pick_max"]
             else (tex.SURFACE, tex.SURFACE_NEIGHBOR))
    kw = dict(padding=ring["p"], threshold=ring["threshold"],
              pick_max=ring["pick_max"], point_code=codes[0],
              neighbor_code=codes[1], n_iter=ring["n_iter"])
    want = tex._nms_pass(labels, curv, blk, g, count,
                         n_blocks=ring["n_blocks"], **kw)
    got = _nms_masks(labels, curv, blk, g, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pallas_labeling", [True, False])
def test_extract_features_compact_matches_reference(pallas_labeling):
    xyz, mask, count = _image(12)
    jcfg = JCfg(**CFG_KW, pallas_labeling=pallas_labeling)
    tcfg = TCfg(**CFG_KW, pallas_labeling=pallas_labeling)
    kw = dict(surface_leaf=LEAF, edges_per_ring=CE,
              surface_runs_per_ring=CS)
    want = jex.extract_features_compact(_jimage(xyz, mask, count), jcfg,
                                        **kw)
    got = tex.extract_features_compact(
        range_image_from_numpy(xyz, mask, count, "cpu"), tcfg, **kw)
    for name in ("labels", "edge_valid", "surface_valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    for name in ("edge_xyz", "surface_xyz"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np32(getattr(want, name)))
    assert_curvature_equal(got.curvature, want.curvature)


def test_extract_features_compact_kitti_preset_matches_reference():
    """The kitti_hdl64 extraction settings (padding 2, 3 degrees, edge
    threshold 50, nms_rounds 48) on a narrow bench-like scan."""
    from lidar_feature_extraction_tpu_torch.utils.synthetic import bench_scan

    xyz = bench_scan(np.random.default_rng(0), 8, 256)
    mask = np.ones(xyz.shape[:2], bool)
    count = np.full(8, 256, np.int32)
    jp, tp = j_kitti(), t_kitti()
    kw = dict(surface_leaf=1.0, edges_per_ring=8, surface_runs_per_ring=32)
    want = jex.extract_features_compact(_jimage(xyz, mask, count),
                                        jp.extraction, **kw)
    got = tex.extract_features_compact(
        range_image_from_numpy(xyz, mask, count, "cpu"), tp.extraction,
        **kw)
    np.testing.assert_array_equal(to_np(got.labels), np.asarray(want.labels))
    assert (to_np(got.labels) == tex.EDGE).any()
    np.testing.assert_array_equal(to_np(got.edge_xyz), np32(want.edge_xyz))
    np.testing.assert_array_equal(to_np(got.surface_xyz),
                                  np32(want.surface_xyz))
    assert_curvature_equal(got.curvature, want.curvature)


def test_extract_features_matches_reference():
    xyz, mask, count = _image(13)
    cfg_kw = dict(CFG_KW, max_edges=64, max_surfaces=256)
    want = jex.extract_features(_jimage(xyz, mask, count), JCfg(**cfg_kw))
    got = tex.extract_features(range_image_from_numpy(xyz, mask, count, "cpu"),
                               TCfg(**cfg_kw))
    for name in ("labels", "edge_valid", "surface_valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    for name in ("edge_xyz", "surface_xyz"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np32(getattr(want, name)))
    assert_curvature_equal(got.curvature, want.curvature)


def test_centroid_mode_is_not_ported():
    """Centroid mode (``surface_centroid=True``) against the reference,
    with and without the fused labeling: labels and validity exact,
    edges exact, surface run centroids rtol 1e-5 (per-ring cumulative
    sums, added in another order)."""
    xyz, mask, count = _image(14)
    kw = dict(surface_leaf=LEAF, edges_per_ring=CE,
              surface_runs_per_ring=CS, surface_centroid=True)
    img = range_image_from_numpy(xyz, mask, count, "cpu")
    for pallas_labeling in (True, False):
        want = jex.extract_features_compact(
            _jimage(xyz, mask, count),
            JCfg(**CFG_KW, pallas_labeling=pallas_labeling), **kw)
        got = tex.extract_features_compact(
            img, TCfg(**CFG_KW, pallas_labeling=pallas_labeling), **kw)
        for name in ("labels", "edge_valid", "surface_valid"):
            np.testing.assert_array_equal(to_np(getattr(got, name)),
                                          np.asarray(getattr(want, name)))
        np.testing.assert_array_equal(to_np(got.edge_xyz),
                                      np32(want.edge_xyz))
        np.testing.assert_allclose(to_np(got.surface_xyz),
                                   np32(want.surface_xyz), rtol=1e-5,
                                   atol=1e-5)
    # Centroids differ from the run-end points wherever a run has more
    # than one point.
    run_end = tex.extract_features_compact(
        img, TCfg(**CFG_KW), **dict(kw, surface_centroid=False))
    assert not torch.equal(run_end.surface_xyz, got.surface_xyz)
