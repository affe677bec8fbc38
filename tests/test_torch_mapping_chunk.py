"""Port parity of the chunked mapping front end
(``pipeline/mapping_chunk.py``): a block of range images through one
extraction, then constant-velocity odometry scan by scan, then the host's
keyframe / loop / back-end bookkeeping, or, when a scan of the block is
suspect, the block replayed scan by scan through the host ``Odometry``.

The scans are tests/test_mapping_chunk.py's construction (its tiny
16 x 512 configuration, the ray-cast circle of 24 scans), cut to the
first 12 scans in blocks of 6 with the odometry grid cut to 32 x 32 x 8
voxels. At this configuration the odometry's edge fit exceeds the
facade's 0.3 m gate on nearly every scan, so with the gate on every
block would take the replay path, whose coarse re-seed registrations
take seconds per scan on the CPU; the runs here set
``edge_gate_distance = None`` on both sides, so a block replays only
when a scan fails outright: the clean run takes the block path, and the
run whose scan 7 is dead (every point invalid, EMPTY_INPUT) replays its
second block; both are held to the port's per-scan pipeline on the same
scans (the replay is that pipeline's ``process_scan``, which
test_torch_slam.py holds to the reference). ``_block_suspect`` is held
to the reference's with the gate on, on statuses and edge errors made
for it. On the card (chip_smoke's ``chunk`` phase) the gate stays on, at
full width.

The reference runs its back-end solvers jitted as in
test_torch_slam.py. Tolerances: keyframe and constraint counts exactly;
the keyframe trajectory within 1e-3 m (the reference test's own); a
block's per-scan poses within 1e-4 m and statuses exactly against the
reference's ``mapping_chunk_step`` on a carry carried across from it;
the port's block path against its own per-scan pipeline bit for bit (the
same operations on the same features).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_enable_x64", True)   # as in-suite (test_extraction)

from torch_parity import np32, port_config, to_np  # noqa: E402
from test_mapping_chunk import raycast_images, tiny_cfg  # noqa: E402
from test_torch_slam import _jitted_reference  # noqa: E402
from lidar_feature_extraction_tpu.ops import gauss_newton as jgn  # noqa: E402
from lidar_feature_extraction_tpu.pipeline import (  # noqa: E402
    mapping_chunk as jmc)
from lidar_feature_extraction_tpu_torch import interop  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.scan import (  # noqa: E402
    RangeImage)
from lidar_feature_extraction_tpu_torch.ops.extraction import (  # noqa: E402
    extract_features)
from lidar_feature_extraction_tpu_torch.pipeline import (  # noqa: E402
    mapping_chunk as tmc)
from lidar_feature_extraction_tpu_torch.pipeline.slam import (  # noqa: E402
    MappingPipeline)

N_SCANS, BLOCK, DEAD = 12, 6, 7
KW = dict(loop_radius=4.0, loop_min_gap=5, optimize_every=6)
TRAJ_ATOL = 1e-3
POSE_ATOL = 1e-4
CPU = "cpu"


def _cfgs():
    jc = tiny_cfg()
    jc = dataclasses.replace(jc, registration=dataclasses.replace(
        jc.registration, odometry_grid_dims=(32, 32, 8)))
    return jc, port_config(jc)


def _stamps(s, n):
    return [0.1 * (s + k) for k in range(n)]


class _Counted(tmc.ChunkedMappingPipeline):
    """The port's pipeline, counting the scans it replays."""

    replayed = 0

    def _extract(self, image):
        self.replayed += 1
        return super()._extract(image)


def _blocks(images):
    for s in range(0, len(images), BLOCK):
        yield s, images[s:s + BLOCK]


def _run_reference(jc, images):
    pipe = jmc.ChunkedMappingPipeline(jc, **KW)
    pipe.odometry.edge_gate_distance = None
    with _jitted_reference():
        for s, blk in _blocks(images):
            pipe.process_block(jax.tree.map(lambda *xs: jnp.stack(xs), *blk),
                               _stamps(s, len(blk)))
        pipe.optimize()
    return pipe


def _run_port(tc, images):
    pipe = _Counted(tc, device=CPU, **KW)
    pipe.odometry.edge_gate_distance = None
    for s, blk in _blocks(images):
        pipe.process_block(interop.range_images_from_numpy(
            *(np.stack(f) for f in zip(*blk)), device=CPU),
            _stamps(s, len(blk)))
    pipe.optimize()
    return pipe


def _run_per_scan(tc, images):
    """The port's per-scan pipeline over the same scans, the gate off."""
    pipe = MappingPipeline(tc, device=CPU, **KW)
    pipe.odometry.edge_gate_distance = None
    for n, im in enumerate(images):
        f = extract_features(interop.range_image_from_numpy(*im, device=CPU),
                             tc.extraction)
        pipe.process_scan(f.edge_xyz, f.edge_valid, f.surface_xyz,
                          f.surface_valid, stamp=0.1 * n)
    pipe.optimize()
    return pipe


@pytest.fixture(scope="module")
def runs():
    jc, tc = _cfgs()
    jimages = raycast_images(jc)[:N_SCANS]
    dead = jax.tree.map(jnp.zeros_like, jimages[DEAD])
    jdead = list(jimages)
    jdead[DEAD] = dead._replace(mask=jnp.zeros_like(dead.mask))
    images = [tuple(np.asarray(a) for a in im) for im in jimages]
    dead_images = [tuple(np.asarray(a) for a in im) for im in jdead]
    return {"cfgs": (jc, tc), "jimages": jimages, "images": images,
            "clean": (_run_reference(jc, jimages), _run_port(tc, images)),
            "dead": _run_port(tc, dead_images),
            "per_scan": {"clean": _run_per_scan(tc, images),
                         "dead": _run_per_scan(tc, dead_images)}}


def test_chunked_pipeline_matches_reference(runs):
    want, got = runs["clean"]
    assert len(got.keyframes) == len(want.keyframes)
    assert [c[:2] for c in got.constraints] == \
        [c[:2] for c in want.constraints]
    np.testing.assert_allclose(got.trajectory, np32(want.trajectory),
                               rtol=0, atol=TRAJ_ATOL)
    assert np.isfinite(got.trajectory).all()


@pytest.mark.parametrize("case", ["clean", "dead"])
def test_chunked_pipeline_equals_per_scan(runs, case):
    """The block path (clean) and the replay (the dead scan's block) give
    the per-scan pipeline's keyframes, constraints, trajectory and
    odometry state bit for bit."""
    got = runs["clean"][1] if case == "clean" else runs["dead"]
    per_scan = runs["per_scan"][case]
    assert got.odometry.n_scans == per_scan.odometry.n_scans == N_SCANS
    assert len(got.keyframes) == len(per_scan.keyframes) >= 3
    assert [c[:2] for c in got.constraints] == \
        [c[:2] for c in per_scan.constraints]
    np.testing.assert_array_equal(got.trajectory, per_scan.trajectory)
    for a, b in zip(got.odometry.state, per_scan.odometry.state):
        assert torch.equal(a, b)
    assert np.isfinite(got.trajectory).all()


@pytest.mark.parametrize("case", ["clean", "dead"])
def test_only_a_suspect_block_replays(runs, case):
    """No block of the clean run replays; in the other, the dead scan's
    block (the second) is replayed scan by scan and the first is not."""
    got = runs["clean"][1] if case == "clean" else runs["dead"]
    assert got.replayed == (0 if case == "clean" else BLOCK)


def test_chunk_step_matches_reference_on_a_carried_carry(runs):
    """The second block through ``mapping_chunk_step`` from the
    reference's carry after the first, carried across by
    ``interop.chunk_carry_from_numpy``; the carry it was given is left as
    it was (the suspect path replays from it)."""
    jc, tc = runs["cfgs"]
    jimages = runs["jimages"]
    stack = lambda blk: jax.tree.map(lambda *xs: jnp.stack(xs), *blk)  # noqa: E731
    jcarry, _ = jmc.mapping_chunk_step(jmc.init_chunk_carry(jc),
                                       stack(jimages[:BLOCK]), jc)
    want_carry, want = jmc.mapping_chunk_step(jcarry, stack(
        jimages[BLOCK:2 * BLOCK]), jc)
    carry = interop.chunk_carry_from_numpy(
        [np.asarray(a) for a in jcarry.odo], np.asarray(jcarry.prev_q),
        np.asarray(jcarry.prev_t), device=CPU)
    before = [a.clone() for a in (*carry.odo, carry.prev_q, carry.prev_t)]
    images = interop.range_images_from_numpy(*(np.stack(f) for f in zip(
        *runs["images"][BLOCK:2 * BLOCK])), device=CPU)
    got_carry, got = tmc.mapping_chunk_step(carry, images, tc)
    for a, b in zip(before, (*carry.odo, carry.prev_q, carry.prev_t)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(to_np(got.status), np.asarray(want.status))
    for name in ("pose_t", "pose_q"):
        np.testing.assert_allclose(to_np(getattr(got, name)),
                                   np32(getattr(want, name)), rtol=0,
                                   atol=POSE_ATOL)
    for name in ("edge_valid", "surf_valid"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(to_np(got_carry.odo.pose_t),
                               np32(want_carry.odo.pose_t), rtol=0,
                               atol=POSE_ATOL)
    assert int(got_carry.odo.n_scans) == int(want_carry.odo.n_scans)


def test_block_path_extracts_each_scan_as_alone(runs):
    """One extraction of the block gives each scan the features its lone
    extraction gives (on the card: one K1 launch for the block)."""
    _, tc = runs["cfgs"]
    blk = runs["images"][:BLOCK]
    batch = extract_features(interop.range_images_from_numpy(
        *(np.stack(f) for f in zip(*blk)), device=CPU), tc.extraction)
    for b, im in enumerate(blk):
        one = extract_features(RangeImage(*(torch.as_tensor(a) for a in im)),
                               tc.extraction)
        for name in ("labels", "edge_xyz", "edge_valid", "surface_xyz",
                     "surface_valid"):
            assert torch.equal(getattr(batch, name)[b], getattr(one, name))


@pytest.mark.parametrize("keyframes", [0, 3])
def test_block_suspect_gate_matches_reference(runs, keyframes):
    """``_block_suspect`` with the facade's gate (0.3 m) on statuses and
    edge errors made for it: exempt first scan, bad statuses, errors
    above and below the gate, non-finite errors."""
    jc, tc = runs["cfgs"]
    want = jmc.ChunkedMappingPipeline(jc)
    got = tmc.ChunkedMappingPipeline(tc, device=CPU)
    want.keyframes = got.keyframes = [None] * keyframes
    gate_sq = (2 * 0.3) ** 2      # the squared residual at the gate
    cases = [
        ([jgn.EMPTY_INPUT, 2, 3], [0.0, 0.1, 0.1]),
        ([2, jgn.EMPTY_INPUT, 3], [0.0, 0.1, 0.1]),
        ([2, 3, jgn.MAX_ITERATIONS], [0.1, 0.1, 0.1]),
        ([0, 2, 3], [0.1, 1.01 * gate_sq, 0.1]),
        ([0, 2, 3], [0.1, 0.99 * gate_sq, 0.1]),
        ([0, 2, 3], [1.01 * gate_sq, 0.1, 0.1]),
        ([0, 2, 3], [0.1, np.inf, np.nan]),
    ]
    for status, err in cases:
        status = np.asarray(status, np.int32)
        err = np32(err)
        block = np32(np.stack([err, err], -1))
        assert got._block_suspect(status, err) == \
            want._block_suspect(status, block), (status, err)
