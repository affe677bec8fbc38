"""The Gauss-Newton update's XLA:CPU forms (``core/_xla_dot.py``, ROADMAP
§C21) held to the JAX package.

XLA:CPU sums the normal equations D = jv^T j and A = jw^T j in a tree
that depends on its intra-op thread pool, so they are held to values
recorded by ``tests/torch_reference_record.py --drive --write`` on the
machine that wrote the drive record (``tests/data/torch_reference_
drive.npz``; its manifest names the machine's ``cpu_count`` and the
tree's parameters), not to a live run: under xdist the test machine's
pool may differ. Checked here:

- the port's tree constants are the recorded machine's;
- D, A and b of seeded problems at the record's row counts (unsharded,
  sharded in 6 and in 8 blocks, the faithful and production drives'
  rows) and every ±2^40 probe pair's sums equal the record bit for bit;
- the tree covers the rows in order, in at most ``XLA_CPU_THREADS``
  blocks, and a batch's lanes are summed like their lone problems;
- the Huber weights (XLA's float32 rsqrt: the x86 estimate and two
  Newton steps) equal the record;
- the error total (XLA's tree reduction, which no thread count changes)
  equals jitted ``jnp.sum`` at several lengths, live.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import reference_cases as rc  # noqa: E402
from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd  # noqa: E402
from lidar_feature_extraction_tpu_torch.core import stats  # noqa: E402

jax.config.update("jax_enable_x64", True)   # as in-suite


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.fixture(scope="module")
def record():
    return rc.load_drive()


def test_contraction_constants_are_the_recorded_machines(record):
    _, manifest = record
    want = manifest["xla_cpu_contraction"]
    got = {"threads": xd.XLA_CPU_THREADS, "single_kc": xd.SINGLE_KC,
           "threaded_kc": xd.THREADED_KC, "dnnl_k_block": xd.DNNL_K_BLOCK,
           "shard_above": xd.SHARD_ABOVE, "eight_above": xd.EIGHT_ABOVE,
           "group": xd.GROUP, "packet_entries": xd.PACKET_ENTRIES,
           "rows": list(rc.NE_ROWS)}
    assert got == want
    assert xd.XLA_CPU_THREADS == manifest["cpu_count"]


@pytest.mark.parametrize("m", rc.NE_ROWS)
def test_normal_equations_equal_the_record(record, m):
    arrays, _ = record
    got = xd.normal_equations_plain(*map(torch.as_tensor, rc.ne_problem(m)))
    for key, value in zip("DAb", got):
        np.testing.assert_array_equal(
            _bits(value), _bits(arrays[f"normal_equations.{m}.{key}"]), key)


@pytest.mark.parametrize("m", rc.NE_ROWS)
def test_probe_sums_equal_the_record(record, m):
    """The full ``a.T @ b`` of each probe pair: its 49 entries count the
    rows summed after the pair met in their trees (the 49th entry's tree
    differs from the others' when the rows are sharded)."""
    arrays, _ = record
    want = arrays[f"normal_equations.{m}.probe"]
    for (p, q), w in zip(rc.ne_probe_pairs(m), want):
        a, b = map(torch.as_tensor, rc.probe_operands(m, p, q))
        d = xd.normal_equations_plain(a, a, b, b[:, 0])[0]
        np.testing.assert_array_equal(_bits(d), _bits(w), f"pair {p}, {q}")


def test_contraction_tree_covers_the_rows_in_order():
    for m in (*range(1, 20000, 97), *rc.NE_ROWS):
        sharded, blocks = xd.contraction_tree(m)
        chunks = [c for blk in blocks for c in blk]
        assert chunks[0][0] == 0 and chunks[-1][1] == m, m
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:])), m
        assert all(lo < hi for lo, hi in chunks), m
        assert sharded == (m > xd.SHARD_ABOVE), m
        assert len(blocks) <= xd.XLA_CPU_THREADS, m


def test_batch_lanes_sum_like_lone_problems():
    for m in (4099, 8198):
        lanes = [rc.ne_problem(m + k) for k in range(3)]
        cut = min(len(lane[3]) for lane in lanes)
        batch = [torch.as_tensor(np.stack([lane[i][:cut] for lane in lanes]))
                 for i in range(4)]
        got = xd.normal_equations_plain(*batch)
        for k in range(3):
            lone = xd.normal_equations_plain(*(x[k] for x in batch))
            for g, w in zip(got, lone):
                np.testing.assert_array_equal(_bits(g[k]), _bits(w))


def test_huber_weights_equal_the_record(record):
    arrays, _ = record
    got = stats.huber_derivative(torch.as_tensor(rc.huber_inputs()))
    np.testing.assert_array_equal(_bits(got), _bits(arrays["huber.weights"]))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1000, 1100, 6144, 10240,
                               14336, 40001])
def test_reduce_sum_equals_jitted_sum(n):
    rng = np.random.default_rng(n)
    e = np.float32(rng.exponential(size=(2, n)) * 10.0 ** rng.uniform(
        -3, 3, (2, n)))
    want = np.stack([np.asarray(jax.jit(jnp.sum)(jnp.asarray(r))) for r in e])
    np.testing.assert_array_equal(_bits(xd.reduce_sum(torch.as_tensor(e))),
                                  _bits(want))
