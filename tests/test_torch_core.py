"""Port parity: config tree, quaternions, robust statistics and
build_range_image against the JAX reference.

Tolerances: quaternion and statistics functions rtol 1e-6 (float32,
same formulas, possibly another order of rounding); the range image is
exact (a stable sort and a scatter move values without arithmetic).
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_parity import np32, t32, to_np  # noqa: E402
from test_extraction import make_synthetic_ring  # noqa: E402
from lidar_feature_extraction_tpu import config as jcfg  # noqa: E402
from lidar_feature_extraction_tpu.core import quaternion as jq  # noqa: E402
from lidar_feature_extraction_tpu.core import stats as jstats  # noqa: E402
from lidar_feature_extraction_tpu.core.scan import (  # noqa: E402
    build_range_image as j_build_range_image)
from lidar_feature_extraction_tpu_torch import config as tcfg  # noqa: E402
from lidar_feature_extraction_tpu_torch.core import (  # noqa: E402
    quaternion as tq, stats as tstats)
from lidar_feature_extraction_tpu_torch.core.pose import Pose  # noqa: E402
from lidar_feature_extraction_tpu_torch.core.scan import (  # noqa: E402
    build_range_image as t_build_range_image)
from lidar_feature_extraction_tpu_torch.fusion import ekf as tekf  # noqa: E402
from lidar_feature_extraction_tpu_torch.interop import (  # noqa: E402
    feature_maps_from_numpy, geometry_maps_from_numpy, pose_from_numpy,
    range_image_from_numpy)
from lidar_feature_extraction_tpu_torch.pipeline.ekf_node import (  # noqa: E402
    EkfNode)
from lidar_feature_extraction_tpu_torch.pipeline.replay import (  # noqa: E402
    FusedLocalizationPipeline)

RTOL = 1e-6
ATOL = 1e-6


@pytest.mark.parametrize("preset", ["PipelineConfig", "kitti_hdl64",
                                    "vlp16"])
def test_config_tree_matches_reference(preset):
    assert (dataclasses.asdict(getattr(tcfg, preset)())
            == dataclasses.asdict(getattr(jcfg, preset)()))


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return np32(q / np.linalg.norm(q, axis=-1, keepdims=True))


_QUAT_CASES = {
    "hat": lambda q, p: (p,),
    "quat_multiply": lambda q, p: (q, q[::-1].copy()),
    "quat_normalize": lambda q, p: (3.0 * q,),
    "quat_rotate": lambda q, p: (q, p),
    "quat_to_matrix": lambda q, p: (q,),
    "left_multiplication_matrix": lambda q, p: (q,),
    "exp_so3": lambda q, p: (np32(np.concatenate([0.3 * p[:-1],
                                                  np.zeros((1, 3))])),),
    "drpdq": lambda q, p: (q, p),
    "quat_conjugate": lambda q, p: (q,),
    "matrix_to_quat": lambda q, p: (np32(jq.quat_to_matrix(jnp.asarray(q))),),
    "rpy_to_quat": lambda q, p: (p[:, 0].copy(), p[:, 1].copy(),
                                 p[:, 2].copy()),
    "quat_yaw": lambda q, p: (q,),
    "log_so3": lambda q, p: (np32(np.concatenate([q[:-1], q[-1:] * [
        [1.0, 1e-9, 0.0, 0.0]]])),),    # and one at the small-angle branch
}


@pytest.mark.parametrize("name", sorted(_QUAT_CASES))
def test_quaternion_function_matches_reference(name):
    rng = np.random.default_rng(0)
    q, p = _unit_quats(rng, 64), np32(rng.normal(size=(64, 3)))
    args = _QUAT_CASES[name](q, p)
    want = np32(getattr(jq, name)(*[jnp.asarray(a) for a in args]))
    got = to_np(getattr(tq, name)(*[t32(a) for a in args]))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pose_apply_matches_quat_rotate():
    rng = np.random.default_rng(1)
    q, p = _unit_quats(rng, 1)[0], np32(rng.normal(size=(16, 3)))
    t = np32([0.3, -0.2, 0.05])
    got = to_np(Pose(t32(q), t32(t)).apply(t32(p)))
    want = np32(jq.quat_rotate(jnp.asarray(q), jnp.asarray(p))) + t
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [1, 2, 257, 4000])
def test_masked_scale_bisect_matches_reference(n):
    rng = np.random.default_rng(n)
    v = np32(rng.exponential(size=n))
    m = rng.random(n) < 0.7
    m[0] = True
    want = np32(jstats.masked_scale_bisect(jnp.asarray(v), jnp.asarray(m)))
    got = to_np(tstats.masked_scale_bisect(t32(v), torch.as_tensor(m)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_huber_derivative_matches_reference():
    e = np32(np.random.default_rng(2).exponential(scale=3.0, size=512))
    want = np32(jstats.huber_derivative(jnp.asarray(e), 1.345))
    got = to_np(tstats.huber_derivative(t32(e), 1.345))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_build_range_image_is_exact():
    rng = np.random.default_rng(3)
    rings = [make_synthetic_ring(rng, int(rng.integers(40, 300)))
             for _ in range(5)]
    xyz = np32(np.concatenate(rings))
    ring = np.concatenate([np.full(len(r), i) for i, r in enumerate(rings)])
    ring[:7] = 3          # a few points in another ring
    valid = rng.random(len(xyz)) < 0.95
    perm = rng.permutation(len(xyz))
    args = (xyz[perm], ring[perm].astype(np.int32), valid[perm])
    kw = dict(n_rings=6, max_points_per_ring=256, min_points_per_ring=8)
    want = j_build_range_image(*[jnp.asarray(a) for a in args], **kw)
    got = t_build_range_image(t32(args[0]), torch.as_tensor(args[1]),
                              torch.as_tensor(args[2]), **kw)
    np.testing.assert_array_equal(to_np(got.mask), np.asarray(want.mask))
    np.testing.assert_array_equal(to_np(got.count), np.asarray(want.count))
    m = np.asarray(want.mask)
    np.testing.assert_array_equal(to_np(got.xyz)[m], np32(want.xyz)[m])


_Q, _T = np32([1.0, 0.0, 0.0, 0.0]), np32([0.3, -0.2, 0.05])
_REC = np.zeros((5, 8), np.float32)
_EKF = tcfg.EkfConfig(extend_state_step=2)
_ENTRY_POINTS = {
    "quat_identity": lambda **kw: tq.quat_identity(**kw),
    "Pose.identity": lambda **kw: Pose.identity(**kw).q,
    "pose_from_numpy": lambda **kw: pose_from_numpy(_Q, _T, **kw).t,
    "range_image_from_numpy": lambda **kw: range_image_from_numpy(
        np.zeros((2, 8, 3), np.float32), np.ones((2, 8), bool),
        np.full(2, 8), **kw).xyz,
    "geometry_maps_from_numpy": lambda **kw: geometry_maps_from_numpy(
        _REC, np32(0.5), np.zeros(3, np.float32), (2, 2, 1), _REC,
        np32(0.5), np.zeros(3, np.float32), (2, 2, 1), **kw).edge.rec,
    "feature_maps_from_numpy": lambda **kw: feature_maps_from_numpy(
        np.zeros((5, 2, 3), np.float32), np.zeros(5, np.int32), np32(0.5),
        np.zeros(3, np.float32), (2, 2, 1), np.zeros((5, 2, 3), np.float32),
        np.zeros(5, np.int32), np32(0.5), np.zeros(3, np.float32),
        (2, 2, 1), **kw).surface.points,
    "init_ekf": lambda **kw: tekf.init_ekf(_EKF, **kw).td.p,
    "process_noise": lambda **kw: tekf.process_noise([1.0, 2.0, 3.0, 4.0],
                                                     **kw),
    "Filter1D.create": lambda **kw: tekf.Filter1D.create(**kw).x,
    "EkfNode": lambda **kw: EkfNode(_EKF, **kw).ekf.td.x,
    "FusedLocalizationPipeline": lambda **kw: FusedLocalizationPipeline(
        None, tcfg.PipelineConfig(ekf=_EKF), **kw).pose_r,
}


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default succeeds")


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(no_cuda, name):
    """Without a card the default device raises (torch's own error)
    instead of quietly giving CPU tensors; the CPU is there on request."""
    with pytest.raises((AssertionError, RuntimeError)):
        _ENTRY_POINTS[name]()
    assert _ENTRY_POINTS[name](device="cpu").device.type == "cpu"


_ROOT = Path(__file__).resolve().parents[1]
_PORT_FILES = sorted(
    [p for p in (_ROOT / "lidar_feature_extraction_tpu_torch").rglob("*.py")]
    + [_ROOT / name for name in ("chip_smoke.py", "gn_kernels_check.py",
                                 "k1_check.py",
                                 "profile_drive.py", "profile_fits.py",
                                 "profile_fma_gn_update.py",
                                 "profile_k1.py", "profile_lu_solve.py",
                                 "profile_normal_equations.py",
                                 "profile_pose_graph.py",
                                 "profile_robust_weights.py",
                                 "reference_cases.py", "scatter_probe.py",
                                 "tests/torch_parallel_worker.py")])


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _PORT_FILES,
                         ids=lambda p: str(p.relative_to(_ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    """The machine with the card has no JAX, and the JAX package's
    __init__ imports it: no module of the port, nor the scripts that
    drive it on the card, may import either (the port keeps its own
    copies of the numpy-only modules it needs)."""
    banned = ("jax", "jaxlib", "lidar_feature_extraction_tpu")
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in banned]
    assert not bad, f"{path.name} imports {bad}"


_SLICE_MODULES = ("io/convert.py", "io/kitti.py", "io/native_io.py",
                  "ops/alignment.py",
                  "ops/color.py", "parallel/distributed.py",
                  "pipeline/launch.py", "pipeline/trajectory.py",
                  "ops/scatter.py", "ops/voxel_map.py",
                  "utils/profiling.py", "utils/visualize.py",
                  "parallel/mesh.py", "parallel/multihost.py",
                  "pipeline/mapping_chunk.py")


@pytest.mark.parametrize("module", _SLICE_MODULES)
def test_import_scan_covers_the_batch_and_entry_modules(module):
    """The scan above reaches every module of the batched localizer, the
    entry points, the fixed-order scatter, the hash map, the profiling
    and PLY utilities, the mesh and process group and the chunked front
    end (it globs the package; a module left out of the glob would go
    unchecked), and the worker script the multi-device tests spawn."""
    assert _ROOT / "lidar_feature_extraction_tpu_torch" / module in \
        _PORT_FILES
    assert _ROOT / "tests" / "torch_parallel_worker.py" in _PORT_FILES


# --- completeness: every public name of the JAX package has a
# counterpart in the port's module of the same path ---

_JAX_ROOT = _ROOT / "lidar_feature_extraction_tpu"
_JAX_MODULES = sorted(str(p.relative_to(_JAX_ROOT))
                      for p in _JAX_ROOT.rglob("*.py"))
# Names the port holds elsewhere on purpose.
_MOVED = {
    # K1, the repo's one TPU kernel: the CUDA kernel's wrapper
    # ops/extraction_cuda.py::label_and_columns_cuda (and its plain
    # version ops/extraction.py::label_and_columns_plain).
    "ops/extraction_pallas.py": {"label_and_columns_pallas"},
    # The reference loads its submodules lazily so that nothing starts
    # the XLA backend before jax.distributed; the port's __init__ loads
    # nothing, so it has no hook.
    "parallel/__init__.py": {"__getattr__", "__dir__"},
}


def _public_api(path: Path) -> set:
    """Public top-level functions and classes, public methods of public
    classes ("Class.method"), and the module's own ``__getattr__`` /
    ``__dir__`` hooks."""
    names = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            continue
        if node.name.startswith("_") and node.name not in ("__getattr__",
                                                           "__dir__"):
            continue
        names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names |= {f"{node.name}.{m.name}" for m in node.body
                      if isinstance(m, ast.FunctionDef)
                      and not m.name.startswith("_")}
    return names


def _bound_names(path: Path) -> set:
    """Every name a module binds at its top level (a definition, an
    assignment or an import), and every name a class binds in its body
    ("Class.name")."""
    names = set()

    def targets(node):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            return [node.name]
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            return [(a.asname or a.name).split(".")[0] for a in node.names]
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            tg = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            return [t.id for t in tg if isinstance(t, ast.Name)]
        return []

    for node in ast.parse(path.read_text(), str(path)).body:
        names.update(targets(node))
        if isinstance(node, ast.ClassDef):
            names |= {f"{node.name}.{n}" for m in node.body
                      for n in targets(m)}
    return names


@pytest.mark.parametrize("module", _JAX_MODULES)
def test_port_has_every_public_name_of_the_reference(module):
    port = _ROOT / "lidar_feature_extraction_tpu_torch" / module
    have = _bound_names(port) if port.exists() else set()
    missing = sorted(_public_api(_JAX_ROOT / module) - have
                     - _MOVED.get(module, set()))
    assert not missing, f"{module}: no counterpart in the port: {missing}"


def test_completeness_allow_list_is_current():
    """Every name the allow-list excuses is still public in the
    reference and still absent from the port's module."""
    for module, names in _MOVED.items():
        port = _ROOT / "lidar_feature_extraction_tpu_torch" / module
        have = _bound_names(port) if port.exists() else set()
        assert names <= _public_api(_JAX_ROOT / module), module
        assert not names & have, module
    assert (_ROOT / "lidar_feature_extraction_tpu_torch" / "ops"
            / "extraction_cuda.py").exists()
