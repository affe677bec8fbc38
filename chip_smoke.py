"""Drive the PyTorch port's scan-to-map localization step, its closed
loop (registration + EKF), its odometry, its keyframe SLAM pipeline, its
batched localizer on every branch, its KITTI entry point, its voxel-hash
map, its multi-device code (process group, sharded localizer and graph
solvers), its chunked mapping front end and its host-stepped localizer
on a CUDA card and check them; then hold the card to the committed
record of the JAX package's results at full width under both presets.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each of which must pass (any failure exits non-zero):

1. build: ``nvcc`` builds kernel K1 from ``lidar_feature_extraction_tpu_
   torch/csrc/extraction_k1.cu``, ``fma_f32`` from ``csrc/fma_f32.cu``
   with its PyTorch operator ``csrc/fma_f32_op.cpp`` and
   ``normal_equations`` from ``csrc/normal_equations.cu`` with its
   operators ``csrc/normal_equations_op.cpp``, and the Gauss-Newton
   step's two fused kernels ``gn_update`` (``csrc/gn_update.cu``) and
   ``robust_weights`` (``csrc/robust_weights.cu``) into one library with
   their operators (``csrc/gn_kernels_op.cpp``), all four libraries
   started together; then ``fma_f32`` (the one-launch float32 fused
   multiply-add of ``core/_xla_f32.py::fma``) against its plain version
   on the card, bit for bit (NaN against NaN): 10^6 random triples of
   every magnitude, signed zeros, subnormals, infinities, NaN, exact
   cancellations, near-halfway sums, and the layouts of ``FMA_LAYOUTS``
   (sizes about a float4's multiple, views off 16-byte alignment, scalar
   and broadcast ``a``, transposed and strided views, 8 dimensions that
   coalesce, empty operands, which launch nothing);
   and ``normal_equations`` (the Gauss-Newton D, A and b in XLA:CPU's
   summation order, ROADMAP §C21, §C22) against its plain version
   ``core/_xla_dot.py::normal_equations_plain``, bit for bit: its tree
   equal to ``contraction_tree`` for every row count up to 16,384, then
   seeded problems at row counts of every regime (the gradient's loops
   under 4,096 rows and its tiled loop from there, not multiples of a
   block among them) at B = 1, 8 and 32, with j read through strides,
   row-major (bulk copies) and starting off a 16-byte boundary, each
   lane equal to its lone launch; and the kernel against the drive
   record's reference bits (the JAX package's jitted expressions) at its
   15 small and 5 large row counts and the two cut-width first updates;
   and ``gn_update`` (the update after the normal equations: solve,
   degeneracy guard, pose update) and ``robust_weights`` (valid count,
   error total, MAD scale, Huber weights, block medians) against their
   plain versions ``_xla_dot.gn_update_plain`` and
   ``stats.robust_weights_plain``, bit for bit (NaN against NaN), on
   ``gn_kernels_check.py``'s seeded cases at 2,047 / 10,240 / 14,336 rows
   or correspondences (and 1, 33, 81,920 correspondences) x B = 1 / 8 /
   32, the edge cases in a batch's first eight lanes, each lane equal to
   its lone launch;
2. scenes: the reference ``bench.py`` scene (seed 0, 64 x 2304 range
   image, a map of the scan's features at 7 noisy keyframe poses) and a
   street canyon ray-cast from 7 keyframes of one world, both at
   ``kitti_hdl64()`` widths; the maps come from the port's own
   ``extract_features`` + ``build_geometry_maps`` on the card;
3. localize: 20 chained ``localize_scan`` calls per scene and prior (the
   bench's best-case prior t = (0.3, -0.2, 0.05), and it with a 0.2 m +
   ~1 degree error drawn with numpy), each on a fresh image tensor. K1's
   launch count is reset just before and read just after, and must be at
   least the number of scans; fma_f32's launches are tallied by element
   count (``fma_size_tally``) over the same calls. Every result must be
   finite and registered (a status other than EMPTY_INPUT, at least one
   iteration). On the
   street scene the best-case prior must end within 0.1 m of the truth
   (identity), and no noisy prior may end farther from it than it began.
   ``normal_equations``, ``robust_weights`` and ``gn_update`` are counted
   over the same calls (as over the drives, the batch phase and the host
   phase): one launch of each per GN iteration, so the three counts must
   be equal. The first scan of each run is replayed through the plain
   extraction path and must give the same registration result. The
   status is not held to CONVERGED / MAX_ITERATIONS: like the reference,
   registration usually stops at its error- or scale-increase abort once
   near the optimum, and on the bench scene (a map of copies that
   disagree by up to 2 m) that optimum is not the identity;
4. drive: the closed loop of ``eval_ate.py`` on the card. The port's
   worldsim makes the seed-0 world (50 poles, 35 m), its maps (30,000
   ground points) and 20 ray-cast scans of 64 rings x 2048 azimuths with
   vehicle twists; ``build_geometry_maps`` and ``build_feature_maps``
   build the maps on the card (each build's wall time is printed); then
   ``FusedLocalizationPipeline`` replays the drive with ``kitti_hdl64()``
   (production) and with its faithful variant (full extraction, point
   maps, refits every iteration). K1's count is reset just before each
   run and read just after, and must be at least the number of scans;
   every pose must be finite; each run's ATE must be at most 1.25 x its
   ``ATE_EVAL.json`` figure + 0.005 m, and production / faithful at most
   1.2. The drive's inputs must be those of the committed drive record
   (``tests/data/torch_reference_drive.npz``, what the JAX package's
   ``FusedLocalizationPipeline`` computes over this drive on the CPU;
   ``reference_cases.py`` reads it), and each drive is held to it: the
   first ``DRIVE_HELD_SCANS`` scans (both drives all 20, ROADMAP §C21)
   with the record's status and iterations and measured and fused
   positions within ``reference_cases.DRIVE_T_ATOL`` (1e-6 m); every
   scan's gaps and the first scan that differs are printed. K1's,
   fma_f32's and normal_equations' counts are reset just before each
   run and read just after; each must be at least the number of
   scans; fma_f32's launches are also tallied by element count, in
   power-of-two buckets and the most common counts (as in phase 3's
   line). Per run: ATE, xy ATE, mean step drift, ms/scan (host
   clock ending in ``synchronize()``: mean, median, first scan), GN
   iterations and status counts, and the wall time of the last scan's
   ``localize_scan`` alone, run again from the previous scan's fused
   pose;
5. odometry: ``bench_odometry.py``'s extracted-features chain made by the
   port (seed 0, 50 poles over 60 m, ``straight_drive``, 100 ray-cast
   64 x 2048 sweeps through the range image and ``extract_features``),
   then ``geometry_odometry_step`` over it with the constant-velocity
   prior carried as in its ``bench_mode``. Prints ms/scan (host clock
   ending in ``synchronize()``: mean, median, first), GN iterations per
   scan, final drift, mean step drift and K1's launches; every pose must
   be finite, K1 launched at least once per frame and the mean step
   drift at most 1.25 x ``ODOMETRY_BENCH.json``'s + 0.005 m;
6. slam: ``eval_ate.py``'s two ``slam_loop`` drives through the port's
   ``run_mapping_drive`` (80 scans of 64 x 2048 around a 10 m circle,
   loop radius 6 m, gap 10, an optimization every 8 keyframes; without
   then with IMU windows), drawing from the drive's generator after its
   twists as eval_ate.py does. Per run: the optimized keyframe
   trajectory's ATE, keyframes, loop constraints, ms/scan of
   ``process_scan`` (mean, median, max), the number and wall time of
   ``optimize()`` calls and of loop-closure registrations, the gyro bias
   recovered, the run's wall time and K1's and fma_f32's launches (each
   count reset just before the run and read just after). ATE at most
   1.25 x ``ATE_EVAL.json``'s + 0.005 m, 40 +- 2 keyframes, a loop
   constraint or more, everything finite, K1 and fma_f32 each launched
   at least once per scan. slam_loop without IMU must equal the mapping
   record bit for bit: every scan's odometry pose and features, the
   keyframes, the loop pairs, every ``optimize()``'s graph, the
   trajectory and the ATE;
7. batch: the batched localizer (``make_batched_localizer``, B scans
   through one extraction, one K1 launch on the [B * 64, 2304] planes,
   and one lock-step Gauss-Newton loop) at B = 1, 8 and 32 on both
   scenes. Lane b is the scene's image moved by 1e-3 * b m with the b-th
   noisy prior of phase 3, so the lanes stop at different iterations
   (checked). Every lane's status and iterations must equal
   ``localize_scan`` run on that lane alone on the card, its pose within
   1e-4; a lane that ends otherwise is printed with the margins of its
   lone run's abort tests, and passes only as a rounding tie (a status or
   iteration count apart, with the error or the scale test within 1e-5
   of its threshold), at most one per 32. The batch's K1 output must be bit-equal to
   B single launches and to the plain version. Per B and scene: scans/s
   and ms per batch and per scan (host clock ending in
   ``synchronize()``, the median of 5 batches after an untimed one), GN
   iterations (max, mean), K1 launches per batch (must be 1) and
   ``torch.cuda.max_memory_allocated``;
8. kitti: the drive of phase 4 written as a KITTI sequence (``.bin``
   scans, PCD maps) into a temporary directory, then
   ``launch.load_config("kitti_hdl64")``, ``launch.load_maps`` and
   ``run_kitti_localization`` (no twists) on the card; the fused
   positions' ATE must be at most 1.25 x the JAX package's on the same
   files + 0.005 m, K1 launched once per scan. The written ``.bin``
   files, read once through ``io/native_io.ScanPrefetcher``, must equal
   ``io/kitti.read_velodyne_bin``'s reads;
9. determinism (ROADMAP §C16): the drive's GeometryMaps built again and
   the production drive of phase 4 replayed on them; the maps' records,
   every scan's measured and fused pose and the ATE must equal the first
   run's bit for bit. Then each float scatter-add of the port, called
   twice on this run's inputs (the drive map's moments, a drive scan's
   surface downsample alone, as a batch of 8 and over the dense grid, a
   40-keyframe pose graph's normal equations and CG rows), must give the
   same bits both times;
10. batch_full: the batched full-extraction branches through
   ``make_batched_localizer`` at B = 1 and 8 on the drive's scans (lane
   b is scan b, its prior the true pose moved by 0.1-0.9 m with a yaw
   error): the faithful variant over the drive's FeatureMaps (kNN rounds
   refitting every iteration) and ``kitti_hdl64()`` with the full
   extraction over its GeometryMaps. Every lane's status and iterations
   must equal its lone ``localize_scan`` on the card, its pose within
   1e-4; one K1 launch per batch; at B = 8 the lanes stop at different
   iterations and, in the kNN case, some lanes run the second search
   round and some do not (recorded on an untimed batch). Per case and B:
   scans/s and ms per batch (``utils.profiling.StageTimer`` over
   ``BATCH_REPS`` batches after an untimed one), GN iterations (max,
   mean), the lanes that reran and ``torch.cuda.max_memory_allocated``;
11. voxel_map: ``build_voxel_map`` of the drive's edge and surface map
   clouds on the card (``VoxelMapConfig``'s 2^18 buckets, 8 slots, 16
   probes) in the dense grids' frames; its ``knn`` must equal the dense
   grids' ``knn`` on the middle drive scan's features at its true pose
   (neighbours, validity, squared distances bit for bit), and so must
   ``edge_residuals`` / ``surface_residuals`` through ``lookup_knn``.
   Build time, buckets used and both kNN times (CUDA events) are
   printed; one ``export_labeled_scan`` PLY's header and size checked;
12. multi: ``multihost.spawn`` starts 2 gloo ranks on the one card
   (``spawn`` processes: this one has started CUDA; K1 is only loaded
   there, built here). Each builds the bench scene, replicates the maps
   (``replicate_to_global``, checksums all-reduced) and runs the batched
   localizer over the mesh at a global B = 8 (its 4 lanes, one K1 launch
   per batch, ``BATCH_REPS`` timed batches after an untimed one): every
   lane equal to its lone ``localize_scan`` bit for bit, the whole batch
   through ``gather_to_host``. Then the dense and CG pose-graph solves of
   ``seeded_graph`` (40 keyframes, 47 constraints and one zero-weight
   lane) through ``make_distributed_pose_graph_optimizer`` in float32, and
   a seeded 40-keyframe IMU graph sharded through ``group=`` in float64,
   each twice: the same bits both times and on both ranks, within
   ``SOLVE_ATOL`` of the one-rank solve (the IMU graph's float32 gap is
   printed). A one-rank NCCL group runs the dense solve (equal to the
   solve without a group), and two ranks try a NCCL group on the one card
   (what NCCL does is printed, nothing depends on it). Per rank: ms per
   batch, ms per solve;
13. chunk: slam_loop's 80 scans (phase 6's first drive, drawn again from
   its generator state) through ``ChunkedMappingPipeline`` in blocks of 8:
   one K1 launch per block (10), and one per scan of a block that the
   odometry's gate sends back to the host ladder (the blocks replayed are
   printed); the keyframe and constraint counts of the per-scan run, the
   keyframe trajectory within 1e-3 m of it and the ATE under slam_loop's
   limit; ms per scan (a block's host time over its scans: mean,
   median). Then 16 of the scans with scan 11 dead (every point
   invalid): its block is replayed scan by scan through the host ladder
   (8 more K1 launches), and so is any block the clean run replayed;
14. host: ``HostLocalizer.localize`` (the reference's host-stepped loop
   control) on the card. The localize phase's 80 stored inputs over
   their GeometryMaps: status, iterations and pose equal to the stored
   ``localize_scan`` results bit for bit. The drive's 20 scans over its
   FeatureMaps with the faithful configuration, each prior the true pose
   moved by phase 3's noisy offsets: poses finite, statuses valid, none
   farther from the truth than its prior; never more search rounds than
   ``localize_scan`` on the same input, and where the rounds are equal
   the same status, iterations and pose (how many ran fewer is
   printed). K1's count is reset just before these 100 calls and read
   just after, and must equal 100. Then, in turns, ``localize_scan``
   twice and the host loop again on the same inputs; ms/scan of both
   drivers (host clock ending in ``synchronize()``: mean, median and
   each pass's median), and the synchronizing operations of one
   ``register`` of each kind through each driver as torch's sync debug
   mode counts them (beside what it counts for one scalar read as
   ``localize_scan``'s loop makes it and for one ``.tolist()``);
15. reference: the card against ``tests/data/torch_reference_
   fullwidth.npz``, the committed record of what the JAX package computes
   on the CPU at full width (``reference_cases.py`` reads it; nothing of
   JAX here): bench.py's scene and a street scene under
   ``launch.load_config("kitti_hdl64")`` (64 x 2304, compact extraction,
   GeometryMaps) and ``launch.load_config("vlp16")`` (16 x 1856, full
   extraction, FeatureMaps), five priors each, the maps built on the card
   from the record's clouds. K1's count is reset just before each case's
   ``localize_scan`` calls and read just after: one launch per scan. Its
   labels, curvature and features must equal the record's bit for bit
   (the port computes the reference's jitted float32 arithmetic, fused
   multiply-adds included, ROADMAP §C18). The registration fed the
   record's features (kitti_hdl64 in float32; vlp16 in float64, its
   float32 plane fit being ill-conditioned, ROADMAP §C8) must give the
   record's status and iterations and a pose within 1e-4 m and 1e-4 per
   quaternion component; ``localize_scan`` under kitti_hdl64 (and
   stopped after one iteration) likewise, and under vlp16 in float32
   (the kNN fits compute the reference's contracted float32 forms,
   ROADMAP §C19). Every difference and its margin to the bound is
   printed;
16. k1, after the main paths (localize, drive, odometry, slam, batch,
   kitti, determinism, batch_full, voxel_map, multi, chunk, host,
   reference): a ``torch.profiler``
   session leaves the host's kernel launches slower for the rest of the
   process, so no profiler runs before the host-bound loops. K1 against
   its plain PyTorch version on the card at 64 x 2304, on the bench scan
   and on the street scan, on the bench batches of 8 and 32 scans, and
   under vlp16 (16 x 1856, padding 5, 64 NMS rounds) on the reference
   phase's two scans: labels, curvature and compaction columns
   bit-equal. K1's device time
   per launch comes from ``torch.profiler`` over 200 launches after warm-up
   (no host work in it; the launches the profiler saw are printed beside
   it), its wrapper's host time per call from the host clock around 200
   calls with no synchronisation inside (the median of 5 such windows);
   both beside the least time the card could take (bytes over the
   H100's memory rate, operations over its float32 rate: the larger).
   The check and the timers are ``k1_check.py``'s, shared with
   ``profile_k1.py``. The plain version is timed with CUDA events around
   the call (median of 20 after warm-up). Then the drive's two last
   registrations once more under the profiler (``drive_profile``: kernel
   launches in all and per GN iteration, device busy time, profiled
   wall), ``slam_profile``: the odometry chain's last step, one
   registration of each SLAM run's last closing pair and one
   ``optimize()`` of each run's final graph, ``batch_profile``: one
   batch of each size on each scene (launches per GN iteration of the
   batch, device busy against profiled wall), ``batch_full_profile``:
   one batch of each size and case of phase 10, measured the same way,
   and ``host_profile``: one noisy street scan of phase 3 through
   ``HostLocalizer`` and through ``localize_scan`` (launches per GN
   iteration, device idle share), then the reference phase's vlp16
   street scan through ``HostLocalizer`` over FeatureMaps
   (``profile_fits.fit_calls``: the launches of one search round's fits,
   of one GN iteration on them, of one that refits, and of the whole
   registration). Last, ``fma_f32`` timed at 2^20 elements, at a row
   block's [8192, 3] and at the most common element count of phases 3
   and 4's tally (its line ``fma_f32_sizes``) (profiler device time with
   the operands read from memory, cycling through more operand sets than
   the L2 holds, and with one set in L2; host time of the wrapper, of
   ``xf.fma`` and of ``torch.addcmul``, the plain version's CUDA-event
   time, ``torch.addcmul``'s profiler device times by the same two
   methods and its CUDA-event time, the bytes bound);
   ``normal_equations`` at the drives' row counts (10,240 and 14,336)
   alone and as a batch of 32, and at 2,047 rows, on row-major operands
   as the main path's (profiler device time, also with j column-major,
   host time, the plain version's CUDA-event time and one
   ``torch.matmul`` of the stacked operands', the bytes bound and the
   order's chain floor, in the timing line only: its longest chain's
   dependent FMAs at an assumed 4 cycles each and the SM clock's
   maximum, computed, not measured); ``gn_update`` at B = 1 and 32 and
   ``robust_weights`` at 10,240 correspondences (alone, with the block
   medians, and as a batch of 32): profiler device time, host time, the
   plain version's CUDA-event time, the bytes bound and, in the timing
   line only, the chain floor (the longest chain of dependent float
   operations at the same assumed 4 cycles, computed, not measured; for
   gn_update each division and root at the dependent length of its SASS
   sequence, beside it the count with each one step and the count of a
   serial design); and
   the launch floor, the device
   time per launch of PyTorch's near-empty spin kernel
   (``torch.cuda._sleep(0)``; the profiler, as for the kernels).

Prints the card's name and power limit, one JSON line per phase, the
kernel summary line, and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside the
repository, it fails before printing any result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_SCANS = 20
K1_LAUNCHES = 200
K1_SOURCE = "lidar_feature_extraction_tpu_torch/csrc/extraction_k1.cu"
K1_REPLACES = "lidar_feature_extraction_tpu/ops/extraction_pallas.py:93"
FMA_SOURCE = "lidar_feature_extraction_tpu_torch/csrc/fma_f32.cu"
# fma_f32 ports no TPU kernel: it computes in one launch what the plain
# version computes in ~21, the float32 FMA XLA:CPU contracts.
FMA_REPLACES = ("none (the plain version, lidar_feature_extraction_tpu_"
                "torch/core/_xla_f32.py::_fma_plain)")
FMA_RANDOM = 1_000_000
FMA_LAUNCHES = 200
# The device kernel of torch.addcmul on CUDA float32 (part of its name, as
# the profiler reports it).
ADDCMUL_KERNEL = "addcmul_cuda_kernel"
# The profiler's name of every fma_f32 kernel (the streaming and the strided
# one) contains this.
FMA_KERNEL = "fma_f32_"
# fma_f32's timing cycles through this many bytes of operands, twice the
# H100's 50 MB L2, so that each launch reads its operands from memory.
ROTATE_BYTES = 100 << 20
NE_SOURCE = "lidar_feature_extraction_tpu_torch/csrc/normal_equations.cu"
# normal_equations ports no TPU kernel either: the reference leaves the
# normal equations to XLA (lidar_feature_extraction_tpu/ops/
# gauss_newton.py:158-160), and no library product fixes its order.
NE_REPLACES = ("none (XLA:CPU's dots in lidar_feature_extraction_tpu/ops/"
               "gauss_newton.py:158-160; the plain version lidar_feature_"
               "extraction_tpu_torch/core/_xla_dot.py::"
               "normal_equations_plain)")
# normal_equations' check: row counts (the gradient's loops under 4,096
# rows and its tiled loop from there, unsharded, 6 and 8 blocks, the
# drives', some not multiples of a block, and one whose sums are too
# many to fold from shared memory) and the trees compared.
NE_ROWS = (1, 7, 49, 50, 64, 65, 100, 352, 353, 385, 609, 1000, 2047, 4095,
           4096, 4099, 7990, 7991, 8197, 8198, 10240, 10243, 14336, 81920)
NE_TREE_ROWS = 16384
NE_LAUNCHES = 200
GU_SOURCE = "lidar_feature_extraction_tpu_torch/csrc/gn_update.cu"
RW_SOURCE = "lidar_feature_extraction_tpu_torch/csrc/robust_weights.cu"
# The Gauss-Newton step's two fused kernels port no TPU kernel either: each
# computes in one launch the float32 forms of the reference's jitted step
# that the plain version computes in hundreds of launches.
GU_REPLACES = ("none (XLA:CPU's fusions of lidar_feature_extraction_tpu/"
               "ops/gauss_newton.py:162-172 and :228-236; the plain version "
               "lidar_feature_extraction_tpu_torch/core/_xla_dot.py::"
               "gn_update_plain)")
RW_REPLACES = ("none (XLA:CPU's fusions of lidar_feature_extraction_tpu/"
               "ops/gauss_newton.py:207-227 and :295-300; the plain version "
               "lidar_feature_extraction_tpu_torch/core/stats.py::"
               "robust_weights_plain)")
# The kernels whose launches a Gauss-Newton iteration makes once each.
GN_KERNELS = ("normal_equations", "robust_weights", "gn_update")
# The fields of gn_kernels_timing's cases that the run measured.
GN_MEASURED = ("device_us", "device_launches_seen", "host_us", "plain_ms")
GN_LAUNCHES = 200
# The layouts of the check's operands: j column-major (read one float at a
# time), all row-major (16-byte copies), and all starting one float into
# their buffers (16-byte copies from a shifted start).
NE_LAYOUTS = ("strided", "contiguous", "offset")
# The launch floor: PyTorch's spin kernel for 0 cycles
# (torch.cuda._sleep(0)), timed as the others.
SPIN_KERNEL = "spin_kernel"
# Cycles assumed for one dependent float32 FMA, for the order's chain
# floor (computed, not measured; reported in the timing line only).
FMA_LATENCY_CYCLES = 4
# Scans of each drive held to the drive record (ROADMAP §C20, §C21).
# lu_solve ports no TPU kernel: the reference leaves the pose graph's
# dense solve to XLA:CPU, which calls LAPACK (OpenBLAS).
LU_SOURCE = "lidar_feature_extraction_tpu_torch/csrc/lu_solve.cu"
LU_REPLACES = ("none (jnp.linalg.solve of the pose graph, "
               "lidar_feature_extraction_tpu/parallel/pose_graph.py:193, "
               "which XLA:CPU hands to LAPACK's sgetrf and strsm)")
# lu_solve's check and timing: 6K at the keyframe buckets slam_loop solves
# (8, 16, 32, 64 keyframes: pipeline/slam.py's _bucket) and at 128 (the
# dense solver's most keyframes); the kernel line reports 384.
LU_SIZES = (48, 96, 192, 384, 768)
LU_KINDS = ("spd", "random", "ties", "singular")
LU_BATCHED = (48, 384)
LU_TIMED = 384
LU_LAUNCHES = 120
DRIVE_HELD_SCANS = {"production": 20, "faithful": 20}
# The drive's acceptance limits. ATE_EVAL.json's closed-loop ATE-RMSE of
# the reference (JAX on the CPU, eval_ate.py), the factor and margin a
# run on the card may reach, and docs/design.md §8's production/faithful
# rule. A miss fails the run.
DRIVE_SCANS = 20
ATE_REFERENCE_M = {"production": 0.0329, "faithful": 0.0375}
ATE_FACTOR, ATE_MARGIN_M = 1.25, 0.005
RATIO_LIMIT = 1.2
# The mapping workloads' limits. ODOMETRY_BENCH.json's mean step drift of
# the reference's extracted-features chain and ATE_EVAL.json's slam_loop
# / slam_loop_imu ATE-RMSE (JAX on the CPU), with the drive's factor and
# margin; the reference's keyframe count, with a slack of two.
ODOM_FRAMES = 100
ODOM_DRIFT_REFERENCE_M = 0.0076
SLAM_SCANS = 80
SLAM_ATE_REFERENCE_M = {"slam_loop": 0.0279, "slam_loop_imu": 0.0164}
SLAM_KEYFRAMES, SLAM_KEYFRAME_SLACK = 40, 2
# The batched localizer: batch sizes, timed batches per size (after one
# untimed), the pose tolerance of a lane against its lone run, and the
# relative error or scale change of a Gauss-Newton abort test within
# which float32 rounding may decide it either way (ROADMAP §C11); at most
# one such lane per 32 may end otherwise than its lone run.
BATCH_SIZES = (1, 8, 32)
BATCH_REPS = 5
# The batched full-extraction branches: batch sizes (lane b is drive
# scan b, so at most DRIVE_SCANS).
BATCH_FULL_SIZES = (1, 8)
BATCH_T_ATOL = BATCH_Q_ATOL = 1e-4
TIE_MARGIN = 1e-5
# The KITTI replay's limit: the JAX package's run_kitti_localization ATE
# on the same written files (the drive's 20 scans, no twists; computed on
# the CPU by `PYTHONPATH=. python tests/test_torch_entry.py`), with the
# drive's factor and margin.
KITTI_ATE_REFERENCE_M = 4.77979214851624
# The multi phase: gloo ranks on the one card and the global batch (the
# bench scene's lanes, split evenly); the largest position or quaternion
# difference of a sharded graph solve from the one-rank solve: the pose
# graphs in float32 at tests/test_parallel.py's own tolerance for a
# sharded float32 solve, the IMU graph in float64 (its float32 gap is
# printed, not held: see multi_rank); how long the ranks may take before
# they are killed.
MULTI_RANKS, MULTI_BATCH = 2, 8
SOLVE_ATOL = {"dense": 1e-3, "cg": 1e-3, "imu": 1e-6}
MULTI_TIMEOUT_S, PROBE_TIMEOUT_S = 480.0, 90.0
# The chunk phase: scans per block; the keyframe trajectory's tolerance
# against the per-scan slam_loop run (tests/test_mapping_chunk.py's);
# the suspect-block run: its scans and the dead one (in the second block).
CHUNK_BLOCK = 8
CHUNK_TRAJ_ATOL_M = 1e-3
CHUNK_SUSPECT_SCANS, CHUNK_DEAD = 16, 11


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bench_scene(cfg, device):
    """bench.py's scene: the scan as a RangeImage and the map's clouds."""
    import torch
    from k1_check import bench_xyz
    from lidar_feature_extraction_tpu_torch.interop import (
        range_image_from_numpy)
    from lidar_feature_extraction_tpu_torch.ops.extraction import (
        extract_features)
    from lidar_feature_extraction_tpu_torch.utils.synthetic import (
        keyframe_copies)

    ex = cfg.extraction
    R, P = ex.n_rings, ex.max_points_per_ring
    xyz, rng = bench_xyz(R, P)
    img = range_image_from_numpy(xyz, np.ones((R, P), bool),
                                 np.full(R, P, np.int32), device)
    f = extract_features(img, ex)
    e = f.edge_xyz[f.edge_valid].cpu().numpy()
    s = f.surface_xyz[f.surface_valid].cpu().numpy()
    edge = torch.as_tensor(keyframe_copies(rng, e), dtype=torch.float32,
                           device=device)
    surf = torch.as_tensor(keyframe_copies(rng, s), dtype=torch.float32,
                           device=device)
    return img, edge, surf


def street_scene(cfg, device):
    """Street canyon: scan at the identity and the map's clouds from 7
    keyframes (keyframe 0 is the scan's own pose)."""
    import torch
    from k1_check import street_keyframes
    from lidar_feature_extraction_tpu_torch.interop import (
        range_image_from_numpy)
    from lidar_feature_extraction_tpu_torch.ops.extraction import (
        extract_features)
    from lidar_feature_extraction_tpu_torch.utils.synthetic import to_world

    ex = cfg.extraction
    R, P = ex.n_rings, ex.max_points_per_ring
    mask, count = np.ones((R, P), bool), np.full(R, P, np.int32)
    edges, surfs, scan0 = [], [], None
    for xyz, o, yaw in street_keyframes(R, P):
        img = range_image_from_numpy(xyz, mask, count, device)
        scan0 = img if scan0 is None else scan0
        f = extract_features(img, ex)
        edges.append(to_world(f.edge_xyz[f.edge_valid].cpu().numpy(), o, yaw))
        surfs.append(to_world(f.surface_xyz[f.surface_valid].cpu().numpy(),
                              o, yaw))
    as_t = lambda a: torch.as_tensor(np.concatenate(a), dtype=torch.float32,  # noqa: E731
                                     device=device)
    return scan0, as_t(edges), as_t(surfs)


def build_maps(edge, surf, cfg):
    import torch
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        build_geometry_maps)

    ones = lambda a: torch.ones(len(a), dtype=torch.bool, device=a.device)  # noqa: E731
    return build_geometry_maps(edge, ones(edge), surf, ones(surf), cfg)


def priors(noisy: bool, n: int):
    """Per-scan prior errors (dq wxyz, dt) on top of the best-case prior,
    drawn with numpy: none, or 0.2 m in a random direction and a yaw of
    N(0, 1 degree)."""
    out = []
    rng = np.random.default_rng(7)
    for _ in range(n):
        if not noisy:
            out.append((np.array([1.0, 0, 0, 0]), np.zeros(3)))
            continue
        d = rng.normal(size=3)
        yaw = np.radians(1.0) * rng.normal()
        out.append((np.array([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)]),
                    0.2 * d / np.linalg.norm(d)))
    return out


def localize_chain(maps, image, cfg, noisy: bool, n: int):
    """``n`` chained localize_scan calls: each scan is the image shifted
    by 1e-3 of the previous estimate (a fresh tensor), each prior the
    best-case prior moved by the same amount plus its prior error.
    Returns per-scan (inputs, result, ms)."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import quaternion as quat
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        localize_scan)

    dev = image.xyz.device
    q0 = torch.tensor([1.0, 0, 0, 0], device=dev)
    t0 = torch.tensor([0.3, -0.2, 0.05], device=dev)
    t_prev = t0.clone()
    runs = []
    for dq, dt in priors(noisy, n):
        im = image._replace(xyz=image.xyz + 1e-3 * t_prev)
        prior = Pose(quat.quat_multiply(q0, torch.as_tensor(
            dq, dtype=torch.float32, device=dev)),
            t0 + 1e-3 * t_prev + torch.as_tensor(dt, dtype=torch.float32,
                                                 device=dev))
        torch.cuda.synchronize()
        start = time.perf_counter()
        result, _ = localize_scan(maps, im, prior, cfg)
        torch.cuda.synchronize()
        runs.append(((im, prior), result,
                     1e3 * (time.perf_counter() - start)))
        t_prev = result.pose.t
    return runs


def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: kernel launches (the
    runtime's launch calls), device busy time (the profiler's self device
    time total) and the wall time of the profiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from k1_check import _self_device_us

    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    events = prof.key_averages()
    return out, {"launches": sum(e.count for e in events
                                 if e.key in launch_calls),
                 "device_busy_ms": sum(_self_device_us(e)
                                       for e in events) / 1e3,
                 "profiled_wall_ms": 1e3 * wall}


def drive_run(maps, cfg, scans, twists, gt, device, k1, fma):
    """The closed loop over the drive on ``device``
    (``reference_cases.port_drive``, timed per scan), K1's, fma_f32's
    and ``GN_KERNELS``' counts read over exactly this run; then the last scan's
    localize_scan alone, again from the previous scan's fused pose.
    Returns the run's metrics, (maps, image, prior, cfg) of that last
    registration, and every scan's measured and fused pose ([scans, 14]
    float32: q, t, q, t)."""
    import torch
    import reference_cases as rc
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        localize_scan)
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.utils.evaluation import (
        ate_rmse, relative_translation_errors)

    ms = []
    torch.cuda.synchronize()
    k1.label_and_columns_cuda.launches = 0
    fma.fma_f32_cuda.launches = 0
    fma.fma_f32_cuda.sizes = {}
    gn_counts(reset=True)
    fields = rc.port_drive(maps, cfg, scans, twists, device, ms=ms)
    launches = k1.label_and_columns_cuda.launches
    fma_launches = fma.fma_f32_cuda.launches
    fma_sizes, fma.fma_f32_cuda.sizes = fma.fma_f32_cuda.sizes, None
    gn_launches = gn_counts()

    est = fields["measured_t"]
    poses = np.concatenate([fields[k] for k in (
        "measured_q", "measured_t", "fused_q", "fused_t")], axis=1)
    status = fields["status"].tolist()
    iters = fields["iterations"].tolist()

    image = scan_range_image(*scans[-1], cfg, device)
    prior = Pose(*(torch.as_tensor(fields[k][-2], device=device)
                   for k in ("fused_q", "fused_t")))
    start = time.perf_counter()
    res, _ = localize_scan(maps, image, prior, cfg)
    torch.cuda.synchronize()
    last_ms = 1e3 * (time.perf_counter() - start)
    return {
        "scans": len(scans), "k1_launches": launches,
        "fma_launches": fma_launches, "fma_sizes": fma_size_tally(fma_sizes),
        "fma_sizes_raw": fma_sizes, "gn_launches": gn_launches,
        "finite": bool(np.isfinite(poses).all()),
        "ate_rmse_m": ate_rmse(est, gt, align=False),
        "ate_xy_rmse_m": ate_rmse(np.pad(est[:, :2], ((0, 0), (0, 1))),
                                  np.pad(gt[:, :2], ((0, 0), (0, 1))),
                                  align=False),
        "mean_step_drift_m": float(np.mean(relative_translation_errors(
            est, gt))),
        "ms_per_scan_mean": statistics.fmean(ms),
        "ms_per_scan_median": statistics.median(ms),
        "ms_first_scan": ms[0], "ms_per_scan": ms,
        "gn_iterations_mean": statistics.fmean(iters), "gn_iterations": iters,
        "gn_status": status,
        "status_counts": {str(s): status.count(s) for s in sorted(
            set(status))},
        "last_scan_localize_ms": last_ms,
        "last_scan_gn_iterations": int(res.iterations),
    }, (maps, image, prior, cfg), poses


def drive_profile(maps, image, prior, cfg) -> dict:
    """One localize_scan under the profiler: kernel launches (in all and
    per GN iteration), device busy time and the profiled wall time."""
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        localize_scan)

    (res, _), prof = profile_call(
        lambda: localize_scan(maps, image, prior, cfg))
    prof["gn_iterations"] = int(res.iterations)
    prof["launches_per_gn_iteration"] = prof["launches"] / max(
        int(res.iterations), 1)
    return prof


def odometry_frames(cfg, device):
    """bench_odometry.py's extracted-features frames, made by the port:
    seed 0, 50 poles over 60 m, ``straight_drive``, ray-cast 64 x 2048
    sweeps through the range image and ``extract_features`` (K1) on the
    card. Returns the frames and the ground-truth positions."""
    from lidar_feature_extraction_tpu_torch.ops.extraction import (
        extract_features)
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.utils import worldsim

    rng = np.random.default_rng(0)
    world = worldsim.make_world(rng, n_poles=50, extent=60.0)
    frames, gt = [], []
    for i in range(ODOM_FRAMES):
        pose = worldsim.straight_drive(i)
        gt.append(pose.t.numpy())
        pts, ring = worldsim.raycast_scan(world, pose, rng, n_rings=64,
                                          n_az=2048, elev_deg=(2.0, -24.8))
        f = extract_features(scan_range_image(pts, ring, cfg, device),
                             cfg.extraction)
        frames.append((f.edge_xyz, f.edge_valid, f.surface_xyz,
                       f.surface_valid))
    return frames, np.stack(gt)


def odometry_chain(frames, gt, cfg, device):
    """``geometry_odometry_step`` over the frames with the
    constant-velocity prior carried as in bench_odometry.py's
    ``bench_mode``; each step timed on the host clock ending in
    ``synchronize()``. Returns the metrics and the last step's
    arguments."""
    import torch
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.pipeline.odometry import (
        chained_prior, geometry_odometry_step, init_geometry_odometry)
    import reference_cases as rc

    state = init_geometry_odometry(cfg, device=device)
    prev = Pose(state.pose_q, state.pose_t)
    results, ms = [], []
    for frame in frames:
        cur = Pose(state.pose_q, state.pose_t)
        prior = chained_prior(cur, prev)
        last = (state, frame, prior)
        torch.cuda.synchronize()
        start = time.perf_counter()
        state, result = geometry_odometry_step(
            state, *frame, cfg, prior_q=prior.q, prior_t=prior.t)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - start))
        results.append(result)
        prev = cur
    fields = {k: torch.stack([get(r) for r in results]).cpu().numpy()
              for k, get in (("status", lambda r: r.status),
                             ("iterations", lambda r: r.iterations),
                             ("pose_q", lambda r: r.pose.q),
                             ("pose_t", lambda r: r.pose.t))}
    est = fields["pose_t"]
    return {
        "frames": len(frames), "finite": bool(np.isfinite(est).all()),
        "ms_per_scan_mean": statistics.fmean(ms),
        "ms_per_scan_median": statistics.median(ms),
        "ms_first_scan": ms[0],
        "gn_iterations_per_scan": float(np.mean(fields["iterations"][1:])),
        # Frame 0 starts the window at the origin; drift over the rest.
        **rc.odometry_metrics(est, gt),
    }, last, fields


def slam_run(cfg, world, rng, with_imu: bool, device, k1, fma,
             recorder=None):
    """eval_ate.py's ``eval_slam_loop`` on the card: the port's
    ``run_mapping_drive`` over 80 scans of a 10 m circle, drawing from
    ``rng``, with the pipeline's ``process_scan``, ``optimize`` and
    loop-closure registrations timed (host clock ending in
    ``synchronize()``) and, given a ``reference_cases.MappingRecorder``,
    recorded. Returns the metrics, the pipeline and the last (keyframe,
    target) pair that closed."""
    import torch
    from lidar_feature_extraction_tpu_torch.pipeline import slam
    from lidar_feature_extraction_tpu_torch.utils import worldsim
    from lidar_feature_extraction_tpu_torch.utils.evaluation import ate_rmse

    times = {"scan": [], "optimize": [], "loop": []}
    closed = []

    def timed(key, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[key].append(1e3 * (time.perf_counter() - start))
        return out

    class TimedPipeline(slam.MappingPipeline):
        def process_scan(self, *args, **kwargs):
            return timed("scan", lambda: super(TimedPipeline, self)
                         .process_scan(*args, **kwargs))

        def optimize(self, *args, **kwargs):
            return timed("optimize", lambda: super(TimedPipeline, self)
                         .optimize(*args, **kwargs))

        def _register_to_keyframe(self, kf, target):
            match = timed("loop", lambda: super(TimedPipeline, self)
                          ._register_to_keyframe(kf, target))
            if match is not None:
                closed.append((kf, target))
            return match

    start = time.perf_counter()
    k1.label_and_columns_cuda.launches = 0
    fma.fma_f32_cuda.launches = 0
    plain = slam.MappingPipeline
    slam.MappingPipeline = TimedPipeline if recorder is None \
        else recorder.recording(TimedPipeline)
    try:
        pipeline, gt = worldsim.run_mapping_drive(
            world, cfg, rng, n_scans=SLAM_SCANS, radius=10.0,
            scan_period=0.1, with_imu=with_imu,
            pipeline_kwargs=dict(loop_radius=6.0, loop_min_gap=10,
                                 optimize_every=8),
            device=device, n_rings=64, n_az=2048, elev_deg=(2.0, -24.8))
    finally:
        slam.MappingPipeline = plain
    torch.cuda.synchronize()
    launches = k1.label_and_columns_cuda.launches
    fma_launches = fma.fma_f32_cuda.launches
    wall = time.perf_counter() - start
    est = pipeline.trajectory
    n_kf = len(pipeline.keyframes)
    bias = (None if pipeline.imu_bias is None
            else [float(b) for b in pipeline.imu_bias[0]])
    return {
        "scans": SLAM_SCANS, "k1_launches": launches,
        "fma_launches": fma_launches, "ate_rmse_m": ate_rmse(est, gt, align=False),
        "keyframes": n_kf,
        "loop_constraints": len(pipeline.constraints) - (n_kf - 1),
        "finite": bool(np.isfinite(est).all()) and (
            bias is None or bool(np.isfinite(bias).all())),
        "gyro_bias": bias,
        "ms_per_scan_mean": statistics.fmean(times["scan"]),
        "ms_per_scan_median": statistics.median(times["scan"]),
        "ms_per_scan_max": max(times["scan"]),
        "optimize_calls": len(times["optimize"]),
        "optimize_ms_total": sum(times["optimize"]),
        "optimize_ms": times["optimize"],
        "loop_attempts": len(times["loop"]),
        "loop_accepted": len(closed),
        "loop_ms_total": sum(times["loop"]), "loop_ms": times["loop"],
        "wall_s": wall,
    }, pipeline, (closed[-1] if closed else None)


def gn_iterations_of(fn):
    """``fn()`` and the Gauss-Newton iterations its registrations ran (a
    lock-step batch runs as many as its slowest lane)."""
    from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn

    results, runs = [], (gn.run_gauss_newton, gn.run_gauss_newton_batched)

    def counting(run):
        def counted(*args, **kwargs):
            results.append(run(*args, **kwargs))
            return results[-1]
        return counted

    gn.run_gauss_newton, gn.run_gauss_newton_batched = map(counting, runs)
    try:
        out = fn()
    finally:
        gn.run_gauss_newton, gn.run_gauss_newton_batched = runs
    return out, sum(int(r.iterations.max()) for r in results)


def slam_profile(odometry_last, slam_runs, cfg) -> list:
    """Under the profiler: the odometry chain's last step, and per SLAM
    run one registration of its last pair that closed and one
    ``optimize()`` of its final graph (10 graph iterations)."""
    from lidar_feature_extraction_tpu_torch.pipeline.odometry import (
        geometry_odometry_step)

    state, frame, prior = odometry_last
    out = []
    (_, res), prof = profile_call(lambda: geometry_odometry_step(
        state, *frame, cfg, prior_q=prior.q, prior_t=prior.t))
    prof["gn_iterations"] = int(res.iterations)
    out.append(dict(step="geometry_odometry_step", **prof))
    for name, (pipeline, pair) in slam_runs.items():
        if pair is not None:
            (_, its), prof = profile_call(lambda: gn_iterations_of(
                lambda: pipeline._register_to_keyframe(*pair)))
            prof["gn_iterations"] = its
            out.append(dict(step="_register_to_keyframe", run=name, **prof))
        _, prof = profile_call(pipeline.optimize)
        prof["gn_iterations"] = 10
        out.append(dict(step="optimize", run=name,
                        keyframes=len(pipeline.keyframes), **prof))
    for prof in out:
        prof["launches_per_gn_iteration"] = prof["launches"] / max(
            prof["gn_iterations"], 1)
    return out


def batch_lanes(image, n: int):
    """``n`` lanes on a scene: lane b's image is the scene's moved by
    1e-3 * b m (a fresh tensor), its prior the best-case prior with the
    b-th of ``priors(noisy=True, n)``'s errors, so the lanes stop at
    different iterations. Returns the images and the priors (Pose
    each)."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import quaternion as quat
    from lidar_feature_extraction_tpu_torch.core.pose import Pose

    dev = image.xyz.device
    q0 = torch.tensor([1.0, 0, 0, 0], device=dev)
    t0 = torch.tensor([0.3, -0.2, 0.05], device=dev)
    step = torch.tensor([1.0, -0.5, 0.2], device=dev)
    images, poses = [], []
    for b, (dq, dt) in enumerate(priors(True, n)):
        images.append(image._replace(xyz=image.xyz + 1e-3 * b * step))
        poses.append(Pose(quat.quat_multiply(q0, torch.as_tensor(
            dq, dtype=torch.float32, device=dev)),
            t0 + torch.as_tensor(dt, dtype=torch.float32, device=dev)))
    return images, poses


def abort_margins(fn):
    """``fn()`` with every Gauss-Newton body's abort tests recorded.
    Returns fn's output and, over the bodies, the smallest |relative
    change| of the error and of the MAD scale against the carried ones
    (what the ERROR_ / SCALE_INCREASED aborts compare)."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import stats
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn

    body, seen = gn._gn_body, []

    def traced(problem_fn, state, *args):
        p = problem_fn(Pose(state.q, state.t))
        err = torch.sum(torch.where(p.valid, p.errors, 0.0), dim=-1)
        scale = stats.masked_scale_bisect(p.errors, p.valid)
        seen.append([float((err - state.prev_error) / state.prev_error),
                     float((scale - state.prev_scale) / state.prev_scale)])
        return body(problem_fn, state, *args)

    gn._gn_body = traced
    try:
        out = fn()
    finally:
        gn._gn_body = body
    margins = np.abs(np.asarray(seen))
    return out, {"error": float(margins[:, 0].min()),
                 "scale": float(margins[:, 1].min())}


def batch_check(maps, cfg, images, poses, result, lone, k1):
    """A batch's lanes against their lone ``localize_scan`` runs
    (``lone``: per lane (status, iterations, q, t)), and its one K1
    launch on the [B * R, P] planes against B single launches and the
    plain version. Returns the lanes that ended otherwise than alone,
    each with the abort margins of its lone run (a rounding tie when both
    are below TIE_MARGIN)."""
    import torch
    from k1_check import k1_args
    from lidar_feature_extraction_tpu_torch.core.scan import (
        stack_range_images)
    from lidar_feature_extraction_tpu_torch.ops import extraction as tex
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        localize_scan)

    B = len(images)
    stacked = stack_range_images(images)
    args = k1_args(stacked.xyz.flatten(0, 1), stacked.count.flatten(), cfg)
    got = k1.label_and_columns_cuda(*args)
    singles = [k1.label_and_columns_cuda(*k1_args(im.xyz, im.count, cfg))
               for im in images]
    plain = tex.label_and_columns_plain(*args)
    for n, name in enumerate(("labels", "curvature", "col")):
        check(torch.equal(got[n], torch.cat([s[n] for s in singles])),
              f"batch {B}: K1 {name} on the batch differs from {B} single "
              f"launches")
        check(torch.equal(got[n], plain[n]),
              f"batch {B}: K1 {name} on the batch differs from the plain "
              f"version")
    status = result.status.tolist()
    iters = result.iterations.tolist()
    q, t = result.pose.q.cpu(), result.pose.t.cpu()
    differ = []
    for b in range(B):
        ls, li, lq, lt = lone[b]
        dq = float((q[b] - lq).abs().max())
        dt = float((t[b] - lt).abs().max())
        if status[b] == ls and iters[b] == li and dq <= BATCH_Q_ATOL \
                and dt <= BATCH_T_ATOL:
            continue
        _, margins = abort_margins(lambda: localize_scan(
            maps, images[b], poses[b], cfg))
        # A lane that ends as its lone run does but elsewhere is no tie.
        differ.append({"lane": b, "status": status[b], "iterations": iters[b],
                       "lone_status": ls, "lone_iterations": li,
                       "pose_dt_m": dt, "pose_dq": dq, "margins": margins,
                       "tie": (status[b], iters[b]) != (ls, li)
                       and min(margins.values()) < TIE_MARGIN})
    return differ


def batch_phase(scenes, cfg, dev, k1) -> tuple[dict, list]:
    """The batched localizer through ``make_batched_localizer`` at
    B = 1, 8, 32 on both scenes: every lane held to its lone run, the
    batch's K1 launch to single launches and the plain version, then
    ``BATCH_REPS`` timed batches (host clock ending in synchronize())
    after an untimed one, K1's launches counted over exactly those
    calls. Returns the launches and what the profiler is to run later."""
    import torch
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.core.scan import (
        stack_range_images)
    from lidar_feature_extraction_tpu_torch.parallel.distributed import (
        make_batched_localizer)
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        localize_scan)

    run = make_batched_localizer(cfg)
    n_max = max(BATCH_SIZES)
    launches, later = 0, []
    for scene, (maps, image) in scenes.items():
        images, poses = batch_lanes(image, n_max)
        lone = []
        for im, pose in zip(images, poses):
            r, _ = localize_scan(maps, im, pose, cfg)
            lone.append((int(r.status), int(r.iterations), r.pose.q.cpu(),
                         r.pose.t.cpu()))
        for B in BATCH_SIZES:
            stacked = stack_range_images(images[:B])
            prior = Pose(torch.stack([p.q for p in poses[:B]]),
                         torch.stack([p.t for p in poses[:B]]))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k1.label_and_columns_cuda.launches = 0
            ms = []
            for _ in range(1 + BATCH_REPS):
                start = time.perf_counter()
                result, feats = run(maps, stacked, prior)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - start))
            count = k1.label_and_columns_cuda.launches
            peak = torch.cuda.max_memory_allocated()
            check(count == 1 + BATCH_REPS,
                  f"batch {scene} {B}: K1 launched {count} times for "
                  f"{1 + BATCH_REPS} batches")
            launches += count
            check(bool(torch.isfinite(result.pose.t).all())
                  and bool(torch.isfinite(result.pose.q).all()),
                  f"batch {scene} {B}: non-finite pose")
            check(feats.edge_xyz.shape[0] == B,
                  f"batch {scene} {B}: features of {feats.edge_xyz.shape[0]}"
                  f" scans")
            differ = batch_check(maps, cfg, images[:B], poses[:B], result,
                                 lone, k1)
            k1.label_and_columns_cuda.launches = 0
            iters = result.iterations.tolist()
            med = statistics.median(ms[1:])
            emit("batch", scene=scene, batch=B, scans_per_s=1e3 * B / med,
                 ms_per_batch=med, ms_per_scan=med / B, ms_batches=ms[1:],
                 ms_first_batch=ms[0], gn_iterations_max=max(iters),
                 gn_iterations_mean=statistics.fmean(iters),
                 distinct_iteration_counts=len(set(iters)),
                 k1_launches_per_batch=count / (1 + BATCH_REPS),
                 max_memory_allocated=peak,
                 lanes_equal_to_lone_runs=B - len(differ),
                 lanes_otherwise=differ)
            check(all(d["tie"] for d in differ),
                  f"batch {scene} {B}: lanes {differ} differ from their lone "
                  f"runs beyond a rounding tie")
            check(len(differ) <= max(1, B // 32),
                  f"batch {scene} {B}: {len(differ)} tie lanes")
            if B > 1:
                check(len(set(iters)) > 1,
                      f"batch {scene} {B}: every lane ran {iters[0]} "
                      f"iterations; the freeze is not exercised")
            later.append((scene, B, max(iters),
                          lambda r=run, m=maps, s=stacked, p=prior: r(m, s, p)))
    return launches, later


def write_kitti_drive(root: str, edges, surfs, scans) -> tuple:
    """The drive as a KITTI sequence: its scans as ``.bin`` files (points
    in the sensor frame, intensity 0) in ``root/sequence``, the map
    clouds as ``root/edge.pcd`` and ``root/surface.pcd``. Returns the
    three paths."""
    from lidar_feature_extraction_tpu_torch.io import kitti
    from lidar_feature_extraction_tpu_torch.io.pcd import save_pcd

    seq = os.path.join(root, "sequence")
    os.makedirs(seq, exist_ok=True)
    for i, (pts, _ring) in enumerate(scans):
        kitti.write_velodyne_bin(os.path.join(seq, f"{i:06d}.bin"), pts)
    edge, surf = os.path.join(root, "edge.pcd"), os.path.join(root,
                                                               "surface.pcd")
    save_pcd(edge, edges)
    save_pcd(surf, surfs)
    return seq, edge, surf


def kitti_run(edges, surfs, scans, gt, k1) -> dict:
    """The entry point end to end: the drive written as a KITTI sequence,
    ``launch.load_config("kitti_hdl64")``, ``launch.load_maps`` and
    ``run_kitti_localization`` on the card; the fused positions' ATE
    against the drive's truth, K1 counted over the replay."""
    import tempfile

    import torch
    from lidar_feature_extraction_tpu_torch.pipeline import launch
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        run_kitti_localization)
    from lidar_feature_extraction_tpu_torch.utils.evaluation import ate_rmse

    with tempfile.TemporaryDirectory() as root:
        seq, edge, surf = write_kitti_drive(root, edges, surfs, scans)
        prefetched = prefetch_equal(seq)
        cfg = launch.load_config("kitti_hdl64")
        start = time.perf_counter()
        maps = launch.load_maps(edge, surf, cfg)
        torch.cuda.synchronize()
        maps_s = time.perf_counter() - start
        k1.label_and_columns_cuda.launches = 0
        start = time.perf_counter()
        fused = run_kitti_localization(seq, maps, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = k1.label_and_columns_cuda.launches
    return {"scans": len(fused), "k1_launches": launches,
            "prefetched_scans_equal": prefetched,
            "finite": bool(np.isfinite(fused).all()),
            "ate_rmse_m": ate_rmse(fused, gt, align=False),
            "load_maps_s": maps_s, "replay_s": wall,
            "ms_per_scan": 1e3 * wall / len(fused)}


def prefetch_equal(seq: str) -> int:
    """Read a sequence's ``.bin`` files once through ``ScanPrefetcher``
    and once through ``io/kitti.read_velodyne_bin``; returns how many of
    them came back the same (float32 contents bit for bit)."""
    from lidar_feature_extraction_tpu_torch.io import kitti
    from lidar_feature_extraction_tpu_torch.io.native_io import (
        ScanPrefetcher)

    paths = kitti.scan_files(seq)
    prefetcher = ScanPrefetcher(paths)
    try:
        return sum(np.array_equal(prefetcher.get(i).reshape(-1, 4),
                                  kitti.read_velodyne_bin(p))
                   for i, p in enumerate(paths))
    finally:
        prefetcher.close()


def seeded_graph(device, k: int = 40, seed: int = 3):
    """A pose graph of ``k`` keyframes around a circle with chain and
    loop constraints, drawn with numpy (the SLAM drives' size)."""
    import torch
    from lidar_feature_extraction_tpu_torch.parallel.pose_graph import (
        Constraints, PoseGraph)

    rng = np.random.default_rng(seed)
    yaw = np.linspace(0, 2 * np.pi, k, endpoint=False)
    q = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], -1)
    t = np.stack([10 * np.cos(yaw), 10 * np.sin(yaw), 0 * yaw], -1)
    i = np.concatenate([np.arange(k - 1), np.arange(0, k - 10, 4)])
    j = np.concatenate([np.arange(1, k), np.arange(10, k, 4)])
    dyaw = yaw[j] - yaw[i] + 0.01 * rng.normal(size=len(i))
    z_q = np.stack([np.cos(dyaw / 2), 0 * dyaw, 0 * dyaw, np.sin(dyaw / 2)],
                   -1)
    z_t = rng.normal(scale=0.5, size=(len(i), 3))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    noisy = t + rng.normal(scale=0.1, size=t.shape)
    return (PoseGraph(f32(q), f32(noisy)),
            Constraints(torch.as_tensor(i, dtype=torch.int32, device=device),
                        torch.as_tensor(j, dtype=torch.int32, device=device),
                        f32(z_q), f32(z_t), f32(np.ones(len(i)))))


def scatter_sites_twice(args, maps, cfg, feats) -> dict:
    """Every float scatter-add of the port (ROADMAP §C16) called twice
    on the card on this run's inputs: for each, whether the two results
    have the same bits. ``args`` are the drive's map clouds and masks,
    ``maps`` its GeometryMaps, ``feats`` a full extraction of a batch of
    drive scans."""
    import torch
    from lidar_feature_extraction_tpu_torch.ops import geometry_grid as gg
    from lidar_feature_extraction_tpu_torch.ops.downsample import (
        voxel_downsample, voxel_downsample_dense)
    from lidar_feature_extraction_tpu_torch.parallel import pose_graph as pg

    reg = cfg.registration
    edge, emask, surf, smask = args
    leaf, cap = reg.surface_downsample_leaf, reg.max_surface_points
    graph, cons = seeded_graph(edge.device)
    k = graph.poses_q.shape[0]
    calls = {
        "voxel_moments_edge": lambda: gg.voxel_moments(
            edge, emask, maps.edge.voxel_size, maps.edge.origin,
            maps.edge.dims),
        "voxel_moments_surface": lambda: gg.voxel_moments(
            surf, smask, maps.surface.voxel_size, maps.surface.origin,
            maps.surface.dims),
        "voxel_downsample": lambda: voxel_downsample(
            feats.surface_xyz[0], feats.surface_valid[0], leaf, cap)[0],
        "voxel_downsample_batch": lambda: voxel_downsample(
            feats.surface_xyz, feats.surface_valid, leaf, cap)[0],
        "voxel_downsample_dense": lambda: voxel_downsample_dense(
            feats.surface_xyz[0], feats.surface_valid[0], leaf, cap,
            reg.odometry_grid_dims)[0],
        "scatter_normal_equations": lambda: torch.cat([
            a.reshape(-1) for a in pg._local_normal_equations(graph, cons,
                                                              k)]),
        "pose_graph_cg_rows": lambda: pg.optimize_pose_graph_cg(
            graph, cons, n_iterations=2, n_cg=10).poses_t,
    }
    return {name: bool(torch.equal(fn(), fn())) for name, fn in calls.items()}


def batch_full_lanes(scans, cfg, n: int, device):
    """``n`` lanes of the drive: lane b is drive scan b's range image,
    its prior the scan's true pose (``worldsim.straight_drive(b)``) moved
    by 0.1, 0.3, 0.6 or 0.9 m (cycling) in a random horizontal direction,
    with a yaw error of N(0, 1 degree), drawn with numpy. The larger
    errors carry a lane past the kNN path's candidate refresh distance
    (0.5 m) in its first search round, the smaller ones do not."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import quaternion as quat
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.utils import worldsim

    rng = np.random.default_rng(11)
    images, poses = [], []
    for b in range(n):
        images.append(scan_range_image(*scans[b], cfg, device))
        truth = worldsim.straight_drive(b)
        d = rng.normal(size=3) * np.array([1.0, 1.0, 0.0])
        yaw = np.radians(1.0) * rng.normal()
        dq = torch.tensor([np.cos(yaw / 2), 0, 0, np.sin(yaw / 2)],
                          dtype=torch.float32)
        dt = (0.1, 0.3, 0.6, 0.9)[b % 4] * d / np.linalg.norm(d)
        poses.append(Pose(quat.quat_multiply(truth.q.float(), dq).to(device),
                          (truth.t.float() + torch.as_tensor(
                              dt, dtype=torch.float32)).to(device)))
    return images, poses


def batch_full_phase(cases, scans, dev, k1) -> tuple[int, list]:
    """The batched full-extraction branches through
    ``make_batched_localizer`` at the ``BATCH_FULL_SIZES`` on the drive's
    lanes: ``cases`` maps a name to (maps, config). Every lane held to
    its lone ``localize_scan`` on the card (status, iterations exactly,
    pose within 1e-4), one K1 launch per batch, the lanes stopping at
    different iterations; the kNN case's lanes deciding their search
    rounds apart (one runs the second round, one does not). Timed with
    ``utils.profiling.StageTimer``: ``BATCH_REPS`` batches after an
    untimed one. Returns K1's launches and what the profiler is to run
    later."""
    import torch
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.core.scan import (
        stack_range_images)
    from lidar_feature_extraction_tpu_torch.parallel.distributed import (
        make_batched_localizer)
    from lidar_feature_extraction_tpu_torch.pipeline import localization
    from lidar_feature_extraction_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    launches, later = 0, []
    for case, (maps, c) in cases.items():
        run = make_batched_localizer(c)
        images, poses = batch_full_lanes(scans, c, max(BATCH_FULL_SIZES), dev)
        lone = []
        for im, pose in zip(images, poses):
            r, _ = localization.localize_scan(maps, im, pose, c)
            lone.append((int(r.status), int(r.iterations), r.pose.q.cpu(),
                         r.pose.t.cpu()))
        for B in BATCH_FULL_SIZES:
            stacked = stack_range_images(images[:B])
            prior = Pose(torch.stack([p.q for p in poses[:B]]),
                         torch.stack([p.t for p in poses[:B]]))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k1.label_and_columns_cuda.launches = 0
            # The untimed batch records each round's per-lane decision.
            reruns, select = [], localization._select_scans

            def recording(take, new, old):
                reruns.append(take.tolist())
                return select(take, new, old)

            localization._select_scans = recording
            try:
                result, feats = run(maps, stacked, prior)
            finally:
                localization._select_scans = select
            key = f"{case} {B}"
            for _ in range(BATCH_REPS):
                out = []
                with timer.stage(key, block_on=out):
                    out.append(run(maps, stacked, prior))
            torch.cuda.synchronize()
            count = k1.label_and_columns_cuda.launches
            peak = torch.cuda.max_memory_allocated()
            launches += count
            check(count == 1 + BATCH_REPS,
                  f"batch_full {case} {B}: K1 launched {count} times for "
                  f"{1 + BATCH_REPS} batches")
            check(bool(torch.isfinite(result.pose.t).all())
                  and bool(torch.isfinite(result.pose.q).all()),
                  f"batch_full {case} {B}: non-finite pose")
            check(feats.labels.shape == stacked.mask.shape,
                  f"batch_full {case} {B}: labels {tuple(feats.labels.shape)}")
            status = result.status.tolist()
            iters = result.iterations.tolist()
            q, t = result.pose.q.cpu(), result.pose.t.cpu()
            differ = [
                b for b in range(B) if (status[b], iters[b]) != lone[b][:2]
                or float((q[b] - lone[b][2]).abs().max()) > BATCH_Q_ATOL
                or float((t[b] - lone[b][3]).abs().max()) > BATCH_T_ATOL]
            rep = timer.report()[key]
            rerun_lanes = [b for b in range(B) if any(r[b] for r in reruns)]
            emit("batch_full", case=case, batch=B,
                 scans_per_s=rep["per_sec"] * B, ms_per_batch=rep["mean_ms"],
                 ms_per_scan=rep["mean_ms"] / B, batches_timed=rep["count"],
                 gn_iterations_max=max(iters),
                 gn_iterations_mean=statistics.fmean(iters),
                 distinct_iteration_counts=len(set(iters)),
                 status_counts={str(v): status.count(v) for v in sorted(
                     set(status))},
                 rounds_rerun=reruns, lanes_rerun=rerun_lanes,
                 k1_launches_per_batch=count / (1 + BATCH_REPS),
                 max_memory_allocated=peak,
                 lanes_equal_to_lone_runs=B - len(differ),
                 lanes_otherwise=differ)
            check(not differ, f"batch_full {case} {B}: lanes {differ} differ "
                              f"from their lone runs")
            if B > 1:
                check(len(set(iters)) > 1,
                      f"batch_full {case} {B}: every lane ran {iters[0]} "
                      f"iterations; the freeze is not exercised")
                knn_refit = (not c.compact_extraction
                             and c.registration.refit_per_iteration)
                if knn_refit:
                    check(0 < len(rerun_lanes) < B,
                          f"batch_full {case} {B}: lanes {rerun_lanes} ran "
                          f"the second search round; need some, not all")
            later.append((case, B, lambda r=run, m=maps, s=stacked, p=prior:
                          r(m, s, p)))
    return launches, later


def voxel_map_phase(args, fmaps, cfg, scan, pose, dev, k1) -> dict:
    """The voxel-hash map on the card: the drive's edge and surface map
    clouds inserted with ``VoxelMapConfig``'s table sizes, in the dense
    grids' map-local frames (their origins), so that both structures
    voxelize every point alike. ``knn`` from it must equal the dense
    grid's ``knn`` on one drive scan's features at its true pose (the
    same neighbours, validity and squared distances, bit for bit), and so
    must ``edge_residuals`` / ``surface_residuals`` through
    ``lookup_knn``. One ``export_labeled_scan`` PLY of the scan: its
    header and vertex count checked."""
    import tempfile

    import torch
    from lidar_feature_extraction_tpu_torch.ops import residuals as res
    from lidar_feature_extraction_tpu_torch.ops import voxel_grid as vg
    from lidar_feature_extraction_tpu_torch.ops import voxel_map as vm
    from lidar_feature_extraction_tpu_torch.ops.extraction import (
        extract_features)
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.utils.visualize import (
        export_labeled_scan)

    reg = cfg.registration
    k = reg.n_neighbors
    edge, emask, surf, smask = args
    image = scan_range_image(*scan, cfg, dev)
    k1.label_and_columns_cuda.launches = 0
    feats = extract_features(image, cfg.extraction)
    torch.cuda.synchronize()
    out = {"k1_launches": k1.label_and_columns_cuda.launches}
    hmaps = {}
    for name, pts, mask, mc, grid, q, qv in (
            ("edge", edge, emask, reg.edge_map, fmaps.edge, feats.edge_xyz,
             feats.edge_valid),
            ("surface", surf, smask, reg.surface_map, fmaps.surface,
             feats.surface_xyz, feats.surface_valid)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        hm = hmaps[name] = vm.build_voxel_map(
            pts, mask, mc.voxel_size, mc.table_capacity, mc.points_per_voxel,
            mc.max_probes, origin=grid.origin)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - start
        queries = pose.apply(q)
        got = vm.knn(hm, queries, k, mc.max_probes)
        want = vg.knn(grid, queries, k)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        stored, grid_stored = int(hm.n_pts.sum()), int(grid.n_pts.sum())
        out[name] = {
            "map_points": len(pts), "build_s": build_s,
            "buckets": mc.table_capacity,
            "buckets_used": int((hm.keys != vm._EMPTY).sum()),
            "points_stored": stored, "grid_points_stored": grid_stored,
            "queries": int(qv.sum()),
            "valid_neighbours": int(got[2][qv].sum()),
            "knn_equal_to_grid": same,
            "knn_ms": time_ms(lambda: vm.knn(hm, queries, k, mc.max_probes)),
            "grid_knn_ms": time_ms(lambda: vg.knn(grid, queries, k))}
        check(stored == grid_stored,
              f"voxel_map {name}: {stored} points stored, the grid "
              f"{grid_stored}")
        check(same, f"voxel_map {name}: knn differs from the dense grid's")
    for name, fn, pts, valid in (
            ("edge_residuals", res.edge_residuals, feats.edge_xyz,
             feats.edge_valid),
            ("surface_residuals", res.surface_residuals, feats.surface_xyz,
             feats.surface_valid)):
        m = "edge" if name.startswith("edge") else "surface"
        got = fn(hmaps[m], pts, valid, pose, k)
        want = fn(getattr(fmaps, m), pts, valid, pose, k)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        out[name] = {"rows_valid": int(got.valid.sum()), "equal_to_grid": same}
        check(same, f"voxel_map: {name} through the hash map differ from "
                    f"the dense grid's")
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "scan.ply")
        export_labeled_scan(path, image.xyz, image.mask, feats.labels)
        with open(path, "rb") as f:
            data = f.read()
    n = int(image.mask.sum())
    head, _, body = data.partition(b"end_header\n")
    lines = head.decode("ascii").splitlines()
    out["ply"] = {"bytes": len(data), "vertices": n, "header": lines}
    check(lines[:3] == ["ply", "format binary_little_endian 1.0",
                        f"element vertex {n}"] and len(body) == 15 * n,
          f"voxel_map: PLY header {lines} with {len(body)} body bytes for "
          f"{n} points")
    return out


def padded_seeded_graph(device):
    """``seeded_graph`` (40 keyframes, 47 constraints) with one
    zero-weight constraint lane, so that its 48 divide over the ranks,
    and identity information."""
    import torch

    graph, cons = seeded_graph(device)
    one = lambda a, v: torch.cat([a, torch.full((1,) + a.shape[1:], v,  # noqa: E731
                                                dtype=a.dtype,
                                                device=a.device)])
    z_q = torch.cat([cons.z_q, torch.tensor([[1.0, 0, 0, 0]],
                                            device=device)])
    m = cons.i.shape[0] + 1
    # The identity information the distributed optimizer materializes, so
    # that a solve without a group does the same arithmetic.
    return graph, cons._replace(i=one(cons.i, 0), j=one(cons.j, 1), z_q=z_q,
                                z_t=one(cons.z_t, 0.0),
                                weight=one(cons.weight, 0.0),
                                info=torch.eye(6, device=device).expand(
                                    m, 6, 6))


def seeded_imu_graph(device, k: int = 40, kf_every: int = 3, seed: int = 5):
    """A 40-keyframe IMU graph: tests/test_parallel.py's arc (2 m/s on a
    20 m radius, IMU at 20 Hz with a gyro bias of (0.01, -0.008, 0.02)
    rad/s) with numpy noise on the samples and the initial positions, a
    keyframe every ``kf_every`` samples; its 39 IMU factors and chain
    constraints padded with one zero-weight lane to 40."""
    import torch
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.fusion import imu as imu_mod
    from lidar_feature_extraction_tpu_torch.parallel.imu_graph import (
        ImuFactors, ImuGraph, weights_from_covariance)
    from lidar_feature_extraction_tpu_torch.parallel.pose_graph import (
        Constraints)

    rng = np.random.default_rng(seed)
    n, dt = (k - 1) * kf_every + 1, 0.05
    theta = 2.0 * dt * np.arange(n) / 20.0
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                    device=device)
    q = f32(np.stack([np.cos(theta / 2), 0 * theta, 0 * theta,
                      np.sin(theta / 2)], -1))
    t = f32(np.stack([20 * np.sin(theta), 20 * (1 - np.cos(theta)),
                      0 * theta], -1))
    gyro, accel, dts, _ = imu_mod.synthesize_imu(q, t, dt)
    gyro = gyro + f32([0.01, -0.008, 0.02]) + f32(
        rng.normal(scale=1e-3, size=tuple(gyro.shape)))
    accel = accel + f32(rng.normal(scale=1e-2, size=tuple(accel.shape)))
    kf = list(range(0, n, kf_every))
    zero = torch.zeros(3, device=device)
    pres = [imu_mod.preintegrate(gyro[a:b], accel[a:b], dts[a:b], zero,
                                 zero) for a, b in zip(kf[:-1], kf[1:])]
    rels = [Pose(q[a], t[a]).inverse().compose(Pose(q[b], t[b]))
            for a, b in zip(kf[:-1], kf[1:])]
    w = weights_from_covariance(torch.stack([p.cov for p in pres]))

    def padded(rows, fill=0.0):
        x = torch.stack(list(rows))
        return torch.cat([x, torch.full((1,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=device)])

    m = k - 1
    ident = torch.tensor([1.0, 0, 0, 0], device=device)
    i = torch.tensor(list(range(m)) + [0], dtype=torch.int32, device=device)
    j = torch.tensor(list(range(1, k)) + [1], dtype=torch.int32,
                     device=device)
    ones = torch.ones(m, device=device)
    cons = Constraints(i, j, torch.cat([torch.stack([r.q for r in rels]),
                                        ident[None]]),
                       padded(r.t for r in rels), padded(ones),
                       padded(torch.eye(6, device=device).expand(m, 6, 6)))
    field = lambda name: padded(getattr(p, name) for p in pres)  # noqa: E731
    imu = ImuFactors(i, j, torch.cat([torch.stack([p.dq for p in pres]),
                                      ident[None]]),
                     field("dv"), field("dp"), field("dt"), padded(w[0]),
                     padded(w[1]), padded(w[2]), padded(ones),
                     field("dq_dbg"), field("dv_dbg"), field("dv_dba"),
                     field("dp_dbg"), field("dp_dba"))
    idx = torch.tensor(kf, device=device)
    v_init = f32(np.gradient(t[idx].cpu().numpy(), axis=0) / (kf_every * dt))
    graph = ImuGraph(q[idx], t[idx] + f32(rng.normal(scale=0.05,
                                                     size=(k, 3))),
                     v_init, torch.zeros(3, device=device), None)
    return graph, cons, imu


def _timed(fn):
    """``fn()`` and its wall ms (host clock ending in synchronize())."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - start)


def multi_rank(reps: int) -> dict:
    """One rank of the ``multi`` phase (``multihost.spawn``, a gloo group
    on the one card): the bench scene's batch of MULTI_BATCH lanes through
    ``make_batched_localizer`` over the mesh (this rank's shard, one K1
    launch per batch, every lane bit for bit its lone ``localize_scan``,
    the whole batch through ``gather_to_host``), then the sharded dense
    and CG pose-graph solves of ``padded_seeded_graph`` and the sharded
    IMU-graph solve of ``seeded_imu_graph``, each twice, beside the
    one-rank solve. Raises SmokeFailure on a failed check; returns the
    figures and the solved states (numpy) for the cross-rank check."""
    import torch
    from lidar_feature_extraction_tpu_torch.config import kitti_hdl64
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.core.scan import (
        stack_range_images)
    from lidar_feature_extraction_tpu_torch.ops import extraction_cuda as k1
    from lidar_feature_extraction_tpu_torch.parallel import imu_graph as ig
    from lidar_feature_extraction_tpu_torch.parallel import multihost
    from lidar_feature_extraction_tpu_torch.parallel import pose_graph as pg
    from lidar_feature_extraction_tpu_torch.parallel.distributed import (
        make_batched_localizer)
    from lidar_feature_extraction_tpu_torch.parallel.mesh import (
        make_mesh, shard_batch)
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        localize_scan)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k1.load()          # built by the parent: only loaded here
    mesh = make_mesh()
    dev = mesh.device
    tag = f"multi rank {mesh.rank}"
    cfg = kitti_hdl64()
    img, edge, surf = bench_scene(cfg, dev)
    maps = multihost.replicate_to_global(mesh, build_maps(edge, surf, cfg))
    images, poses = batch_lanes(img, MULTI_BATCH)
    stacked = stack_range_images(images)
    prior = Pose(torch.stack([p.q for p in poses]),
                 torch.stack([p.t for p in poses]))
    run = make_batched_localizer(cfg, mesh=mesh)
    run(maps, stacked, prior)                      # untimed
    torch.cuda.synchronize()
    k1.label_and_columns_cuda.launches = 0
    ms = []
    for _ in range(reps):
        (result, feats), t = _timed(lambda: run(maps, stacked, prior))
        ms.append(t)
    launches = k1.label_and_columns_cuda.launches
    check(launches == reps, f"{tag}: K1 launched {launches} times for "
                            f"{reps} batches")
    per = MULTI_BATCH // mesh.size
    lanes = range(mesh.rank * per, (mesh.rank + 1) * per)
    check(feats.edge_xyz.shape[0] == per, f"{tag}: features of "
                                          f"{feats.edge_xyz.shape[0]} scans")
    for n, b in enumerate(lanes):
        lone, _ = localize_scan(maps, images[b], poses[b], cfg)
        same = all(torch.equal(x, y) for x, y in (
            (result.status[n], lone.status),
            (result.iterations[n], lone.iterations),
            (result.pose.q[n], lone.pose.q), (result.pose.t[n], lone.pose.t)))
        check(same, f"{tag}: lane {b} differs from its lone localize_scan")
    fields = (result.status, result.iterations, result.pose.q, result.pose.t)
    whole = multihost.gather_to_host(mesh, fields)
    check(all(torch.equal(w[mesh.rank * per:(mesh.rank + 1) * per], f.cpu())
              for w, f in zip(whole, fields)),
          f"{tag}: gather_to_host differs from the rank's shard")

    out = {"rank": mesh.rank, "k1_launches": launches,
           "ms_per_batch": statistics.median(ms), "ms_batches": ms,
           "lanes": list(lanes),
           "gn_iterations": result.iterations.tolist(),
           "gathered": [w.numpy() for w in whole]}
    graph, cons = padded_seeded_graph(dev)
    k = graph.poses_q.shape[0]
    for solver, single in (("dense", pg.optimize_pose_graph),
                           ("cg", pg.optimize_pose_graph_cg)):
        opt = pg.make_distributed_pose_graph_optimizer(mesh, k, solver)
        (a, ta), (b, tb) = (_timed(lambda: opt(graph, cons))
                            for _ in range(2))
        one, t1 = _timed(lambda: single(graph, cons))
        out[solver] = _solve_figures(a, b, one, (ta, tb), t1)
    # The IMU graph in float64, where its sharded sum may differ from the
    # one-rank sum only in rounding; in float32 its 40-keyframe solve
    # moves by centimetres with the order of summation alone, so that gap
    # is printed, not held.
    f64 = lambda nt: type(nt)(*(  # noqa: E731
        None if x is None else x.double() if x.is_floating_point() else x
        for x in nt))
    for name, cast in (("imu", f64), ("imu_float32", lambda nt: nt)):
        igraph, icons, imu = (cast(x) for x in seeded_imu_graph(dev))

        def sharded():
            return ig.optimize_imu_graph(
                igraph, type(icons)(*(shard_batch(mesh, x) for x in icons)),
                type(imu)(*(shard_batch(mesh, x) for x in imu)),
                n_iterations=10, group=mesh.group)

        (a, ta), (b, tb) = (_timed(sharded) for _ in range(2))
        one, t1 = _timed(lambda: ig.optimize_imu_graph(igraph, icons, imu,
                                                       n_iterations=10))
        out[name] = _solve_figures(a, b, one, (ta, tb), t1)
        out[name]["gyro_bias"] = a.bg.tolist()
    return out


def _solve_figures(a, b, one, ms, ms_one) -> dict:
    """A sharded solve's first and second results ``a``, ``b`` against the
    one-rank ``one``: same bits twice, the largest position / quaternion
    difference, times, and the state (numpy) for the cross-rank check."""
    import torch

    state = [x for x in a if x is not None]
    return {"same_bits_twice": all(torch.equal(x, y) for x, y in zip(
                state, [y for y in b if y is not None])),
            "max_dt_m": float((a.poses_t - one.poses_t).abs().max()),
            "max_dq": float((a.poses_q - one.poses_q).abs().max()),
            "ms_per_solve": list(ms), "ms_one_rank": ms_one,
            "state": [x.cpu().numpy() for x in state]}


def nccl_one_rank() -> dict:
    """A one-rank NCCL group (``multihost.initialize`` starts nothing at
    one process, so it is started here) and the dense solve of
    ``padded_seeded_graph`` sharded over it: the all-reduce of one rank
    is the identity, so it must equal the solve without a group."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from lidar_feature_extraction_tpu_torch.parallel import pose_graph as pg
    from lidar_feature_extraction_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="env://", world_size=1,
                            rank=0, timeout=timedelta(seconds=120))
    mesh = make_mesh()
    graph, cons = padded_seeded_graph(mesh.device)
    want, ms_no_group = _timed(lambda: pg.optimize_pose_graph(graph, cons))
    opt = pg.make_distributed_pose_graph_optimizer(mesh, 40)
    got, ms_first = _timed(lambda: opt(graph, cons))
    got, ms = _timed(lambda: opt(graph, cons))
    return {"backend": str(dist.get_backend()), "ms_per_solve": ms,
            "ms_first_solve": ms_first, "ms_no_group_first": ms_no_group,
            "equal_to_no_group": torch.equal(got.poses_t, want.poses_t)
            and torch.equal(got.poses_q, want.poses_q)}


def nccl_two_ranks_probe() -> dict:
    """What NCCL does with two ranks on one card: a NCCL group over the
    two ranks of a gloo group, both on cuda:0, and one all-reduce.
    Recorded, never relied on."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        group = dist.new_group(backend="nccl")
        x = torch.ones(4, device="cuda:0")
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
    except RuntimeError as e:      # the outcome is the finding
        return {"outcome": "raised", "error": f"{type(e).__name__}: "
                                              f"{str(e)[:300]}"}
    return {"outcome": "ran", "sum": x.tolist()}


def multi_phase(k1) -> dict:
    """The ``multi`` phase: MULTI_RANKS gloo ranks on the one card
    (``multi_rank``), their results held against each other bit for bit;
    a one-rank NCCL group's dense solve; the NCCL probe of two ranks on
    one card (recorded). Returns the phase's figures."""
    from lidar_feature_extraction_tpu_torch.parallel import multihost

    start = time.perf_counter()
    ranks = multihost.spawn(multi_rank, MULTI_RANKS, BATCH_REPS,
                            backend="gloo", timeout_s=MULTI_TIMEOUT_S)
    wall = time.perf_counter() - start
    for name in ("dense", "cg", "imu", "imu_float32"):
        for r in ranks:
            fig = r[name]
            check(fig["same_bits_twice"],
                  f"multi rank {r['rank']} {name}: a second call gave other "
                  f"bits")
            atol = SOLVE_ATOL.get(name)
            check(atol is None or max(fig["max_dt_m"], fig["max_dq"]) <= atol,
                  f"multi rank {r['rank']} {name}: {fig['max_dt_m']} m / "
                  f"{fig['max_dq']} from the one-rank solve")
        check(all(np.array_equal(a, b) for a, b in zip(
            ranks[0][name]["state"], ranks[1][name]["state"])),
              f"multi {name}: the ranks' solves differ")
    check(all(np.array_equal(a, b) for a, b in zip(ranks[0]["gathered"],
                                                   ranks[1]["gathered"])),
          "multi: the ranks gathered different batches")
    one = multihost.spawn(nccl_one_rank, 1, backend="nccl",
                          timeout_s=MULTI_TIMEOUT_S)[0]
    check(one["backend"] == "nccl" and one["equal_to_no_group"],
          f"multi: one-rank NCCL solve {one}")
    try:
        probe = multihost.spawn(nccl_two_ranks_probe, 2, backend="gloo",
                                timeout_s=PROBE_TIMEOUT_S)
    except (RuntimeError, TimeoutError) as e:
        probe = f"{type(e).__name__}: {str(e)[-300:]}"
    for r in ranks:
        for name in ("dense", "cg", "imu", "imu_float32"):
            r[name].pop("state")
        r.pop("gathered")
    return {"ranks": ranks, "wall_s": wall,
            "k1_launches": sum(r["k1_launches"] for r in ranks),
            "nccl_one_rank": one, "nccl_two_ranks_one_card": probe}


def chunk_scans(world, rng, cfg, device, n: int):
    """The first ``n`` of ``slam_loop``'s 80 scans as range images on
    ``device``: ``rng`` in the state the slam phase's first drive found
    it, drawn as ``worldsim.run_mapping_drive`` draws without IMU."""
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.utils import worldsim

    return [scan_range_image(*worldsim.raycast_scan(
        world, worldsim.circle_pose(i, SLAM_SCANS, 10.0), rng, n_rings=64,
        n_az=2048, elev_deg=(2.0, -24.8)), cfg, device) for i in range(n)]


def chunk_run(images, cfg, k1, dead: int | None = None):
    """``ChunkedMappingPipeline`` over ``images`` in blocks of
    CHUNK_BLOCK with slam_loop's settings, each block timed (host clock
    ending in synchronize()), then the final optimize(); with ``dead`` that
    scan's points all invalid. K1's count is read over exactly the run.
    Returns the pipeline (``replayed``: the scans it replayed), K1's
    launches, the ms of each block and the blocks it replayed."""
    import torch
    from lidar_feature_extraction_tpu_torch.core.scan import (
        stack_range_images)
    from lidar_feature_extraction_tpu_torch.pipeline.mapping_chunk import (
        ChunkedMappingPipeline)

    class Counted(ChunkedMappingPipeline):
        replayed = 0
        gate = []       # per suspect block: statuses, edge medians (m)

        def _extract(self, image):
            self.replayed += 1
            return super()._extract(image)

        def _block_suspect(self, status, edge_errors):
            out = super()._block_suspect(status, edge_errors)
            if out:
                self.gate = self.gate + [{
                    "status": status.tolist(),
                    "edge_median_m": (np.sqrt(np.maximum(edge_errors, 0.0))
                                      / 2.0).tolist()}]
            return out

    if dead is not None:
        im = images[dead]
        images = list(images)
        images[dead] = im._replace(xyz=torch.zeros_like(im.xyz),
                                   mask=torch.zeros_like(im.mask),
                                   count=torch.zeros_like(im.count))
    pipeline = Counted(cfg, device=images[0].xyz.device, loop_radius=6.0,
                       loop_min_gap=10, optimize_every=8)
    torch.cuda.synchronize()
    k1.label_and_columns_cuda.launches = 0
    ms, replayed = [], []
    for s in range(0, len(images), CHUNK_BLOCK):
        block = images[s:s + CHUNK_BLOCK]
        before = pipeline.replayed
        _, t = _timed(lambda: pipeline.process_block(
            stack_range_images(block), [0.1 * (s + n)
                                        for n in range(len(block))]))
        ms.append(t)
        if pipeline.replayed > before:
            replayed.append(s // CHUNK_BLOCK)
    pipeline.optimize()
    torch.cuda.synchronize()
    return pipeline, k1.label_and_columns_cuda.launches, ms, replayed


def count_syncs(fn):
    """``fn()`` under torch's sync debug mode: its result and the number
    of operations in it that made the host wait for the card (reads back
    to the host)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def host_phase(chains, scene_maps, cfg, fmaps, faithful, scans, dev,
               k1) -> tuple[dict, list]:
    """``HostLocalizer.localize`` on the card: the localize phase's stored
    inputs over GeometryMaps (status, iterations and pose held bit for bit
    against the stored ``localize_scan`` results), then the drive's scans
    over its FeatureMaps with the faithful configuration, each prior the
    true pose moved by the localize phase's noisy offsets. K1 counted over
    exactly these calls. Then, in turns, ``localize_scan`` twice and the
    host loop again on the same inputs (timed, the search rounds counted),
    and the synchronizing operations of one registration of each kind
    through both drivers. Returns the figures and, for the profiler
    later, one street scan's localization through each driver."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import quaternion as quat
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
    from lidar_feature_extraction_tpu_torch.pipeline import (
        localization as loc)
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.utils import worldsim

    hosts = {scene: loc.HostLocalizer(m, cfg)
             for scene, m in scene_maps.items()}
    images, drive_priors, truths = [], [], []
    for i, (dq, dt) in enumerate(priors(True, len(scans))):
        truth = worldsim.straight_drive(i)
        images.append(scan_range_image(*scans[i], faithful, dev))
        drive_priors.append(Pose(
            quat.quat_multiply(truth.q.float(), torch.as_tensor(
                dq, dtype=torch.float32)).to(dev),
            (truth.t.float() + torch.as_tensor(dt, dtype=torch.float32)
             ).to(dev)))
        truths.append(truth.t.float().to(dev))
    fhost = loc.HostLocalizer(fmaps, faithful)
    # Search rounds: the host loop gathers candidates once per round
    # (refitting every iteration, the faithful configuration calls
    # _gather itself); localize_scan reruns a round through one call of
    # _select_scans.
    calls = {"gather": 0, "select": 0}

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    fhost._gather = counting("gather", fhost._gather)
    select = loc._select_scans

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - start)

    def rounds_of(name, fn):
        before = calls[name]
        out = fn()
        return out, calls[name] - before + (name == "select")

    inputs = [(key[0], im, prior) for key, runs in chains.items()
              for (im, prior), _, _ in runs]
    drive = list(zip(images, drive_priors))

    # Each pass keeps the results (not the features) and the times.
    def host_pass():
        geo = [timed(lambda: hosts[scene].localize(im, prior)[0])
               for scene, im, prior in inputs]
        feat = [timed(lambda: rounds_of("gather", lambda: fhost.localize(
            im, prior)[0])) for im, prior in drive]
        return geo, feat

    def fused_pass():
        geo = [timed(lambda: loc.localize_scan(scene_maps[scene], im, prior,
                                               cfg)[0])
               for scene, im, prior in inputs]
        feat = [timed(lambda: rounds_of("select", lambda: loc.localize_scan(
            fmaps, im, prior, faithful)[0])) for im, prior in drive]
        return geo, feat

    # The main path, counted: the first host pass.
    start_s = time.perf_counter()
    torch.cuda.synchronize()
    k1.label_and_columns_cuda.launches = 0
    passes = [host_pass()]
    torch.cuda.synchronize()
    launches = k1.label_and_columns_cuda.launches
    # Then in turns: localize_scan, localize_scan, the host loop.
    loc._select_scans = counting("select", select)
    try:
        passes += [fused_pass(), fused_pass(), host_pass()]

        # Synchronizing operations of one registration through each
        # driver, and what torch's sync debug mode counts for one read of
        # a scalar as localize_scan's loop does it and as a .tolist().
        x = torch.arange(4.0, device=dev)
        syncs = {"int_counts": count_syncs(lambda: int(x[1]))[1],
                 "tolist_counts": count_syncs(lambda: x.tolist())[1]}
        street_im, street_prior = chains["street", True][0][0]
        for kind, host, maps, c, im, prior in (
                ("geometry_maps", hosts["street"], scene_maps["street"],
                 cfg, street_im, street_prior),
                ("feature_maps", fhost, fmaps, faithful, images[0],
                 drive_priors[0])):
            f = host._extract(im)
            args = (f.edge_xyz, f.edge_valid, f.surface_xyz,
                    f.surface_valid, prior)
            (h, h_rounds), h_syncs = count_syncs(lambda: rounds_of(
                "gather", lambda: host.register(*args)))
            if kind == "geometry_maps":
                (fz, f_rounds), f_syncs = count_syncs(lambda: rounds_of(
                    "select", lambda: loc.register_scan_geometry(
                        maps, *args, c, pre_downsampled=True)))
            else:
                (fz, f_rounds), f_syncs = count_syncs(lambda: rounds_of(
                    "select", lambda: loc.register_scan(maps, *args, c)))
            syncs[kind] = {
                "host_syncs": h_syncs,
                "host_gn_iterations": int(h.iterations),
                "host_syncs_per_gn_iteration": h_syncs / max(
                    int(h.iterations), 1),
                "localize_scan_syncs": f_syncs,
                "localize_scan_gn_iterations": int(fz.iterations),
                "rounds": [h_rounds, f_rounds] if kind == "feature_maps"
                else None}
    finally:
        loc._select_scans = select

    valid = (gn.CONVERGED, gn.MAX_ITERATIONS, gn.ERROR_INCREASED,
             gn.SCALE_INCREASED)
    stored = [want for runs in chains.values() for _, want, _ in runs]
    geo = [g for g, _ in passes[0][0]]
    geo_same = sum(int(g.status) == int(w.status)
                   and int(g.iterations) == int(w.iterations)
                   and torch.equal(g.pose.q, w.pose.q)
                   and torch.equal(g.pose.t, w.pose.t)
                   for g, w in zip(geo, stored))
    feat = [(g, r) for (g, r), _ in passes[0][1]]
    fused = [(f, r) for (f, r), _ in passes[1][1]]
    t_err = [float(torch.linalg.vector_norm(g.pose.t - t))
             for (g, _), t in zip(feat, truths)]
    prior_err = [float(torch.linalg.vector_norm(p.t - t))
                 for p, t in zip(drive_priors, truths)]
    hr, fr = [r for _, r in feat], [r for _, r in fused]
    # With the same rounds both drivers ran the same device steps.
    same_rounds_equal = sum(
        int(g.status) == int(f.status)
        and int(g.iterations) == int(f.iterations)
        and torch.equal(g.pose.t, f.pose.t)
        for (g, a), (f, b) in zip(feat, fused) if a == b)
    status = [int(g.status) for g, _ in feat]

    def ms(which, part):
        """ms per scan of the host passes (0, 3) or localize_scan's
        (1, 2): mean, median and each pass's median."""
        runs = [[m for _, m in passes[i][part]] for i in which]
        every = [m for r in runs for m in r]
        return {"mean": statistics.fmean(every),
                "median": statistics.median(every),
                "pass_medians": [statistics.median(r) for r in runs]}

    return {
        "k1_launches": launches, "scans": len(geo) + len(feat),
        "seconds": time.perf_counter() - start_s,
        "geometry_maps": {
            "scans": len(geo), "equal_to_localize_scan": geo_same,
            "host_ms_per_scan": ms((0, 3), 0),
            "localize_scan_ms_per_scan": ms((1, 2), 0),
            "gn_iterations_mean": statistics.fmean(
                int(g.iterations) for g in geo)},
        "feature_maps": {
            "scans": len(feat),
            "finite": all(bool(torch.isfinite(g.pose.q).all())
                          and bool(torch.isfinite(g.pose.t).all())
                          for g, _ in feat),
            "statuses_valid": all(s in valid for s in status),
            "status_counts": {str(s): status.count(s)
                              for s in sorted(set(status))},
            "t_err_m": t_err, "prior_t_err_m": prior_err,
            "closer_than_prior": sum(e <= p for e, p in
                                     zip(t_err, prior_err)),
            "host_rounds": hr, "localize_scan_rounds": fr,
            "fewer_rounds": sum(a < b for a, b in zip(hr, fr)),
            "more_rounds": sum(a > b for a, b in zip(hr, fr)),
            "same_rounds_equal": same_rounds_equal,
            "same_rounds": sum(a == b for a, b in zip(hr, fr)),
            "host_ms_per_scan": ms((0, 3), 1),
            "localize_scan_ms_per_scan": ms((1, 2), 1),
            "gn_iterations_mean": statistics.fmean(
                int(g.iterations) for g, _ in feat)},
        "syncs": syncs}, [
            ("host", lambda: hosts["street"].localize(street_im,
                                                      street_prior)),
            ("localize_scan", lambda: loc.localize_scan(
                scene_maps["street"], street_im, street_prior, cfg))]


def _results_margin(got: dict, rec: dict, run: str, t_atol: float,
                    q_atol: float) -> dict:
    """Status and iterations against the record's ``run``, the largest
    pose differences and their margins to the bounds."""
    dt = np.abs(got["t"].astype(np.float64) - rec[f"{run}_t"]).max(axis=1)
    dq = np.abs(got["q"].astype(np.float64) - rec[f"{run}_q"]).max(axis=1)
    return {"status": got["status"].tolist(),
            "record_status": rec[f"{run}_status"].tolist(),
            "iterations": got["iterations"].tolist(),
            "record_iterations": rec[f"{run}_iterations"].tolist(),
            "same_status_iterations": bool(
                np.array_equal(got["status"], rec[f"{run}_status"])
                and np.array_equal(got["iterations"],
                                   rec[f"{run}_iterations"])),
            "t_diff_m": dt.tolist(), "q_diff": dq.tolist(),
            "t_atol_m": t_atol, "q_atol": q_atol,
            "t_margin_m": t_atol - float(dt.max()),
            "q_margin": q_atol - float(dq.max())}


def reference_phase(dev, k1) -> dict:
    """The card held to the committed record of what the JAX package
    computes at full width (``reference_cases.py``; no JAX here): per
    case, the preset through ``launch.load_config``, the maps built on
    the card from the record's clouds, and ``localize_scan`` from the
    five priors (K1 counted: one launch per scan). Labels, curvature and
    features equal to the record's bit for bit; registration fed the
    record's features (kitti_hdl64 in float32, vlp16 in float64) with
    the record's status and iterations and a pose within 1e-4;
    ``localize_scan`` under kitti_hdl64 (and its first iteration) and
    under vlp16 (float32, the kNN fits) likewise. Returns the figures by
    case; raises on a miss."""
    import torch

    import reference_cases as rc
    from lidar_feature_extraction_tpu_torch.pipeline import (
        launch, localization)

    start = time.perf_counter()
    arrays, manifest = rc.load()
    out = {"cases": {}}
    launches = 0
    for case in rc.CASES:
        preset, _ = rc.split(case)
        cfg = launch.load_config(preset)
        rec = rc.case_arrays(arrays, case)
        m = manifest["cases"][case]
        maps = rc.port_maps(case, rec["labels"], cfg, dev)
        img = rc.port_image(case, cfg, dev)
        poses = rc.port_poses(dev)
        torch.cuda.synchronize()
        k1.label_and_columns_cuda.launches = 0
        runs = [localization.localize_scan(maps, img, p, cfg) for p in poses]
        torch.cuda.synchronize()
        n = k1.label_and_columns_cuda.launches
        check(n == len(poses), f"reference {case}: K1 launched {n} times "
                               f"for {len(poses)} scans")
        launches += n
        feats = runs[0][1]
        check(all(torch.equal(f.labels, feats.labels)
                  and torch.equal(f.curvature, feats.curvature)
                  for _, f in runs),
              f"reference {case}: labels or curvature differ between runs")
        labels = feats.labels.cpu().numpy()
        curv_bits = feats.curvature.cpu().numpy().view(np.int32)
        differ = np.argwhere(labels != rec["labels"])
        curv_differ = int((curv_bits != rec["curvature"].view(np.int32))
                          .sum())
        check(len(differ) == 0 and curv_differ == 0,
              f"reference {case}: labels differ from the record at "
              f"{differ[:8].tolist()} ({len(differ)} lanes), curvature at "
              f"{curv_differ} lanes")
        same = all(np.array_equal(getattr(feats, k).cpu().numpy(), rec[k])
                   for k in ("edge_xyz", "edge_valid", "surface_xyz",
                             "surface_valid"))
        check(same, f"reference {case}: features differ from the record")
        loc = rc.results_arrays([r for r, _ in runs])
        fig = {"preset": preset, "shape": m["shape"],
               "k1_launches": n, "lanes_differing": len(differ),
               "curvature_lanes_differing": curv_differ,
               "features_equal": same}
        if cfg.compact_extraction:
            reg = rc.register_on_features(
                maps, rc.ref_features_tensors(rec, dev), poses, cfg)
            fig["register"] = _results_margin(reg, rec, "localize",
                                              rc.T_ATOL, rc.Q_ATOL)
            fig["localize"] = _results_margin(loc, rec, "localize",
                                              rc.T_ATOL, rc.Q_ATOL)
            k1.label_and_columns_cuda.launches = 0
            one = rc.results_arrays([localization.localize_scan(
                maps, img, p, rc.one_iteration(cfg))[0] for p in poses])
            torch.cuda.synchronize()
            launches += k1.label_and_columns_cuda.launches
            fig["one_iteration"] = _results_margin(one, rec, "one_iteration",
                                                   rc.T_ATOL, rc.Q_ATOL)
            held = ("register", "localize", "one_iteration")
        else:
            f64 = torch.float64
            reg = rc.register_on_features(
                rc.port_maps(case, rec["labels"], cfg, dev, f64),
                rc.ref_features_tensors(rec, dev, f64),
                rc.port_poses(dev, f64), cfg)
            fig["register_float64"] = _results_margin(
                reg, rec, "localize64", rc.T_ATOL, rc.Q_ATOL)
            fig["localize_float32"] = _results_margin(
                loc, rec, "localize", rc.T_ATOL, rc.Q_ATOL)
            held = ("register_float64", "localize_float32")
        for run in held:
            r = fig[run]
            check(r["same_status_iterations"] and r["t_margin_m"] >= 0
                  and r["q_margin"] >= 0,
                  f"reference {case} {run}: status {r['status']} "
                  f"(record {r['record_status']}), iterations "
                  f"{r['iterations']} (record {r['record_iterations']}), "
                  f"t {r['t_diff_m']} within {r['t_atol_m']}, q "
                  f"{r['q_diff']} within {r['q_atol']}")
        out["cases"][case] = fig
    out["k1_launches"] = launches
    out["seconds"] = time.perf_counter() - start
    return out


def fma_operands(device):
    """fma_f32's test operands on ``device``: ``FMA_RANDOM`` float32
    triples of every magnitude (numpy seed 11), then edge cases: signed
    zeros, subnormals, infinities, NaN, products that cancel the addend
    exactly, and sums halfway between two floats."""
    import torch

    rng = np.random.default_rng(11)
    n = FMA_RANDOM
    mags = np.float32(2.0) ** rng.integers(-40, 40, (3, n)).astype(np.float32)
    a, b, c = np.float32(rng.normal(size=(3, n))) * mags
    sub = np.float32(1e-40)
    specials = np.float32([0.0, -0.0, sub, -sub, np.inf, -np.inf, np.nan,
                           1.0, -1.0, 3.0, 1e30, -1e30, 1e-30])
    sa, sb, sc = (g.ravel() for g in np.meshgrid(specials, specials,
                                                  specials))
    x = np.float32(rng.normal(size=1000))
    y = np.float32(rng.normal(size=1000))
    exact = np.float32(np.float32(2.0) ** rng.integers(-3, 4, 1000))
    cancel_c = -(x * exact)                       # exact products cancel
    half = np.float32(1.0 + 2.0 ** -23)           # 1 + ulp
    a = np.concatenate([a, sa, x, np.full(1000, half, np.float32)])
    b = np.concatenate([b, sb, exact, np.full(1000, half, np.float32)])
    c = np.concatenate([c, sc, cancel_c, -y * np.float32(2.0 ** -40)])
    return tuple(torch.as_tensor(v, device=device) for v in (a, b, c))


# fma_f32's layouts (``fma_layout``): contiguous operands of sizes about a
# float4's multiple, views that are not 16-byte aligned, a Python float
# ``a``, one broadcast element, a row block's [8192, 1] against [8192, 3],
# a transposed and a strided view, 8 dimensions that coalesce into 1 or
# stay 3, empty operands.
FMA_LAYOUTS = ("n1", "n3", "n4", "n5", "n1023", "n1048579", "offset_b",
               "offset_all", "scalar_a", "element_a", "scalar_tensor_a",
               "column_a", "transposed", "strided", "dims8_contiguous",
               "dims8_broadcast", "empty", "empty_rows")


def fma_layout(name: str, device):
    """The operands (a, b, c) of fma_f32's layout ``name``
    (``FMA_LAYOUTS``), made with numpy from a seed and moved to
    ``device``."""
    import torch

    rng = np.random.default_rng(list(FMA_LAYOUTS).index(name) + 100)

    def rand(*shape):
        return torch.as_tensor(np.float32(rng.normal(size=shape)),
                               device=device)

    if name.startswith("n"):
        n = int(name[1:])
        return rand(n), rand(n), rand(n)
    m = 8192
    if name == "offset_b":
        return rand(4097), rand(4098)[1:], rand(4097)
    if name == "offset_all":
        return rand(4098)[1:], rand(4098)[1:], rand(4098)[1:]
    if name == "scalar_a":
        return -1.5, rand(4099), rand(4099)
    if name == "element_a":
        return rand(1), rand(4099), rand(4099)
    if name == "scalar_tensor_a":
        return rand(1)[0], rand(m, 3), rand(m, 3)
    if name == "column_a":
        return rand(m, 1), rand(m, 3), rand(m, 3)
    if name == "transposed":
        return rand(m, 3), rand(3, m).t(), rand(m, 3)
    if name == "strided":
        return rand(2 * m, 3)[::2], rand(m, 3), rand(1, 3)
    shape = (2, 3, 2, 2, 2, 2, 2, 3)
    if name == "dims8_contiguous":
        return rand(*shape), rand(*shape), rand(*shape)
    if name == "dims8_broadcast":
        return rand(2, 3, 1, 1, 1, 1, 1, 1), rand(*shape), rand(1, *shape[1:])
    if name == "empty":
        return rand(0), rand(0), rand(0)
    if name == "empty_rows":
        return rand(0, 1), rand(0, 3), rand(0, 3)
    raise ValueError(name)


def fma_phase(dev, fma) -> dict:
    """fma_f32 against its plain version (``_xla_f32._fma_plain``) on the
    card, bit for bit (NaN against NaN): the random and edge-case
    triples of ``fma_operands``, then every layout of ``FMA_LAYOUTS``
    (shape, and no launch for an empty output, checked too). The
    launches made here are not counted for any main path."""
    import torch
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf

    saved = fma.fma_f32_cuda.launches
    a, b, c = fma_operands(dev)
    got = fma.fma_f32_cuda(a, b, c)
    want = xf._fma_plain(a, b, c)
    finite = torch.isfinite(got) & torch.isfinite(want)
    out = {"elements": a.numel(), "differ": gk.differing(got, want),
           "max_abs_err": float((got - want)[finite].abs().max())}
    for name in FMA_LAYOUTS:
        x, y, z = fma_layout(name, dev)
        before = fma.fma_f32_cuda.launches
        got = fma.fma_f32_cuda(x, y, z)
        want = xf._fma_plain(x, y, z)
        launched = fma.fma_f32_cuda.launches - before
        out[f"differ_{name}"] = (
            gk.differing(got, want) if got.shape == want.shape
            else f"shape {list(got.shape)} against {list(want.shape)}")
        if launched != int(want.numel() > 0):
            out[f"differ_{name}_launches"] = f"{launched} launches"
    torch.cuda.synchronize()
    fma.fma_f32_cuda.launches = saved
    bad = {k: v for k, v in out.items() if k.startswith("differ") and v}
    check(not bad, f"fma_f32: differs from its plain version: {bad}")
    return out


def fma_size_tally(sizes: dict) -> dict:
    """fma_f32's launches by element count (``fma_f32_cuda.sizes``): in
    power-of-two buckets ("2^k": counts of 2^k <= n < 2^(k+1)) and the
    ten most common counts, [[n, launches], ...]."""
    buckets = {}
    for n, count in sizes.items():
        key = f"2^{int(n).bit_length() - 1}"
        buckets[key] = buckets.get(key, 0) + count
    top = sorted(sizes.items(), key=lambda kv: (-kv[1], kv[0]))[:10]
    return {"launches": sum(sizes.values()),
            "pow2": dict(sorted(buckets.items(),
                                key=lambda kv: int(kv[0][2:]))),
            "top": [[int(n), c] for n, c in top]}


def fma_timing(dev, fma, bound_us, device_us_per_launch,
               host_us_per_call, tallied: int) -> dict:
    """fma_f32 timed on the card at 2^20 elements of one shape, at a
    production row block's [8192, 3] with a broadcast ``a`` [8192, 1], and
    at ``tallied`` elements of one shape (the main path's most common
    size, ``fma_size_tally``): device time per launch (profiler) with the
    operands read from memory (each launch takes the next of
    ``ROTATE_BYTES`` of operand sets, more than the L2 holds; the
    library's launches go on where the kernel's stopped) and, as
    ``device_us_l2``, with one set that stays in L2; host time per call of
    the wrapper (``host_us``), of ``xf.fma`` (``host_us_xf``, the port's
    call) and of ``torch.addcmul`` (``library_host_us``), by the same
    method; the plain version's time (CUDA events), ``torch.addcmul``'s
    device time per launch by the same two profiler methods (and its
    CUDA-event time beside them), and the bound (16 bytes per element at
    the memory rate; 2 operations)."""
    import itertools
    import torch
    from lidar_feature_extraction_tpu_torch.core import _xla_f32 as xf

    saved = fma.fma_f32_cuda.launches
    out = {}
    g = torch.Generator(device=dev).manual_seed(12)
    for name, shape_a, shape in (("1m", (1 << 20,), (1 << 20,)),
                                 ("rows", (8192, 1), (8192, 3)),
                                 ("tallied", (tallied,), (tallied,))):
        n = shape[0] * (shape[1] if len(shape) > 1 else 1)
        nbytes = 4 * (shape_a[0] + 3 * n)
        sets = -(-ROTATE_BYTES // nbytes)
        a_all = torch.randn((sets, *shape_a), device=dev, generator=g)
        b_all = torch.randn((sets, *shape), device=dev, generator=g)
        c_all = torch.randn((sets, *shape), device=dev, generator=g)
        a, b, c = a_all[0], b_all[0], c_all[0]
        bound, by = bound_us(nbytes, 2 * n)

        # One rotation for the kernel and addcmul: a fresh one would hand
        # addcmul the sets the kernel has just read, which fit in L2 at
        # the tallied size.
        order = itertools.cycle(range(sets))

        def from_memory(fn):
            def call():
                i = next(order)
                return fn(a_all[i], b_all[i], c_all[i])
            return call

        def kernel(x, y, z):
            return fma.fma_f32_cuda(x, y, z)

        def library(x, y, z):
            return torch.addcmul(z, x, y)

        out[name] = {
            "shape": list(shape),
            "operand_sets": sets,
            "device_us": device_us_per_launch(
                from_memory(kernel), FMA_KERNEL, FMA_LAUNCHES)[0],
            "device_us_l2": device_us_per_launch(
                lambda: kernel(a, b, c), FMA_KERNEL, FMA_LAUNCHES)[0],
            "host_us": host_us_per_call(lambda: kernel(a, b, c)),
            "host_us_xf": host_us_per_call(lambda: xf.fma(a, b, c)),
            "library_host_us": host_us_per_call(lambda: library(a, b, c)),
            "plain_ms": time_ms(lambda: xf._fma_plain(a, b, c)),
            "library_device_us": device_us_per_launch(
                from_memory(library), ADDCMUL_KERNEL, FMA_LAUNCHES)[0],
            "library_device_us_l2": device_us_per_launch(
                lambda: library(a, b, c), ADDCMUL_KERNEL, FMA_LAUNCHES)[0],
            "library_event_ms": time_ms(lambda: library(a, b, c)),
            "addcmul_equal": bool(torch.equal(library(a, b, c),
                                              kernel(a, b, c))),
            "bound_us": bound, "bound_by": by, "bytes": nbytes}
        out[name]["share_of_library"] = (out[name]["library_device_us"]
                                         / out[name]["device_us"])
    fma.fma_f32_cuda.launches = saved
    return out


def ne_operands(m: int, batch: int, device, layout: str = "strided"):
    """A seeded problem for normal_equations: (jv, jw, j, wr) with
    ``batch`` lanes of ``m`` rows on ``device``, 90% of the rows valid,
    exponential weights; laid out as ``NE_LAYOUTS`` says."""
    import torch

    g = torch.Generator().manual_seed(1000 * m + batch)
    j = torch.randn(batch, m, 7, generator=g)
    valid = (torch.rand(batch, m, 1, generator=g) < 0.9).float()
    w = torch.rand(batch, m, 1, generator=g).exponential_(generator=g) * valid
    r = torch.randn(batch, m, generator=g)
    j = j.to(device)
    args = [j * valid.to(device), j * w.to(device), j,
            (w[..., 0] * r).to(device)]
    if layout == "strided":
        args[2] = j.transpose(1, 2).contiguous().transpose(1, 2)
    elif layout == "offset":
        for i, a in enumerate(args):
            buf = torch.empty(a.numel() + 1, device=device)
            args[i] = buf[1:].view(a.shape)
            args[i].copy_(a)
    return tuple(args)


def chain_floor_fmas(m: int) -> int:
    """The longest chain of dependent FMAs in the order the kernel keeps
    for ``m`` rows: a chunk of D and A, or b's longest path (the tiled
    loop's lanes; under 4,096 rows the vector loop's lanes, its epilogue
    and the scalar rows after it)."""
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd

    chunk = max(hi - lo for blk in xd.contraction_tree(m)[1]
                for lo, hi in blk)
    if m >= xd.GEMV_TILED_FROM:
        return max(chunk, m // 8)
    width, trips, unrolled, epilogue, etrips = xd.gemv_loop(m)
    if not width:
        return max(chunk, m)
    main = trips * (width // 8 if unrolled else 1)
    rest = m - trips * width - epilogue * etrips
    return max(chunk, main + etrips + rest)


def sm_clock_mhz() -> float:
    """The SM clock's maximum (``nvidia-smi --query-gpu=clocks.max.sm``),
    in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()
    return float(out[0])


def launch_floor(device_us_per_launch, host_us_per_call) -> dict:
    """The device time per launch (profiler, as the kernels' timings) and
    host time per call of PyTorch's spin kernel for 0 cycles, a kernel
    that reads the clock once and returns: what any launch costs."""
    import torch

    def launch():
        torch.cuda._sleep(0)

    dev_us, seen = device_us_per_launch(launch, SPIN_KERNEL, NE_LAUNCHES)
    return {"kernel": "torch.cuda._sleep(0)", "device_us": dev_us,
            "device_launches_seen": seen,
            "host_us": host_us_per_call(launch)}


def ne_phase(dev, ne) -> dict:
    """normal_equations against its plain version
    (``_xla_dot.normal_equations_plain``) on the card, bit for bit: the
    kernel's tree (``lidar_port::normal_equations_tree``) equal to
    ``contraction_tree`` for every row count up to ``NE_TREE_ROWS``;
    seeded problems at ``NE_ROWS`` rows at B = 1 and 8 (and 32 at the
    drives' rows), each lane also equal to its lone launch. The launches
    made here are not counted for any main path."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd

    def bits(x):
        return x.contiguous().view(torch.int32)

    import reference_cases as rc

    saved = ne.normal_equations_cuda.launches
    trees = [m for m in range(1, NE_TREE_ROWS + 1)
             if ne.tree(m).tolist() != [
                 [lo, hi, b] for b, blk in enumerate(xd.contraction_tree(m)[1])
                 for lo, hi in blk]]
    out = {"trees_compared": NE_TREE_ROWS, "trees_differ": trees[:10],
           "cases": {}}
    err = 0.0
    for m in NE_ROWS:
        for batch in (1, 8, 32) if m in (10240, 14336) else (1, 8):
            for layout in NE_LAYOUTS if batch < 32 else ("strided",):
                args = ne_operands(m, batch, dev, layout)
                got = ne.normal_equations_cuda(*args)
                want = xd.normal_equations_plain(*args)
                lone = ne.normal_equations_cuda(*(a[-1] for a in args))
                err = max(err, *(float((g - w).abs().max())
                                 for g, w in zip(got, want)))
                out["cases"][f"{m}x{batch}.{layout}"] = {
                    "equal": all(torch.equal(bits(g), bits(w))
                                 for g, w in zip(got, want)),
                    "lane_equals_lone": all(
                        torch.equal(bits(g[-1]), bits(x))
                        for g, x in zip(got, lone))}
    # The reference's own bits (the drive record, written from the JAX
    # package's jitted expressions): seeded problems at every recorded
    # row count, and the first update of the cut-width scenes.
    arrays, manifest = rc.load_drive()
    record = {}
    for m in (*rc.NE_SMALL_ROWS, *rc.NE_ROWS):
        got = ne.normal_equations_cuda(*(torch.as_tensor(a, device=dev)
                                         for a in rc.ne_problem(m)))
        record[str(m)] = all(
            torch.equal(bits(g), bits(torch.as_tensor(
                arrays[f"normal_equations.{m}.{k}"], device=dev)))
            for g, k in zip(got, "DAb"))
    for scene in rc.CUT_SCENES:
        got = rc.cut_normal_equations(
            *(arrays[f"cut.{scene}.{k}"] for k in (
                "jac_rows", "res_rows", "valid", "weights")),
            manifest["cut_updates"][scene]["shape"], device=dev.type)
        record[f"cut.{scene}"] = all(
            torch.equal(bits(g), bits(torch.as_tensor(
                arrays[f"cut.{scene}.{k}"], device=dev)))
            for g, k in zip(got, "DAb"))
    out["record_equal"] = record
    torch.cuda.synchronize()
    ne.normal_equations_cuda.launches = saved
    out["max_abs_err"] = err
    bad = {k: v for k, v in out["cases"].items() if not all(v.values())}
    check(not trees, f"normal_equations: trees differ at rows {trees[:10]}")
    check(not bad, f"normal_equations: differs from its plain version: {bad}")
    off = [k for k, v in record.items() if not v]
    check(not off, f"normal_equations: differs from the record at {off}")
    return out


def ne_timing(dev, ne, bound_us, device_us_per_launch,
              host_us_per_call) -> dict:
    """normal_equations timed on the card at the drives' row counts
    (10,240: faithful; 14,336: production), alone and as a batch of 32,
    and at 2,047 rows (the gradient's loop fusion), on row-major operands
    as the main path gives them: device time per launch (profiler; also
    with j column-major, read float by float), host time per call, the
    plain version's time and one ``torch.matmul`` of the stacked operands (``[jv | jw | j]^T
    [j | wr]``, a superset of D, A and b) by CUDA events, the bound (the
    operands read once and the 105 outputs written once at the memory
    rate, against 105 multiply-adds per row). ``ne_chain_floor`` gives
    each case's chain floor beside it."""
    import torch
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd

    saved = ne.normal_equations_cuda.launches
    out = {}
    for m, batch in ((2047, 1), (10240, 1), (14336, 1), (14336, 32)):
        # Row-major, as the main path's problems are (b's stages come in
        # by bulk copies); the column-major j's time beside it.
        args = ne_operands(m, batch, dev, "contiguous")
        strided = ne_operands(m, batch, dev, "strided")
        lhs = torch.cat(args[:3], dim=-1).transpose(-1, -2)
        rhs = torch.cat([args[2], args[3][..., None]], dim=-1)
        nbytes = 4 * batch * (m * (3 * 7 + 1) + 105)
        bound, by = bound_us(nbytes, 2 * 105 * m * batch)
        dev_us, seen = device_us_per_launch(
            lambda: ne.normal_equations_cuda(*args),
            "normal_equations_kernel", NE_LAUNCHES)
        out[f"{m}x{batch}"] = {
            "rows": m, "batch": batch, "device_us": dev_us,
            "device_launches_seen": seen,
            "strided_device_us": device_us_per_launch(
                lambda: ne.normal_equations_cuda(*strided),
                "normal_equations_kernel", NE_LAUNCHES)[0],
            "host_us": host_us_per_call(
                lambda: ne.normal_equations_cuda(*args)),
            "plain_ms": time_ms(lambda: xd.normal_equations_plain(*args),
                                reps=3, warmup=1),
            "library_ms": time_ms(lambda: torch.matmul(lhs, rhs)),
            "bound_us": bound, "bound_by": by, "bytes": nbytes}
    ne.normal_equations_cuda.launches = saved
    return out


def ne_chain_floor(times: dict) -> dict:
    """The order's chain floor of each case of ``ne_timing``: its
    longest chain's dependent FMAs (``chain_floor_fmas``) at an assumed
    ``FMA_LATENCY_CYCLES`` each and the SM clock's maximum. A computed
    figure, not a measurement."""
    mhz = sm_clock_mhz()
    out = {"fma_latency_cycles_assumed": FMA_LATENCY_CYCLES,
           "sm_clock_max_mhz": mhz}
    for case, t in times.items():
        fmas = chain_floor_fmas(t["rows"])
        out[case] = {"fmas": fmas,
                     "us": fmas * FMA_LATENCY_CYCLES / mhz}
    return out


def gn_counts(reset: bool = False) -> dict:
    """The launch counts of ``GN_KERNELS``' wrappers (then set to 0 with
    ``reset``)."""
    from lidar_feature_extraction_tpu_torch.ops import (
        gn_kernels_cuda, normal_equations_cuda)

    wrappers = {
        "normal_equations": normal_equations_cuda.normal_equations_cuda,
        "robust_weights": gn_kernels_cuda.robust_weights_cuda,
        "gn_update": gn_kernels_cuda.gn_update_cuda}
    out = {k: w.launches for k, w in wrappers.items()}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return out


def check_gn_counts(phase: str, counts: dict) -> None:
    """Each GN iteration of a phase launches each of ``GN_KERNELS`` once:
    equal counts, and at least one."""
    check(counts["normal_equations"] > 0
          and len(set(counts.values())) == 1,
          f"{phase}: GN kernels launched {counts} times; want one launch "
          f"of each per GN iteration")


def gn_kernels_phase(dev) -> dict:
    """``gn_update`` and ``robust_weights`` against their plain versions
    (``_xla_dot.gn_update_plain``, ``stats.robust_weights_plain``) on the
    card, bit for bit (a NaN against a NaN), on ``gn_kernels_check``'s
    seeded cases: normal equations of problems of ``gk.ROWS`` rows and
    errors of as many correspondences and of ``gk.EDGE_N`` (one, 33 and
    81,920), at B = 1, 8 and 32, the edge cases in a batch's first eight
    lanes (lane 7 of the errors on the first round's thresholds), and
    ``gk.RW_CLUSTER_CASES`` (one error past what each cluster size holds
    in shared memory); robust_weights with and without the block medians;
    every lane equal to its lone launch. The launches made here are not
    counted for any main path."""
    import torch
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
    from lidar_feature_extraction_tpu_torch.core import stats
    from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
        gn_update_cuda, robust_weights_cuda)

    saved = gn_counts()
    out = {"gn_update": {}, "robust_weights": {}}
    err = {"gn_update": 0.0, "robust_weights": 0.0}

    def abs_err(kernel, got, want):
        for g, w in zip(got, want):
            if g is not None and g.is_floating_point():
                d = (g.float() - w.float()).abs()
                d = d[torch.isfinite(d)]
                if d.numel():
                    err[kernel] = max(err[kernel], float(d.max()))

    def lanes_equal(got, lone, names):
        return all(v == 0 for v in gk.compare(got, lone, names).values())

    for m in gk.ROWS:
        for batch in gk.BATCHES:
            args = [torch.as_tensor(a, device=dev)
                    for a in gk.gn_update_case(m, batch)]
            got = gn_update_cuda(*args, gk.TAU)
            want = xd.gn_update_plain(*args, gk.TAU)
            abs_err("gn_update", got, want)
            lone = all(lanes_equal(
                [g[k] for g in got],
                gn_update_cuda(*(a[k] for a in args), gk.TAU),
                gk.GN_OUTPUTS) for k in range(batch))
            out["gn_update"][f"{m}x{batch}"] = {
                "differ": gk.compare(got, want, gk.GN_OUTPUTS),
                "lanes_equal_lone": lone}
    rw_cases = [(n, batch) for n in (*gk.ROWS, *gk.EDGE_N)
                for batch in gk.BATCHES] + list(gk.RW_CLUSTER_CASES)
    for n, batch in rw_cases:
        errors, valid, shape = gk.robust_weights_case(n, batch)
        errors = torch.as_tensor(errors, device=dev)
        valid = torch.as_tensor(valid, device=dev)
        for medians in (False, True):
            got = robust_weights_cuda(errors, valid, shape, gk.HUBER_K,
                                      medians)
            want = stats.robust_weights_plain(errors, valid, shape,
                                              gk.HUBER_K, medians)
            abs_err("robust_weights", got, want)
            lone = all(lanes_equal(
                [None if g is None else g[k] for g in got],
                robust_weights_cuda(errors[k], valid[k], shape, gk.HUBER_K,
                                    medians),
                gk.RW_OUTPUTS) for k in range(batch))
            out["robust_weights"][
                f"{n}x{batch}.{'loop' if medians else 'step'}"] = {
                "differ": gk.compare(got, want, gk.RW_OUTPUTS),
                "lanes_equal_lone": lone}
    torch.cuda.synchronize()
    for name, wrapper in (("robust_weights", robust_weights_cuda),
                          ("gn_update", gn_update_cuda)):
        wrapper.launches = saved[name]
    bad = {f"{k}.{case}": v for k, cases in out.items()
           for case, v in cases.items()
           if any(v["differ"].values()) or not v["lanes_equal_lone"]}
    check(not bad, f"gn kernels: differ from their plain versions: {bad}")
    out["max_abs_err"] = err
    out["cases"] = {k: len(v) for k, v in out.items() if k in err}
    return out


# csrc/gn_update.cu's IEEE divisions and square roots as ``cuobjdump -sass``
# shows their fast paths (sm_90a): a division is MUFU.RCP of the divisor
# and five dependent FFMAs, the numerator entering at the third from the
# end; a root is MUFU.RSQ, an FMUL and two FFMAs (beside them, a range
# check and a branch to the slow path). A count with each as one step
# understates the chain.
DIV_AFTER_DIVISOR, DIV_AFTER_NUMERATOR, ROOT_STEPS = 6, 3, 4


def _steps(sass: bool) -> tuple:
    """(steps after the divisor, after the numerator, of a root)."""
    return ((DIV_AFTER_DIVISOR, DIV_AFTER_NUMERATOR, ROOT_STEPS) if sass
            else (1, 1, 1))


def _factor_depth(n: int, start: int, fused: bool, sass: bool = False,
                  shuffle: int = 0) -> dict:
    """Depths (dependent operations from the start) of an unrolled
    Cholesky factor's entries l[i, j] of an n x n matrix whose entries are
    ready at ``start``: ``s - l l`` one step fused, two plain; a division
    and a root one step each, or their SASS lengths (``sass``); an
    off-diagonal entry reaches the other lanes ``shuffle`` steps later."""
    step = 1 if fused else 2
    after_divisor, after_numerator, root = _steps(sass)
    d = {}
    for i in range(n):
        for j in range(i + 1):
            s = start
            for k in range(j):
                s = max(s, d[i, k] + shuffle * (i != k),
                        d[j, k] + shuffle * (j != k)) + step
            d[i, j] = s + root if i == j else max(
                s + after_numerator, d[j, j] + after_divisor)
    return d


def gn_update_chain_ops(sass: bool = True, columns: bool = True) -> int:
    """The longest chain of dependent float operations in gn_update: the
    lift and the two products (1 + 7 + 7), then the fused 6 x 6 factor and
    its two substitutions, or beside it the plain 7 x 7 eigenvalue test
    (from the loads), then the pose update. A division or a root is one
    step, or (``sass``) its SASS length; ``columns`` counts this design's
    shuffles (a factor column's broadcast, the sine and cosine's exchange:
    one step each), without it the serial design (the solve, the test and
    the pose update each on one thread)."""
    after_divisor, after_numerator, root = _steps(sass)
    shuffle = 1 if columns else 0

    def div(n, d):
        return max(n + after_numerator, d + after_divisor)

    start = 15
    l = _factor_depth(6, start, True, sass, shuffle)
    y, s = [], [start] * 6
    for k in range(5):
        # This design divides y[k] in the factor's column k and shuffles it.
        y.append(div(s[k], l[k, k]) + shuffle)
        for i in range(k + 1, 6):
            s[i] = max(s[i], l[i, k] + shuffle, y[k]) + 1
    x = [0] * 6
    x[5] = div(s[5], l[5, 5] + 1)
    for i in reversed(range(5)):
        v = y[i]
        for k in range(i + 1, 6):
            v = max(v, l[k, i] + shuffle, x[k]) + 1
        x[i] = div(v, l[i, i])
    eig = max(_factor_depth(7, 1, False, sass, shuffle).values()) + 1
    # The guard (1); exp_so3: the sum of squares (3), the root, the branch
    # and the half angle (2), glibc's reduction and polynomial in float64
    # (12), the sine and cosine's exchange, the sine over the angle (a
    # division whose divisor is long ready), dq's vector (1); the fused
    # quaternion product (4), its norm (4, the root, the clamp 1) and the
    # division by it.
    pose = 1 + 3 + root + 2 + 12 + shuffle + after_numerator + 1 + 4 + 4 \
        + root + 1 + after_divisor
    return max(max(x), eig) + pose


def robust_weights_chain_ops(n: int, cluster: int) -> int:
    """The longest chain of dependent operations in robust_weights over one
    lane (or task) of ``n`` correspondences spread over ``cluster`` CTAs
    of 512 threads, on the path the seeded lanes take (rounds 2 and 3 from
    the candidates; each operation one step, a division, a shuffle, a
    shared or remote load; a barrier's hand-over not counted): the values'
    load (1); then two medians, each
    - its count and range: a thread's values one step each,
      ceil(n / (512 cluster)); 5 shuffles; the ranks' parts, one step
      each; 5 shuffles; the fold of the elements that are not valid (2);
    - round 1: the step w and its reciprocal (3), t_0 and t_255 (1), a
      value's bucket (sub, mul, ceil, sub, the walk's two fmas and
      compares: 8), the warp's bucket-0 count (1), the ranks' counts (one
      step each), a lane's running sum over 8 buckets (7), 5 shuffles,
      the compares and their count (2), the clamp (1), round 2's t_255
      and the candidates' bound (sub, div, fma, a shuffle, sub, compare:
      6), the next bounds (2);
    - the candidates: the compares (2) and the list's atomic (1); their
      counts' running sum over the ranks (5 shuffles and 1), the count
      at or below L (1);
    - rounds 2 and 3 alone: the step, t_0, t_255 and the check (4), a
      candidate's bucket (8), the atomic (1), the running sum (7), 5
      shuffles, the compares and count (2), the clamp (1), the next
      bounds (2);
    - its midpoint (2); the MAD's values |e - med| 2 steps more where they
      are read;
    then the scale (1) and one weight (add, div, clamp, the table's
    rsqrt: 2 bit steps, the load, the assembly and two Newton steps of 3,
    mul: 14). The error total runs beside them on other warps:
    reduce_sum's windows of 32 in order, 31 adds per level, and the last
    level's adds; the longer of the two chains."""
    per_thread = -(-n // (512 * cluster))
    count_range = per_thread + 5 + cluster + 5 + 2
    round_1 = 3 + 1 + 8 + 1 + cluster + 7 + 5 + 2 + 1 + 6 + 2
    candidates = 2 + 1 + 6 + 1
    local_round = 4 + 8 + 1 + 7 + 5 + 2 + 1 + 2
    median = count_range + round_1 + candidates + 2 * local_round + 2
    mad_values = 2 * 5  # where the MAD reads its values
    medians = 1 + 2 * median + mad_values + 1 + 14
    levels, left = 0, n
    while left > 32:
        left = -(-left // 32)
        levels += 1
    return max(medians, 31 * levels + left)


def gn_kernels_timing(dev, bound_us, device_us_per_launch,
                      host_us_per_call) -> dict:
    """``gn_update`` on the production rows' normal equations at B = 1
    and 32, and ``robust_weights`` on 10,240 correspondences (the
    faithful drive's) alone, with the block medians, and as a batch of
    32, and on 14,336 (the production rows') with the block medians:
    device time per launch (profiler), host time per call, the plain
    version's (CUDA events), the bytes bound (each operand read once, each
    output written once), robust_weights' cluster size and, computed, not
    measured, the chain floor: the longest chain of dependent float
    operations at an assumed ``FMA_LATENCY_CYCLES`` each and the SM
    clock's maximum (for gn_update each division and root at its SASS
    length, with the one-step count and the serial design's beside it)."""
    import torch
    import gn_kernels_check as gk
    from lidar_feature_extraction_tpu_torch.core import _xla_dot as xd
    from lidar_feature_extraction_tpu_torch.core import stats
    from lidar_feature_extraction_tpu_torch.ops import gn_kernels_cuda
    from lidar_feature_extraction_tpu_torch.ops.gn_kernels_cuda import (
        gn_update_cuda, robust_weights_cuda)

    saved = gn_counts()
    mhz = sm_clock_mhz()
    out = {"fma_latency_cycles_assumed": FMA_LATENCY_CYCLES,
           "sm_clock_max_mhz": mhz}
    for batch in (1, 32):
        args = [torch.as_tensor(a, device=dev)
                for a in gk.gn_update_case(14336, batch)]
        # D, A, b, q, t in; q, t, H, the two norms out.
        nbytes = 4 * batch * ((49 + 49 + 7 + 4 + 3) + (4 + 3 + 36 + 2))
        bound, by = bound_us(nbytes, 0)
        ops = gn_update_chain_ops()
        dev_us, seen = device_us_per_launch(
            lambda: gn_update_cuda(*args, gk.TAU), "gn_update_kernel",
            GN_LAUNCHES)
        # The same count with each division and root one step, and the
        # serial design's with the SASS lengths.
        counts = {"chain_ops_one_step_each": gn_update_chain_ops(False),
                  "chain_ops_serial_design": gn_update_chain_ops(
                      True, columns=False)}
        out[f"gn_update.{batch}"] = {
            "batch": batch, "device_us": dev_us,
            "device_launches_seen": seen,
            "host_us": host_us_per_call(
                lambda: gn_update_cuda(*args, gk.TAU)),
            "plain_ms": time_ms(lambda: xd.gn_update_plain(*args, gk.TAU),
                                reps=5, warmup=1),
            "bound_us": bound, "bound_by": by, "bytes": nbytes,
            "chain_ops": ops,
            "chain_floor_us": ops * FMA_LATENCY_CYCLES / mhz, **counts}
    for n, batch, medians in ((10240, 1, False), (10240, 1, True),
                              (10240, 32, True), (14336, 1, True)):
        errors, valid, shape = gk.robust_weights_case(n, batch)
        errors = torch.as_tensor(errors, device=dev)
        valid = torch.as_tensor(valid, device=dev)
        args = (errors, valid, shape, gk.HUBER_K, medians)
        # errors and flags in; weights, count, total, scale and the block
        # medians out.
        nbytes = batch * (n * (4 + 1 + 4) + 4 * (3 + medians * len(shape)))
        bound, by = bound_us(nbytes, 0)
        cluster = gn_kernels_cuda.cluster_size(batch,
                                               1 + medians * len(shape))
        ops = robust_weights_chain_ops(n, cluster)
        dev_us, seen = device_us_per_launch(
            lambda: robust_weights_cuda(*args), "robust_weights_kernel",
            GN_LAUNCHES)
        out[f"robust_weights.{n}x{batch}.{'loop' if medians else 'step'}"] \
            = {"n": n, "batch": batch, "block_medians": medians,
               "cluster": cluster,
               "device_us": dev_us, "device_launches_seen": seen,
               "host_us": host_us_per_call(lambda: robust_weights_cuda(
                   *args)),
               "plain_ms": time_ms(lambda: stats.robust_weights_plain(
                   *args), reps=5, warmup=1),
               "bound_us": bound, "bound_by": by, "bytes": nbytes,
               "chain_ops": ops,
               "chain_floor_us": ops * FMA_LATENCY_CYCLES / mhz}
    for name, wrapper in (("robust_weights", robust_weights_cuda),
                          ("gn_update", gn_update_cuda)):
        wrapper.launches = saved[name]
    return out


def lu_system(n: int, kind: str, device):
    """A seeded float32 system of order ``n``: ``spd`` is shaped like the
    pose graph's (J^T J over 2n random rows, plus the gauge prior 1e6 on
    the first 6 diagonal entries and the damping 1e-6 on the rest),
    ``random`` is a dense normal matrix (rows swap while it factors),
    ``ties`` holds integers in [-3, 3] (ties in the pivot column) and
    ``singular`` is normal with a zero column and a row twice another (a
    zero pivot: its solution is not finite)."""
    import torch

    rng = np.random.default_rng(n + LU_KINDS.index(kind) if kind != "spd"
                                else n)
    if kind == "spd":
        j = rng.normal(size=(2 * n, n))
        a = j.T @ j / (2 * n) + np.diag([1e6] * 6 + [1e-6] * (n - 6))
    elif kind == "ties":
        a = rng.integers(-3, 4, size=(n, n)).astype(np.float64)
    else:
        a = rng.normal(size=(n, n))
        if kind == "singular":
            a[:, n // 2] = 0.0
            a[n // 3] = 2.0 * a[0]
    b = rng.normal(size=n)
    return (torch.as_tensor(a, dtype=torch.float32, device=device),
            torch.as_tensor(b, dtype=torch.float32, device=device))


def lu_bits_equal(got, want) -> bool:
    """Bit for bit, a NaN equal to any NaN (the payload is the card's)."""
    import torch

    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(got)
    return bool(torch.equal(nan, torch.isnan(want)) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def lu_phase(dev, lu) -> dict:
    """lu_solve against its plain version, bit for bit: each of
    ``LU_KINDS`` at each of ``LU_SIZES``, the plain version on a CPU copy
    of the same inputs (``lu_solve_plain``; on the CPU its chains run in
    numpy), and at ``LU_BATCHED`` three systems in one launch against
    their lone launches. These launches are not counted."""
    import torch

    saved = lu.lu_solve_cuda.launches
    cases, worst = {}, 0.0
    for n in LU_SIZES:
        for kind in LU_KINDS:
            a, b = lu_system(n, kind, dev)
            got = lu.lu_solve_cuda(a, b)
            want = lu.lu_solve_plain(a.cpu(), b.cpu())
            torch.cuda.synchronize()
            equal = lu_bits_equal(got, want)
            both = torch.isfinite(got.cpu()) & torch.isfinite(want)
            err = float((got.cpu().double() - want.double())[both].abs()
                        .max()) if bool(both.any()) else 0.0
            worst = max(worst, err)
            cases[f"{kind}.{n}"] = {
                "bits_equal": equal, "max_abs_err": err,
                "finite": bool(torch.isfinite(got).all())}
            check(equal, f"lu_solve: {kind} n = {n} differs from its plain "
                         f"version by {err}")
            check(kind == "singular" or bool(torch.isfinite(got).all()),
                  f"lu_solve: {kind} n = {n} is not finite")
    lanes = {}
    for n in LU_BATCHED:
        systems = [lu_system(n, "spd", dev)[0] + 0.5 * k for k in range(3)]
        rhs = [lu_system(n, "random", dev)[1] * (k + 1) for k in range(3)]
        batch = lu.lu_solve_cuda(torch.stack(systems), torch.stack(rhs))
        lone = torch.stack([lu.lu_solve_cuda(a, b)
                            for a, b in zip(systems, rhs)])
        torch.cuda.synchronize()
        lanes[str(n)] = lu_bits_equal(batch, lone)
        check(lanes[str(n)], f"lu_solve: a batch's systems at n = {n} "
                             "differ from their lone launches")
    lu.lu_solve_cuda.launches = saved
    return {"sizes": list(LU_SIZES), "kinds": list(LU_KINDS),
            "max_abs_err": worst, "batch_lanes_equal": lanes,
            "cases": cases}


def lu_timing(dev, lu, bound_us, device_us_per_launch,
              host_us_per_call) -> dict:
    """lu_solve timed on the card at ``LU_SIZES`` on the pose-graph-shaped
    systems: device time per launch (profiler), host time per call,
    launches per solve, ``torch.linalg.solve_ex``'s time (cuSOLVER; used
    nowhere in the port) by CUDA events, the plain version's on a CPU copy
    (host clock, one call), and the bound (the matrix and right-hand side
    read once and the solution written once at the memory rate, against
    2n^3/3 float32 operations)."""
    import torch

    saved = lu.lu_solve_cuda.launches
    out = {}
    for n in LU_SIZES:
        a, b = lu_system(n, "spd", dev)
        nbytes = 4 * (n * n + 2 * n)
        bound, by = bound_us(nbytes, 2 * n ** 3 // 3)
        lu.lu_solve_cuda.launches = 0
        lu.lu_solve_cuda(a, b)
        per_solve = lu.lu_solve_cuda.launches
        dev_us, seen = device_us_per_launch(lambda: lu.lu_solve_cuda(a, b),
                                            "lu_solve_kernel", LU_LAUNCHES)
        a_cpu, b_cpu = a.cpu(), b.cpu()
        start = time.perf_counter()
        lu.lu_solve_plain(a_cpu, b_cpu)
        plain_ms = 1e3 * (time.perf_counter() - start)
        out[str(n)] = {
            "n": n, "device_us": dev_us, "device_launches_seen": seen,
            "launches_per_solve": per_solve,
            "host_us": host_us_per_call(lambda: lu.lu_solve_cuda(a, b),
                                        calls=20),
            "plain_ms": plain_ms, "plain_device": "cpu",
            "library_ms": time_ms(lambda: torch.linalg.solve_ex(a, b)),
            "bound_us": bound, "bound_by": by, "bytes": nbytes}
    lu.lu_solve_cuda.launches = saved
    return out


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from lidar_feature_extraction_tpu_torch.config import kitti_hdl64
    from lidar_feature_extraction_tpu_torch.ops import extraction as tex
    from lidar_feature_extraction_tpu_torch.ops import extraction_cuda as k1
    from lidar_feature_extraction_tpu_torch.ops import gauss_newton as gn
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        localize_scan)
    from lidar_feature_extraction_tpu_torch.ops import fma_cuda
    from lidar_feature_extraction_tpu_torch.ops import gn_kernels_cuda
    from lidar_feature_extraction_tpu_torch.ops import lu_cuda
    from lidar_feature_extraction_tpu_torch.ops import (
        normal_equations_cuda as ne_cuda)
    from k1_check import bound_us, check_and_time, k1_args, k1_work
    import reference_cases as rc

    # Full float32 everywhere: the compaction einsum must copy points
    # exactly, which TF32 would not.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build: one nvcc per kernel source, started together.
    from concurrent.futures import ThreadPoolExecutor

    start = time.perf_counter()
    builders = (k1, fma_cuda, ne_cuda, gn_kernels_cuda, lu_cuda)
    with ThreadPoolExecutor(len(builders)) as pool:
        libs = [f.result() for f in [pool.submit(b.build) for b in builders]]
    for b in builders:
        b.load()
    so, fma_so, ne_so, gn_so, lu_so = libs
    emit("build", seconds=time.perf_counter() - start, library=so.name,
         fma_library=fma_so.name, ne_library=ne_so.name,
         gn_kernels_library=gn_so.name, lu_library=lu_so.name)
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)

    # fma_f32 and normal_equations against their plain versions, bit for
    # bit.
    fma_check = fma_phase(dev, fma_cuda)
    emit("fma_f32", **fma_check)
    ne_check = ne_phase(dev, ne_cuda)
    emit("normal_equations", **ne_check)
    gn_check = gn_kernels_phase(dev)
    emit("gn_kernels", **gn_check)
    lu_check = lu_phase(dev, lu_cuda)
    emit("lu_solve", **lu_check)

    # 2. scenes
    cfg = kitti_hdl64()
    ex = cfg.extraction
    R, P = ex.n_rings, ex.max_points_per_ring
    start = time.perf_counter()
    bench_img, b_edge, b_surf = bench_scene(cfg, dev)
    bench_maps = build_maps(b_edge, b_surf, cfg)
    street_img, s_edge, s_surf = street_scene(cfg, dev)
    street_maps = build_maps(s_edge, s_surf, cfg)
    torch.cuda.synchronize()
    emit("scenes", seconds=time.perf_counter() - start, shape=[R, P],
         bench_map_points=len(b_edge) + len(b_surf),
         bench_map_edges=len(b_edge),
         street_map_points=len(s_edge) + len(s_surf),
         street_map_edges=len(s_edge))

    # 3. localize: the main path, counted.
    chains = {}
    k1.label_and_columns_cuda.launches = 0
    fma_cuda.fma_f32_cuda.launches = 0
    fma_cuda.fma_f32_cuda.sizes = {}
    gn_counts(reset=True)
    for scene, (maps, img) in (("bench", (bench_maps, bench_img)),
                               ("street", (street_maps, street_img))):
        for noisy in (False, True):
            chains[scene, noisy] = localize_chain(maps, img, cfg, noisy,
                                                  N_SCANS)
    torch.cuda.synchronize()
    launches = k1.label_and_columns_cuda.launches
    fma_launches = fma_cuda.fma_f32_cuda.launches
    fma_sizes = {"localize": fma_cuda.fma_f32_cuda.sizes}
    fma_cuda.fma_f32_cuda.sizes = None
    launches_by_phase = {"localize": launches}
    fma_by_phase = {"localize": fma_launches}
    gn_by_phase = {"localize": gn_counts()}
    n_scans = sum(len(c) for c in chains.values())
    check_gn_counts("localize", gn_by_phase["localize"])
    check(gn_by_phase["localize"]["normal_equations"] >= n_scans,
          f"localize: GN kernels launched {gn_by_phase['localize']} times "
          f"for {n_scans} scans")
    check(launches >= n_scans,
          f"localize: K1 launched {launches} times for {n_scans} scans")
    check(fma_launches >= n_scans,
          f"localize: fma_f32 launched {fma_launches} times for {n_scans} "
          f"scans")

    valid = (gn.CONVERGED, gn.MAX_ITERATIONS, gn.ERROR_INCREASED,
             gn.SCALE_INCREASED)
    plain_cfg = dataclasses.replace(
        cfg, extraction=dataclasses.replace(ex, pallas_labeling=False))
    for (scene, noisy), runs in chains.items():
        status = [int(r.status) for _, r, _ in runs]
        iters = [int(r.iterations) for _, r, _ in runs]
        t_err = [float(torch.linalg.vector_norm(r.pose.t)) for _, r, _ in runs]
        t_prior = [float(torch.linalg.vector_norm(p.t)) for (_, p), _, _ in
                   runs]
        finite = all(bool(torch.isfinite(r.pose.q).all())
                     and bool(torch.isfinite(r.pose.t).all())
                     for _, r, _ in runs)
        tag = f"localize {scene} {'noisy' if noisy else 'best'}"
        check(finite, f"{tag}: non-finite pose")
        check(all(s in valid for s in status), f"{tag}: status {status}")
        check(min(iters) >= 1, f"{tag}: iterations {iters}")
        if scene == "street" and not noisy:
            check(max(t_err) < 0.1, f"{tag}: |t| up to {max(t_err)} m")
        if scene == "street" and noisy:
            check(all(e <= p for e, p in zip(t_err, t_prior)),
                  f"{tag}: |t| {t_err} against priors {t_prior}")
        # Replay scan 0 through the plain extraction path.
        (im, prior), res, _ = runs[0]
        ref, _ = localize_scan(street_maps if scene == "street"
                               else bench_maps, im, prior, plain_cfg)
        same = (int(ref.status) == int(res.status)
                and int(ref.iterations) == int(res.iterations)
                and float((ref.pose.t - res.pose.t).abs().max()) <= 1e-6
                and float((ref.pose.q - res.pose.q).abs().max()) <= 1e-6)
        check(same, f"{tag}: K1 path and plain path disagree")
        ms = [m for _, _, m in runs]
        emit("localize", scene=scene, prior="noisy" if noisy else "best",
             scans=len(runs), ms_per_scan_mean=statistics.fmean(ms),
             ms_per_scan_median=statistics.median(ms),
             ms_first_scan=ms[0], gn_iterations_mean=statistics.fmean(iters),
             status_counts={str(s): status.count(s) for s in sorted(
                 set(status))},
             t_norm_max=max(t_err), t_norm_last=t_err[-1],
             within_0_1m=sum(e < 0.1 for e in t_err),
             prior_t_norm_mean=statistics.fmean(t_prior),
             plain_path_agrees=True,
             fma_sizes=fma_size_tally(fma_sizes["localize"]))
    torch.cuda.synchronize()

    # 4. drive: the closed loop of eval_ate.py, both configurations.
    from lidar_feature_extraction_tpu_torch.pipeline.localization import (
        build_feature_maps, build_geometry_maps)

    faithful = dataclasses.replace(
        cfg, compact_extraction=False,
        registration=dataclasses.replace(cfg.registration,
                                         refit_per_iteration=True))
    start = time.perf_counter()
    edges, surfs, scans, gt, twists, world, rng = rc.drive_inputs()
    drive_arrays, drive_manifest = rc.load_drive()
    check(rc.drive_inputs_sha256(edges, surfs, scans, gt, twists)
          == drive_manifest["inputs_sha256"],
          "drive: the worldsim draws differ from the drive record's inputs")
    scene_s = time.perf_counter() - start
    args = (torch.as_tensor(edges, dtype=torch.float32, device=dev),
            torch.ones(len(edges), dtype=torch.bool, device=dev),
            torch.as_tensor(surfs, dtype=torch.float32, device=dev),
            torch.ones(len(surfs), dtype=torch.bool, device=dev))
    maps, build_s = {}, {}
    for name, build, c in (("production", build_geometry_maps, cfg),
                           ("faithful", build_feature_maps, faithful)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        maps[name] = build(*args, c)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - start
    emit("drive_maps", worldsim_s=scene_s, scans=len(scans),
         points_per_scan=[len(p) for p, _ in scans],
         map_edge_points=len(edges), map_surface_points=len(surfs),
         build_geometry_maps_s=build_s["production"],
         build_feature_maps_s=build_s["faithful"])
    drive, last_scans, drive_poses = {}, {}, {}
    for name, c in (("production", cfg), ("faithful", faithful)):
        run, last_scans[name], drive_poses[name] = drive_run(
            maps[name], c, scans, twists, gt, dev, k1, fma_cuda)
        fma_sizes[f"drive {name}"] = run.pop("fma_sizes_raw")
        drive[name] = run
        limit = ATE_FACTOR * ATE_REFERENCE_M[name] + ATE_MARGIN_M
        # Against the JAX package's drive record: every scan's gaps, and
        # the held scans must have its status and iterations and
        # positions within rc.DRIVE_T_ATOL.
        poses = drive_poses[name]
        got = {"status": np.int32(run["gn_status"]),
               "iterations": np.int32(run["gn_iterations"]),
               "measured_t": poses[:, 4:7], "fused_t": poses[:, 11:14]}
        want = rc.drive_arrays(drive_arrays, name)
        held = DRIVE_HELD_SCANS[name]
        gaps_all = rc.drive_gaps(got, want, len(scans))
        gaps = rc.drive_gaps(got, want, held)
        emit("drive", config=name, ate_limit_m=limit,
             ate_reference_m=ATE_REFERENCE_M[name],
             record_ate_m=drive_manifest["drives"][name]["ate_rmse_m"],
             record_held_scans=held, record_gaps_held=gaps,
             record_gaps_all=gaps_all, **run)
        check(gaps["first_scan_that_differs"] is None
              and gaps["max_fused_t_gap_m"] <= rc.DRIVE_T_ATOL,
              f"drive {name}: leaves the record at scan "
              f"{gaps['first_scan_that_differs']} (gaps {gaps})")
        check(run["k1_launches"] >= run["scans"],
              f"drive {name}: K1 launched {run['k1_launches']} times for "
              f"{run['scans']} scans")
        check(run["fma_launches"] >= run["scans"],
              f"drive {name}: fma_f32 launched {run['fma_launches']} times "
              f"for {run['scans']} scans")
        fma_by_phase[f"drive {name}"] = run["fma_launches"]
        check_gn_counts(f"drive {name}", run["gn_launches"])
        check(run["gn_launches"]["normal_equations"] >= run["scans"],
              f"drive {name}: GN kernels launched {run['gn_launches']} "
              f"times for {run['scans']} scans")
        gn_by_phase[f"drive {name}"] = run["gn_launches"]
        check(run["finite"], f"drive {name}: non-finite pose")
        check(run["ate_rmse_m"] <= limit,
              f"drive {name}: ATE {run['ate_rmse_m']} m above {limit} m")
        launches += run["k1_launches"]
        launches_by_phase[f"drive {name}"] = run["k1_launches"]
    ratio = drive["production"]["ate_rmse_m"] / max(
        drive["faithful"]["ate_rmse_m"], 1e-9)
    emit("drive_ratio", production_over_faithful=ratio, limit=RATIO_LIMIT)
    check(ratio <= RATIO_LIMIT,
          f"drive: production / faithful ATE {ratio} above {RATIO_LIMIT}")

    # 5. odometry: bench_odometry.py's extracted-features chain.
    start = time.perf_counter()
    k1.label_and_columns_cuda.launches = 0
    frames, odom_gt = odometry_frames(cfg, dev)
    frames_s = time.perf_counter() - start
    odom, odom_last, odom_fields = odometry_chain(frames, odom_gt, cfg, dev)
    torch.cuda.synchronize()
    odom["k1_launches"] = k1.label_and_columns_cuda.launches
    drift_limit = ATE_FACTOR * ODOM_DRIFT_REFERENCE_M + ATE_MARGIN_M
    map_arrays, map_manifest = rc.load_mapping()
    frames_equal = rc.frames_sha256([torch.stack(f) for f in zip(*frames)]) \
        == map_manifest["odometry"]["frames_sha256"]
    odom_gaps = rc.odometry_gaps(odom_fields, map_arrays)
    emit("odometry", frames_s=frames_s, drift_limit_m=drift_limit,
         drift_reference_m=ODOM_DRIFT_REFERENCE_M,
         frames_equal_record=frames_equal,
         record_final_drift_m=map_manifest["odometry"]["final_drift_m"],
         record_mean_step_drift_m=map_manifest["odometry"][
             "mean_step_drift_m"], record_gaps=odom_gaps, **odom)
    check(frames_equal, "odometry: the frames differ from the mapping "
                        "record's")
    check(odom_gaps["first_frame_that_differs"] is None,
          f"odometry: frame {odom_gaps['first_frame_that_differs']} differs "
          f"from the mapping record")
    check(odom["finite"], "odometry: non-finite pose")
    check(odom["k1_launches"] >= odom["frames"],
          f"odometry: K1 launched {odom['k1_launches']} times for "
          f"{odom['frames']} frames")
    check(odom["mean_step_drift_m"] <= drift_limit,
          f"odometry: mean step drift {odom['mean_step_drift_m']} m above "
          f"{drift_limit} m")
    launches += odom["k1_launches"]
    launches_by_phase["odometry"] = odom["k1_launches"]
    del frames

    # 6. slam: eval_ate.py's two slam_loop drives, drawing on after the
    # drive's twists as eval_ate.py does.
    slam_runs, slam_ate = {}, {}
    slam_rng = copy.deepcopy(rng)   # the chunk phase draws slam_loop's scans
    lu_by_phase = {}
    record = map_manifest["slam"]
    check(rng.bit_generator.state == record["rng_state"],
          "slam: the generator differs from the mapping record's")
    for name, with_imu in (("slam_loop", False), ("slam_loop_imu", True)):
        recorder = None if with_imu else rc.MappingRecorder()
        lu_cuda.lu_solve_cuda.launches = 0
        run, pipeline, pair = slam_run(cfg, world, rng, with_imu, dev, k1,
                                       fma_cuda, recorder)
        lu_by_phase[name] = lu_cuda.lu_solve_cuda.launches
        slam_runs[name] = (pipeline, pair)
        slam_ate[name] = run["ate_rmse_m"]
        limit = ATE_FACTOR * SLAM_ATE_REFERENCE_M[name] + ATE_MARGIN_M
        held = {}
        if recorder is not None:
            # slam_loop against the mapping record, bit for bit: every
            # scan's odometry pose, the keyframes, the loop pairs, every
            # optimize()'s graph, the trajectory and the ATE.
            gaps = rc.mapping_gaps(recorder.fields(pipeline), map_arrays)
            loop_pairs = [[int(c[0]), int(c[1])] for c in
                          pipeline.constraints if c[1] - c[0] > 1]
            held = {"record_ate_m": record["ate_rmse_m"],
                    "ate_equal_record": run["ate_rmse_m"]
                    == record["ate_rmse_m"],
                    "features_equal_record": recorder.features
                    == record["features_sha256"],
                    "loop_pairs": loop_pairs,
                    "lu_solve_launches": lu_by_phase[name],
                    "record_gaps": gaps}
        emit("slam", run=name, ate_limit_m=limit,
             ate_reference_m=SLAM_ATE_REFERENCE_M[name], **held, **run)
        if recorder is not None:
            check(held["features_equal_record"],
                  f"{name}: the features differ from the mapping record's")
            check(gaps["first_scan_that_differs"] is None,
                  f"{name}: scan {gaps['first_scan_that_differs']}'s "
                  f"odometry pose differs from the mapping record")
            check(gaps["keyframes_equal"] and run["keyframes"]
                  == record["n_keyframes"],
                  f"{name}: the keyframes differ from the mapping record")
            check(loop_pairs == record["loop_pairs"],
                  f"{name}: loop pairs {loop_pairs}, the record's "
                  f"{record['loop_pairs']}")
            check(held["lu_solve_launches"] > 0,
                  f"{name}: the dense solve never launched lu_solve")
            check(gaps["first_optimize_that_differs"] is None,
                  f"{name}: optimize() "
                  f"{gaps['first_optimize_that_differs']}'s graph differs "
                  f"from the mapping record")
            check(gaps["max_trajectory_gap_m"] == 0.0,
                  f"{name}: the trajectory is up to "
                  f"{gaps['max_trajectory_gap_m']} m from the record's")
            check(held["ate_equal_record"],
                  f"{name}: ATE {run['ate_rmse_m']} m, the record's "
                  f"{record['ate_rmse_m']} m")
        check(run["finite"], f"{name}: non-finite keyframe pose or bias")
        check(run["k1_launches"] >= run["scans"],
              f"{name}: K1 launched {run['k1_launches']} times for "
              f"{run['scans']} scans")
        check(run["fma_launches"] >= run["scans"],
              f"{name}: fma_f32 launched {run['fma_launches']} times for "
              f"{run['scans']} scans")
        fma_by_phase[name] = run["fma_launches"]
        check(run["ate_rmse_m"] <= limit,
              f"{name}: ATE {run['ate_rmse_m']} m above {limit} m")
        check(abs(run["keyframes"] - SLAM_KEYFRAMES) <= SLAM_KEYFRAME_SLACK,
              f"{name}: {run['keyframes']} keyframes")
        check(run["loop_constraints"] >= 1, f"{name}: no loop constraint")
        launches += run["k1_launches"]
        launches_by_phase["slam" if not with_imu else "slam_imu"] = \
            run["k1_launches"]

    # 7. batch: the batched localizer at B = 1, 8, 32 on both scenes.
    gn_counts(reset=True)
    batch_launches, batch_later = batch_phase(
        {"bench": (bench_maps, bench_img), "street": (street_maps,
                                                       street_img)},
        cfg, dev, k1)
    gn_by_phase["batch"] = gn_counts()
    check_gn_counts("batch", gn_by_phase["batch"])
    launches += batch_launches
    launches_by_phase["batch"] = batch_launches

    # 8. kitti: the drive as a KITTI sequence through the entry points.
    kitti = kitti_run(edges, surfs, scans, gt, k1)
    kitti_limit = ATE_FACTOR * KITTI_ATE_REFERENCE_M + ATE_MARGIN_M
    emit("kitti", ate_limit_m=kitti_limit,
         ate_reference_m=KITTI_ATE_REFERENCE_M, **kitti)
    check(kitti["finite"], "kitti: non-finite fused pose")
    check(kitti["scans"] == DRIVE_SCANS
          and kitti["k1_launches"] >= kitti["scans"],
          f"kitti: K1 launched {kitti['k1_launches']} times for "
          f"{kitti['scans']} scans")
    check(kitti["ate_rmse_m"] <= kitti_limit,
          f"kitti: ATE {kitti['ate_rmse_m']} m above {kitti_limit} m")
    check(kitti["prefetched_scans_equal"] == DRIVE_SCANS,
          f"kitti: {kitti['prefetched_scans_equal']} of {DRIVE_SCANS} scans "
          f"read through ScanPrefetcher equal read_velodyne_bin's")
    launches += kitti["k1_launches"]
    launches_by_phase["kitti"] = kitti["k1_launches"]

    # 9. determinism: the production drive again on maps built again, and
    # every float scatter-add twice on this run's inputs (ROADMAP §C16).
    from lidar_feature_extraction_tpu_torch.core.pose import Pose
    from lidar_feature_extraction_tpu_torch.core.scan import (
        stack_range_images)
    from lidar_feature_extraction_tpu_torch.ops.extraction import (
        extract_features)
    from lidar_feature_extraction_tpu_torch.pipeline.replay import (
        scan_range_image)
    from lidar_feature_extraction_tpu_torch.utils import worldsim

    start = time.perf_counter()
    maps_again = build_geometry_maps(*args, cfg)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - start
    first = maps["production"]
    maps_equal = {name: torch.equal(a, b) for name, a, b in (
        ("edge", maps_again.edge.rec, first.edge.rec),
        ("surface", maps_again.surface.rec, first.surface.rec),
        ("fused", maps_again.fused, first.fused))}
    again, _, poses_again = drive_run(maps_again, cfg, scans, twists, gt, dev,
                                      k1, fma_cuda)
    feats8 = extract_features(stack_range_images(
        [scan_range_image(*scans[b], cfg, dev) for b in range(8)]), ex)
    sites = scatter_sites_twice(args, first, cfg, feats8)
    del feats8
    same_poses = bool(np.array_equal(poses_again, drive_poses["production"]))
    emit("determinism", build_geometry_maps_s=rebuild_s,
         maps_equal=maps_equal, poses_equal=same_poses,
         ate_rmse_m=again["ate_rmse_m"],
         first_ate_rmse_m=drive["production"]["ate_rmse_m"],
         gn_iterations=again["gn_iterations"],
         first_gn_iterations=drive["production"]["gn_iterations"],
         ms_per_scan_mean=again["ms_per_scan_mean"],
         ms_per_scan_median=again["ms_per_scan_median"],
         k1_launches=again["k1_launches"], scatter_sites_same_bits=sites)
    check(all(maps_equal.values()),
          f"determinism: maps built again differ: {maps_equal}")
    check(same_poses and again["ate_rmse_m"] == drive["production"][
        "ate_rmse_m"], "determinism: the production drive's poses differ "
                       "from its first run")
    check(all(sites.values()),
          f"determinism: scatter sites with other bits on a second call: "
          f"{[n for n, ok in sites.items() if not ok]}")
    launches += again["k1_launches"]
    launches_by_phase["determinism"] = again["k1_launches"]

    # 10. batch_full: the batched full-extraction branches on the drive's
    # scans, the faithful kNN variant over FeatureMaps and the full
    # extraction over GeometryMaps.
    full_geometry = dataclasses.replace(cfg, compact_extraction=False)
    bf_launches, bf_later = batch_full_phase(
        {"faithful_feature_maps": (maps["faithful"], faithful),
         "full_geometry_maps": (maps["production"], full_geometry)},
        scans, dev, k1)
    launches += bf_launches
    launches_by_phase["batch_full"] = bf_launches

    # 11. voxel_map: the hash map of the drive's map clouds against the
    # dense grids, on one drive scan's features at its true pose.
    mid = DRIVE_SCANS // 2
    truth = worldsim.straight_drive(mid)
    vmap = voxel_map_phase(args, maps["faithful"], faithful, scans[mid],
                           Pose(truth.q.float().to(dev),
                                truth.t.float().to(dev)), dev, k1)
    emit("voxel_map", scan=mid, **vmap)
    launches += vmap["k1_launches"]
    launches_by_phase["voxel_map"] = vmap["k1_launches"]

    # 12. multi: the batched localizer and the graph solvers sharded over
    # gloo ranks on the one card; a one-rank NCCL group.
    multi = multi_phase(k1)
    emit("multi", n_ranks=MULTI_RANKS, batch=MULTI_BATCH,
         solve_atol=SOLVE_ATOL, **multi)
    launches += multi["k1_launches"]
    launches_by_phase["multi"] = multi["k1_launches"]

    # 13. chunk: slam_loop's 80 scans through ChunkedMappingPipeline in
    # blocks of CHUNK_BLOCK, against the slam phase's per-scan run; then a
    # block with a dead scan.
    from lidar_feature_extraction_tpu_torch.utils.evaluation import ate_rmse

    start = time.perf_counter()
    chunk_images = chunk_scans(world, slam_rng, cfg, dev, SLAM_SCANS)
    scans_s = time.perf_counter() - start
    lu_cuda.lu_solve_cuda.launches = 0
    chunked, chunk_launches, block_ms, replayed = chunk_run(chunk_images,
                                                            cfg, k1)
    lu_by_phase["chunk"] = lu_cuda.lu_solve_cuda.launches
    per_scan = slam_runs["slam_loop"][0]
    n_blocks = len(block_ms)
    chunk_gt = np.stack([worldsim.circle_pose(
        round(kf.stamp / 0.1), SLAM_SCANS, 10.0).t.numpy()
        for kf in chunked.keyframes])
    same_shape = chunked.trajectory.shape == per_scan.trajectory.shape
    traj_err = float(np.abs(chunked.trajectory - per_scan.trajectory).max()) \
        if same_shape else float("inf")
    chunk_ate = ate_rmse(chunked.trajectory, chunk_gt, align=False)
    chunk_limit = ATE_FACTOR * SLAM_ATE_REFERENCE_M["slam_loop"] \
        + ATE_MARGIN_M
    ms_scan = [m / CHUNK_BLOCK for m in block_ms]
    suspect, suspect_launches, suspect_ms, suspect_replayed = chunk_run(
        chunk_images[:CHUNK_SUSPECT_SCANS], cfg, k1, dead=CHUNK_DEAD)
    dead_block = CHUNK_DEAD // CHUNK_BLOCK
    # The blocks the dead-scan run must replay: the dead scan's, and those
    # of its blocks that the clean run replayed (the same scans).
    want_replayed = sorted({dead_block} | {b for b in replayed
                                           if b < len(suspect_ms)})
    del chunk_images
    emit("chunk", scans=SLAM_SCANS, block=CHUNK_BLOCK, blocks=n_blocks,
         raycast_s=scans_s, k1_launches=chunk_launches,
         replayed_scans=chunked.replayed, replayed_blocks=replayed,
         replayed_gate=chunked.gate,
         keyframes=len(chunked.keyframes),
         per_scan_keyframes=len(per_scan.keyframes),
         constraints=len(chunked.constraints),
         per_scan_constraints=len(per_scan.constraints),
         trajectory_max_diff_m=traj_err, ate_rmse_m=chunk_ate,
         ate_limit_m=chunk_limit,
         per_scan_ate_rmse_m=slam_ate["slam_loop"],
         ms_per_scan_mean=statistics.fmean(ms_scan),
         ms_per_scan_median=statistics.median(ms_scan), ms_blocks=block_ms,
         suspect_run={"scans": CHUNK_SUSPECT_SCANS, "dead": CHUNK_DEAD,
                      "k1_launches": suspect_launches,
                      "replayed_scans": suspect.replayed,
                      "replayed_blocks": suspect_replayed,
                      "keyframes": len(suspect.keyframes),
                      "finite": bool(np.isfinite(suspect.trajectory).all()),
                      "ms_blocks": suspect_ms})
    # One launch per block, and one per scan of a block the odometry's
    # gate sent back to the host ladder (the per-scan run's ladder took
    # the same scans: the trajectories are held equal below).
    check(chunked.replayed == CHUNK_BLOCK * len(replayed)
          and chunk_launches == n_blocks + chunked.replayed,
          f"chunk: K1 launched {chunk_launches} times for {n_blocks} blocks "
          f"and {chunked.replayed} replayed scans (blocks {replayed})")
    check(len(chunked.keyframes) == len(per_scan.keyframes)
          and len(chunked.constraints) == len(per_scan.constraints),
          f"chunk: {len(chunked.keyframes)} keyframes, "
          f"{len(chunked.constraints)} constraints; per scan "
          f"{len(per_scan.keyframes)}, {len(per_scan.constraints)}")
    check(traj_err <= CHUNK_TRAJ_ATOL_M,
          f"chunk: trajectory {traj_err} m from the per-scan run's")
    check(chunk_ate <= chunk_limit,
          f"chunk: ATE {chunk_ate} m above {chunk_limit} m")
    check(suspect_replayed == want_replayed
          and suspect.replayed == CHUNK_BLOCK * len(want_replayed)
          and suspect_launches == len(suspect_ms) + suspect.replayed
          and bool(np.isfinite(suspect.trajectory).all()),
          f"chunk: the dead-scan run replayed blocks {suspect_replayed} "
          f"({suspect.replayed} scans, {suspect_launches} K1 launches); "
          f"want {want_replayed}")
    launches += chunk_launches + suspect_launches
    launches_by_phase["chunk"] = chunk_launches
    launches_by_phase["chunk_suspect"] = suspect_launches

    # 14. host: HostLocalizer over the localize phase's inputs and the
    # drive's FeatureMaps, against localize_scan.
    gn_counts(reset=True)
    host, host_later = host_phase(
        chains, {"bench": bench_maps, "street": street_maps}, cfg,
        maps["faithful"], faithful, scans, dev, k1)
    gn_by_phase["host"] = gn_counts()
    check_gn_counts("host", gn_by_phase["host"])
    emit("host", gn_launches=gn_by_phase["host"], **host)
    geo, feat = host["geometry_maps"], host["feature_maps"]
    check(host["k1_launches"] == host["scans"],
          f"host: K1 launched {host['k1_launches']} times for "
          f"{host['scans']} scans")
    check(geo["equal_to_localize_scan"] == geo["scans"],
          f"host: {geo['equal_to_localize_scan']} of {geo['scans']} "
          f"GeometryMaps results equal localize_scan's")
    check(feat["finite"] and feat["statuses_valid"],
          f"host: FeatureMaps poses finite {feat['finite']}, statuses "
          f"{feat['status_counts']}")
    check(feat["closer_than_prior"] == feat["scans"],
          f"host: FeatureMaps errors {feat['t_err_m']} against priors "
          f"{feat['prior_t_err_m']}")
    # The host loop reruns a round only where localize_scan's does.
    check(feat["more_rounds"] == 0
          and feat["same_rounds_equal"] == feat["same_rounds"],
          f"host: rounds {feat['host_rounds']} against localize_scan's "
          f"{feat['localize_scan_rounds']}, {feat['same_rounds_equal']} of "
          f"{feat['same_rounds']} with the same rounds equal")
    launches += host["k1_launches"]
    launches_by_phase["host"] = host["k1_launches"]

    # 15. reference: the card against the committed record of the JAX
    # package's results at full width, under both presets.
    ref = reference_phase(dev, k1)
    for case, fig in ref["cases"].items():
        emit("reference", case=case, **fig)
    emit("reference_total", seconds=ref["seconds"],
         k1_launches=ref["k1_launches"])
    launches += ref["k1_launches"]
    launches_by_phase["reference"] = ref["k1_launches"]

    # 16. k1 against its plain version at full width, on both scans, on
    # the bench scene's batches and on both scans under vlp16, and timed:
    # the first profiler sessions of the process.
    nbytes, flops = k1_work(R, P, ex.padding)
    bound, bound_by = bound_us(nbytes, flops)
    k1_runs = {}
    for scene, img in (("bench", bench_img), ("street", street_img)):
        args = k1_args(img.xyz, img.count, cfg)
        run = k1_runs[scene] = check_and_time(k1.label_and_columns_cuda,
                                              args, K1_LAUNCHES)
        run["plain_ms"] = time_ms(lambda: tex.label_and_columns_plain(*args))
        run["share_of_bound"] = bound / run["device_us"]
        emit("k1", scene=scene, shape=[R, P], labels_equal=True,
             curvature_equal=True, col_equal=True,
             launches_timed=K1_LAUNCHES, bound_us=bound, bound_by=bound_by,
             bytes=nbytes, flops=flops, **run)
    from lidar_feature_extraction_tpu_torch.core.scan import (
        stack_range_images)
    k1_batches = {}
    lanes, _ = batch_lanes(bench_img, max(BATCH_SIZES))
    for B in BATCH_SIZES[1:]:
        stacked = stack_range_images(lanes[:B])
        args = k1_args(stacked.xyz.flatten(0, 1), stacked.count.flatten(),
                       cfg)
        b_bytes, b_flops = k1_work(B * R, P, ex.padding)
        b_bound, b_by = bound_us(b_bytes, b_flops)
        run = k1_batches[B] = check_and_time(k1.label_and_columns_cuda,
                                             args, K1_LAUNCHES)
        run.update(bound_us=b_bound, bound_by=b_by,
                   share_of_bound=b_bound / run["device_us"],
                   device_us_per_scan=run["device_us"] / B)
        emit("k1", scene="bench batch", batch=B, shape=[B * R, P],
             labels_equal=True, curvature_equal=True, col_equal=True,
             launches_timed=K1_LAUNCHES, bytes=b_bytes, flops=b_flops, **run)

    import reference_cases as rc
    from lidar_feature_extraction_tpu_torch.pipeline import launch

    vlp16 = launch.load_config("vlp16")
    v_ex = vlp16.extraction
    v_bytes, v_flops = k1_work(v_ex.n_rings, v_ex.max_points_per_ring,
                               v_ex.padding)
    v_bound, v_by = bound_us(v_bytes, v_flops)
    k1_vlp16 = {}
    for scene in rc.SCENES:
        img = rc.port_image(f"vlp16/{scene}", vlp16, dev)
        args = k1_args(img.xyz, img.count, vlp16)
        run = k1_vlp16[scene] = check_and_time(k1.label_and_columns_cuda,
                                               args, K1_LAUNCHES)
        run["plain_ms"] = time_ms(lambda: tex.label_and_columns_plain(*args))
        run.update(bound_us=v_bound, bound_by=v_by,
                   share_of_bound=v_bound / run["device_us"])
        emit("k1", scene=scene, preset="vlp16",
             shape=[v_ex.n_rings, v_ex.max_points_per_ring],
             padding=v_ex.padding, nms_rounds=v_ex.nms_rounds,
             labels_equal=True, curvature_equal=True, col_equal=True,
             launches_timed=K1_LAUNCHES, bytes=v_bytes, flops=v_flops,
             nvidia_smi=smi, **run)

    # The drive's last scans once more, under the profiler.
    for name, last in last_scans.items():
        emit("drive_profile", config=name, **drive_profile(*last))

    # One odometry step, one closing registration and one optimize() of
    # each SLAM run's final graph, under the profiler.
    for prof in slam_profile(odom_last, slam_runs, cfg):
        emit("slam_profile", **prof)

    # One batch of each size on each scene, under the profiler.
    for scene, B, iters, fn in batch_later:
        _, prof = profile_call(fn)
        emit("batch_profile", scene=scene, batch=B, gn_iterations_max=iters,
             launches_per_gn_iteration=prof["launches"] / max(iters, 1),
             device_idle_share=1.0 - prof["device_busy_ms"]
             / prof["profiled_wall_ms"], **prof)

    # One batch of each size and branch of batch_full, under the profiler.
    for case, B, fn in bf_later:
        (_, its), prof = profile_call(lambda: gn_iterations_of(fn))
        emit("batch_full_profile", case=case, batch=B, gn_iterations=its,
             launches_per_gn_iteration=prof["launches"] / max(its, 1),
             device_idle_share=1.0 - prof["device_busy_ms"]
             / prof["profiled_wall_ms"], **prof)

    # One street scan through each localization driver, under the
    # profiler.
    for driver, fn in host_later:
        (res, _), prof = profile_call(fn)
        emit("host_profile", driver=driver, gn_iterations=int(res.iterations),
             launches_per_gn_iteration=prof["launches"] / max(
                 int(res.iterations), 1),
             device_idle_share=1.0 - prof["device_busy_ms"]
             / prof["profiled_wall_ms"], **prof)
    # The faithful kNN path (vlp16, FeatureMaps) on the reference phase's
    # street scan: one search round's fits, one GN iteration on frozen
    # fits, one that refits, and the whole registration.
    from profile_fits import fit_calls
    for call, fn in fit_calls("vlp16/street", dev)[0].items():
        _, prof = profile_call(fn)
        emit("host_profile", driver="host_feature_maps", case="vlp16/street",
             call=call, device_idle_share=1.0 - prof["device_busy_ms"]
             / prof["profiled_wall_ms"], **prof)

    from k1_check import device_us_per_launch, host_us_per_call
    main_sizes = {}
    for sizes in fma_sizes.values():
        for n, count in sizes.items():
            main_sizes[n] = main_sizes.get(n, 0) + count
    tallied = fma_size_tally(main_sizes)
    emit("fma_f32_sizes", phases=list(fma_sizes), **tallied)
    fma_times = fma_timing(dev, fma_cuda, bound_us, device_us_per_launch,
                           host_us_per_call, tallied["top"][0][0])
    emit("fma_f32_timing", nvidia_smi=smi, **fma_times)
    ne_times = ne_timing(dev, ne_cuda, bound_us, device_us_per_launch,
                         host_us_per_call)
    emit("normal_equations_timing", nvidia_smi=smi,
         chain_floor=ne_chain_floor(ne_times), **ne_times)
    gn_times = gn_kernels_timing(dev, bound_us, device_us_per_launch,
                                 host_us_per_call)
    emit("gn_kernels_timing", nvidia_smi=smi, **gn_times)
    lu_times = lu_timing(dev, lu_cuda, bound_us, device_us_per_launch,
                         host_us_per_call)
    emit("lu_solve_timing", nvidia_smi=smi, **lu_times)
    floor = launch_floor(device_us_per_launch, host_us_per_call)
    emit("launch_floor", nvidia_smi=smi, **floor)

    bench = k1_runs["bench"]
    fma_t = fma_times["1m"]
    ne_t = ne_times["10240x1"]
    gu_t = gn_times["gn_update.1"]
    lu_t = lu_times[str(LU_TIMED)]
    rw_t = gn_times["robust_weights.10240x1.loop"]

    def by_phase(kernel):
        return {p: c[kernel] for p, c in gn_by_phase.items()}
    print(json.dumps({"kernels": [{
        "name": "k1_label_and_columns", "route": "cuda",
        "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "launches_by_phase": launches_by_phase,
        "max_abs_err": max(r["max_abs_err"] for r in (
            *k1_runs.values(), *k1_batches.values(), *k1_vlp16.values())),
        "ms": bench["device_us"] / 1e3, "plain_ms": bench["plain_ms"],
        "bound_ms": bound / 1e3, "bound_by": bound_by,
        # No single PyTorch call computes labels + NMS + columns.
        "library_ms": None,
        "device_us": bench["device_us"],
        "device_launches_seen": bench["device_launches_seen"],
        "host_us": bench["host_us"],
        "bound_us": bound, "share_of_bound": bench["share_of_bound"],
        "shape": [R, P], "per_scan": k1_runs,
        "per_batch": {str(B): run for B, run in k1_batches.items()},
        "vlp16": {"shape": [v_ex.n_rings, v_ex.max_points_per_ring],
                  "per_scan": k1_vlp16}}, {
        "name": "fma_f32", "route": "cuda", "source": FMA_SOURCE,
        "replaces": FMA_REPLACES,
        "launches": sum(fma_by_phase.values()),
        "launches_by_phase": fma_by_phase,
        "max_abs_err": fma_check["max_abs_err"],
        "ms": fma_t["device_us"] / 1e3, "plain_ms": fma_t["plain_ms"],
        "bound_ms": fma_t["bound_us"] / 1e3, "bound_by": fma_t["bound_by"],
        # torch.addcmul(c, a, b): one PyTorch call of a * b + c, its
        # device time by the kernel's profiler method; it is used nowhere
        # in the port.
        "library_ms": fma_t["library_device_us"] / 1e3,
        # A near-empty kernel's device time per launch, to read
        # fma_f32's against.
        "launch_floor_ms": floor["device_us"] / 1e3,
        "timed": fma_times, "check": fma_check}, {
        "name": "normal_equations", "route": "cuda", "source": NE_SOURCE,
        "replaces": NE_REPLACES,
        "launches": sum(by_phase("normal_equations").values()),
        "launches_by_phase": by_phase("normal_equations"),
        "max_abs_err": ne_check["max_abs_err"],
        "ms": ne_t["device_us"] / 1e3, "plain_ms": ne_t["plain_ms"],
        "bound_ms": ne_t["bound_us"] / 1e3, "bound_by": ne_t["bound_by"],
        # One torch.matmul of the stacked operands computes D, A and b
        # (and more); it is used nowhere in the port.
        "library_ms": ne_t["library_ms"],
        "device_us": ne_t["device_us"], "host_us": ne_t["host_us"],
        "timed": ne_times, "check": {
            k: v for k, v in ne_check.items() if k != "cases"}}, *({
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(by_phase(name).values()),
        "launches_by_phase": by_phase(name),
        "max_abs_err": gn_check["max_abs_err"][name],
        "ms": t["device_us"] / 1e3, "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"],
        # No single PyTorch call computes either function.
        "library_ms": None,
        "device_us": t["device_us"], "host_us": t["host_us"],
        # What this run measured; the computed chain floor stays in the
        # gn_kernels_timing line.
        "timed": {k: {f: x for f, x in v.items() if f in GN_MEASURED}
                  for k, v in gn_times.items() if k.startswith(name + ".")},
        "cases_checked": gn_check["cases"][name]}
        for name, source, replaces, t in (
            ("gn_update", GU_SOURCE, GU_REPLACES, gu_t),
            ("robust_weights", RW_SOURCE, RW_REPLACES, rw_t))), {
        "name": "lu_solve", "route": "cuda", "source": LU_SOURCE,
        "replaces": LU_REPLACES,
        "launches": sum(lu_by_phase.values()),
        "launches_by_phase": lu_by_phase,
        "max_abs_err": lu_check["max_abs_err"],
        "ms": lu_t["device_us"] / 1e3, "plain_ms": lu_t["plain_ms"],
        "bound_ms": lu_t["bound_us"] / 1e3, "bound_by": lu_t["bound_by"],
        # torch.linalg.solve_ex (cuSOLVER) on the same system; it is used
        # nowhere on this path.
        "library_ms": lu_t["library_ms"],
        "device_us": lu_t["device_us"], "host_us": lu_t["host_us"],
        "timed": lu_times, "check": {
            k: v for k, v in lu_check.items() if k != "cases"}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
