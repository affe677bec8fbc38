"""Host-side EKF plumbing: measurement queues, timing, marshalling and
diagnostics.

A copy of ``lidar_feature_extraction_tpu/fusion/queues.py`` (numpy and
the standard library only): the port imports nothing of the JAX
package, whose ``__init__`` loads JAX.

The numerical EKF lives in ``fusion/ekf.py`` as device tensor code;
this module carries the reference node's host machinery so an
asynchronous deployment (``pipeline/ekf_node.py``) matches the
reference's behavior:

- ``AgedMessageQueue`` — pose/twist measurements are retried for
  ``smoothing_steps`` timer ticks before being discarded
  (``ekf_localizer/include/ekf_localizer/aged_message_queue.hpp:21-66``);
- ``UpdateInterval`` — measured predict dt with jump-back protection
  (``ekf_localizer/src/update_interval.cpp:22-40``);
- ``delay_step`` — measurement delay quantized to predict ticks
  (``pose_measurement.cpp:84-92``);
- covariance marshalling between the 6x6 EKF blocks and the flat
  36-entry row-major pose/twist covariance layout used at the module
  boundary (``ekf_localizer/src/covariance.cpp:22-59``; the ROS
  message's covariance array, kept as the interchange format so
  recorded reference data plugs straight in);
- ``Warning`` — throttled warning sink
  (``ekf_localizer/include/ekf_localizer/warning.hpp:24-58``);
- the ``Check*`` family — NaN/Inf and delay-time gates with throttled
  messages (``ekf_localizer/src/check.cpp:22-113``).
"""

from __future__ import annotations

import math
import time as _time
from collections import deque
from typing import Callable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Aged message queue


class AgedMessageQueue:
    """FIFO of (message, age) pairs with bounded retries.

    Parity with ``AgedMessageQueue`` (aged_message_queue.hpp:21-66):
    ``pop_increment_age`` drains the queue, returning every message and
    re-enqueueing those younger than ``max_age`` with age+1 — a
    measurement that keeps failing its gates is retried for
    ``max_age`` (= smoothing steps) ticks then dropped.
    """

    def __init__(self, max_age: int):
        self.max_age = max_age
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, msg) -> None:
        self._q.append((msg, 0))

    def pop_increment_age(self) -> list:
        """Return all queued messages; keep (aged) copies of those that
        have not yet exceeded ``max_age`` ticks."""
        out = []
        n = len(self._q)
        for _ in range(n):
            msg, age = self._q.popleft()
            out.append(msg)
            if age + 1 < self.max_age:
                self._q.append((msg, age + 1))
        return out

    def clear(self) -> None:
        self._q.clear()


# ---------------------------------------------------------------------------
# Predict timing


class UpdateInterval:
    """Measured predict interval with time-jump-back protection.

    Parity with ``UpdateInterval::Compute`` (update_interval.cpp:22-40):
    the first call returns the nominal 1/frequency; later calls return
    the measured gap, and a clock that jumps backwards resets the
    estimator instead of producing a negative dt.
    """

    def __init__(self, frequency: float):
        self.default_dt = 1.0 / frequency
        self._last: Optional[float] = None

    def compute(self, now: float) -> float:
        if self._last is not None and now < self._last:
            self._last = None  # jump back: reset
        if self._last is None:
            self._last = now
            return self.default_dt
        dt = now - self._last
        self._last = now
        return dt if dt > 0.0 else self.default_dt


def delay_step(delay_time: float, dt: float, extend_state_step: int,
               warn: Optional["Warning"] = None) -> Optional[int]:
    """Quantize a measurement delay to predict ticks.

    Parity with the delay handling of ``PoseMeasurement::Update``
    (pose_measurement.cpp:84-97): negative delays clamp to zero with a
    warning; delays beyond the augmented-state horizon return None (the
    C++ ``continue``) with a warning.
    """
    if delay_time < 0.0:
        if warn is not None:
            warn.warn_throttle(
                f"measurement time stamp is inappropriate, set delay to 0; "
                f"delay = {delay_time:.3f}", 1.0)
        delay_time = 0.0
    step = int(round(delay_time / dt)) if dt > 0 else 0
    if step >= extend_state_step:
        if warn is not None:
            warn.warn_throttle(
                f"delay exceeds the compensation limit, ignored; delay = "
                f"{delay_time:.3f}, limit = {extend_state_step * dt:.3f}",
                1.0)
        return None
    return step


# ---------------------------------------------------------------------------
# Covariance marshalling (6x6 EKF blocks <-> flat 36 row-major layout)

_POSE_IDX = {(0, 0): 0, (0, 1): 1, (0, 5): 5,
             (1, 0): 6, (1, 1): 7, (1, 5): 11,
             (5, 0): 30, (5, 1): 31, (5, 5): 35}


def ekf_covariance_to_pose_covariance(p: np.ndarray) -> np.ndarray:
    """EKF P (x, y, yaw block) -> flat 36 pose covariance.

    Parity: ``EKFCovarianceToPoseMessageCovariance`` (covariance.cpp:
    22-39) — x/y/yaw variances and cross terms land in the (x, y, rz)
    slots of the 6x6 row-major pose layout.
    """
    out = np.zeros(36, dtype=np.float64)
    src = {(0, 0): (0, 0), (0, 1): (0, 1), (0, 5): (0, 2),
           (1, 0): (1, 0), (1, 1): (1, 1), (1, 5): (1, 2),
           (5, 0): (2, 0), (5, 1): (2, 1), (5, 5): (2, 2)}
    for dst_key, (i, j) in src.items():
        out[_POSE_IDX[dst_key]] = p[i, j]
    return out


def ekf_covariance_to_twist_covariance(p: np.ndarray) -> np.ndarray:
    """EKF P (vx, wz block, state rows 4/5) -> flat 36 twist covariance.

    Parity: ``EKFCovarianceToTwistMessageCovariance`` (covariance.cpp:
    41-59) — vx/wz variances and cross terms in the (x, rz) slots.
    """
    out = np.zeros(36, dtype=np.float64)
    out[0] = p[4, 4]
    out[5] = p[4, 5]
    out[30] = p[5, 4]
    out[35] = p[5, 5]
    return out


def pose_covariance_to_measurement_r(cov: np.ndarray,
                                     smoothing_steps: int) -> np.ndarray:
    """Flat 36 pose covariance -> 3x3 (x, y, yaw) measurement R scaled by
    the smoothing steps (parity: ``PoseMeasurementCovariance``,
    pose_measurement.cpp:47-55)."""
    c = np.asarray(cov, dtype=np.float64).reshape(6, 6)
    idx = [0, 1, 5]
    return c[np.ix_(idx, idx)] * float(smoothing_steps)


def twist_covariance_to_measurement_r(cov: np.ndarray,
                                      smoothing_steps: int) -> np.ndarray:
    """Flat 36 twist covariance -> 2x2 (vx, wz) measurement R scaled by
    the smoothing steps (parity: ``TwistMeasurementCovariance``,
    twist_measurement.cpp:45-53)."""
    c = np.asarray(cov, dtype=np.float64).reshape(6, 6)
    idx = [0, 5]
    return c[np.ix_(idx, idx)] * float(smoothing_steps)


# ---------------------------------------------------------------------------
# Throttled warnings + checks


class Warning:
    """Throttled warning sink (warning.hpp:24-58). ``sink`` defaults to
    print; tests inject a recorder. Throttling is per-message-text like
    rclcpp's throttle macros are per-call-site."""

    def __init__(self, sink: Callable[[str], None] = None,
                 clock: Callable[[], float] = _time.monotonic):
        self._sink = sink if sink is not None else (
            lambda m: print(f"[ekf warning] {m}"))
        self._clock = clock
        self._last: dict[str, float] = {}

    def warn(self, message: str) -> None:
        self._sink(message)

    def warn_throttle(self, message: str, period_s: float) -> None:
        now = self._clock()
        last = self._last.get(message)
        if last is not None and now - last < period_s:
            return
        self._last[message] = now
        self._sink(message)


def check_measurement_finite(values, name: str,
                             warn: Optional[Warning] = None) -> bool:
    """NaN/Inf gate on a measurement vector (check.cpp:93-113)."""
    arr = np.asarray(values, dtype=np.float64)
    if np.all(np.isfinite(arr)):
        return True
    if warn is not None:
        kind = "NaN" if np.any(np.isnan(arr)) else "Inf"
        warn.warn(f"{name} measurement matrix includes {kind}, ignored")
    return False


def check_measurement_delay(delay_time: float, dt: float,
                            extend_state_step: int,
                            warn: Optional[Warning] = None) -> bool:
    """Delay-within-horizon gate (check.cpp:55-76 semantics)."""
    return delay_step(delay_time, dt, extend_state_step, warn) is not None


def check_frame(frame_id: str, expected: str,
                warn: Optional[Warning] = None) -> bool:
    """Frame-id gate (``CheckFrameId``, check.cpp:22-33)."""
    if frame_id == expected:
        return True
    if warn is not None:
        warn.warn_throttle(
            f"frame_id is {frame_id}, but expected {expected}; ignored",
            2.0)
    return False


def check_mahalanobis(md2: float, gate_dist: float,
                      warn: Optional[Warning] = None) -> bool:
    """Host-side Mahalanobis gate mirror (``MahalanobisGate``,
    mahalanobis.cpp:28-33) for pipelines that gate before dispatching a
    device update."""
    if not math.isfinite(md2):
        return False
    if md2 <= gate_dist * gate_dist:
        return True
    if warn is not None:
        warn.warn_throttle(
            f"measurement exceeds the Mahalanobis gate "
            f"(d^2 = {md2:.2f} > {gate_dist ** 2:.2f}), ignored", 2.0)
    return False
