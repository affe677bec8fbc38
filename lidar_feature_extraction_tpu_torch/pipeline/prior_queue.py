"""Timestamp-sorted prior-pose queue.

A copy of ``lidar_feature_extraction_tpu/pipeline/prior_queue.py``
(standard library only), which the port cannot import.

Parity with ``StampSortedObjects`` (``localization/include/
lidar_feature_localization/stamp_sorted_objects.hpp:38-108``): the
localization node keeps EKF odometry poses keyed by stamp and hands the
closest one to each incoming scan as the Gauss-Newton prior. Python's
sorted-dict-free equivalent uses bisect over parallel lists; no mutex —
the replay drivers are single-threaded, and a threaded deployment wraps
access in one lock at the call site.
"""

from __future__ import annotations

import bisect
from typing import Any, Optional


class PriorPoseQueue:
    def __init__(self):
        self._stamps: list[float] = []
        self._objects: list[Any] = []

    def __len__(self) -> int:
        return len(self._stamps)

    def insert(self, stamp: float, obj: Any) -> None:
        """Insert keeping stamps sorted (duplicates replace — the C++
        std::map semantics)."""
        i = bisect.bisect_left(self._stamps, stamp)
        if i < len(self._stamps) and self._stamps[i] == stamp:
            self._objects[i] = obj
            return
        self._stamps.insert(i, stamp)
        self._objects.insert(i, obj)

    def get_closest(self, stamp: float) -> Optional[tuple[float, Any]]:
        """(stamp, obj) minimizing |stamp difference| — lower_bound plus
        one-step comparison (stamp_sorted_objects.hpp:52-84)."""
        if not self._stamps:
            return None
        i = bisect.bisect_left(self._stamps, stamp)
        if i == 0:
            return self._stamps[0], self._objects[0]
        if i == len(self._stamps):
            return self._stamps[-1], self._objects[-1]
        before = stamp - self._stamps[i - 1]
        after = self._stamps[i] - stamp
        j = i - 1 if before <= after else i
        return self._stamps[j], self._objects[j]

    def remove_older_than(self, stamp: float) -> None:
        """Drop all entries with stamp < given (hpp:86-104)."""
        i = bisect.bisect_left(self._stamps, stamp)
        del self._stamps[:i]
        del self._objects[:i]
