"""Raw float32 scan reads and a threaded read-ahead over scan files.

Port of ``lidar_feature_extraction_tpu/io/native_io.py`` without its
C++ shim: the read-ahead is a ``concurrent.futures.ThreadPoolExecutor``
over ``np.fromfile``, which releases the GIL while it reads, so the
files of the scans ahead load while the caller works on the current
one. Host I/O: everything here is numpy, as in ``io/kitti.py``.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np


def read_f32(path: str) -> np.ndarray:
    """Read a raw float32 file (KITTI .bin layout). A missing file
    raises ``FileNotFoundError``."""
    return np.fromfile(path, dtype=np.float32)


class ScanPrefetcher:
    """Threaded read-ahead over an ordered list of scan files: ``get(i)``
    returns scan ``i``'s float32 contents and keeps the reads of scans up
    to ``i + lookahead`` in flight."""

    def __init__(self, paths: list[str], n_threads: int = 4,
                 lookahead: int = 8):
        self.paths = paths
        self.lookahead = lookahead
        self._pool = ThreadPoolExecutor(max_workers=n_threads)
        self._pending: dict[int, Future] = {}
        self._next_submit = 0
        self._fill(0)

    def _fill(self, upto_index: int):
        while (self._next_submit < len(self.paths)
               and self._next_submit <= upto_index + self.lookahead):
            self._pending[self._next_submit] = self._pool.submit(
                read_f32, self.paths[self._next_submit])
            self._next_submit += 1

    def get(self, index: int) -> np.ndarray:
        """Float32 contents of scan ``index``; triggers read-ahead. A
        failed read raises ``IOError`` naming the file."""
        self._fill(index)
        read = self._pending.pop(index, None)
        if read is None:   # taken before: read it again
            read = self._pool.submit(read_f32, self.paths[index])
        try:
            return read.result()
        except OSError as err:
            raise IOError(f"prefetch failed: {self.paths[index]}") from err

    def close(self):
        """Stop the workers; reads not started are dropped."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self._pending.clear()

    def __del__(self):
        self.close()
