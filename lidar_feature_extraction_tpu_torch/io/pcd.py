"""Minimal PCD (point cloud data) reader/writer.

Numpy copy of ``lidar_feature_extraction_tpu/io/pcd.py`` (the port
imports nothing of the JAX package): the reference's PCL-based map
persistence (``map.hpp:135-148`` saves, ``map_loader.cpp:44-49`` loads),
ascii and binary encodings with x/y/z (+ optional extra float fields).
"""

from __future__ import annotations

import numpy as np

_DTYPES = {("F", 4): np.float32, ("F", 8): np.float64,
           ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
           ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}


def load_pcd(path: str) -> np.ndarray:
    """Load a PCD file; returns [N, 3] float32 xyz."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, value = line.partition(" ")
            header[key] = value
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        data_kind = header["DATA"]

        np_fields = []
        for name, size, typ, cnt in zip(fields, sizes, types, counts):
            dt = _DTYPES[(typ, size)]
            if cnt == 1:
                np_fields.append((name, dt))
            else:
                np_fields.append((name, dt, (cnt,)))
        dtype = np.dtype(np_fields)

        if data_kind == "ascii":
            body = np.loadtxt(f, max_rows=n)
            body = np.atleast_2d(body)
            xyz_idx = [fields.index(c) for c in "xyz"]
            return body[:, xyz_idx].astype(np.float32)
        if data_kind == "binary":
            raw = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype)
            return np.stack([raw["x"], raw["y"], raw["z"]],
                            axis=-1).astype(np.float32)
        raise ValueError(f"unsupported PCD DATA kind: {data_kind}")


def save_pcd(path: str, xyz: np.ndarray, binary: bool = True) -> None:
    """Write [N, 3] points as a PCD v0.7 file."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    n = len(xyz)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(xyz.tobytes())
        else:
            np.savetxt(f, xyz, fmt="%.8g")
