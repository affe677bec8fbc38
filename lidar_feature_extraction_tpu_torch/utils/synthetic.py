"""Synthetic localization scenes, in numpy alone.

- The reference ``bench.py`` scene (``build_scene``, lines 32-99): a
  range image of piecewise range bands with discontinuities plus smooth
  arcs (``bench_scan``), and a map made of the scan's own features copied
  to 7 nearby keyframe poses with sensor noise (``keyframe_copies``).
  The copies disagree by up to 2 m, so the map is blurred and the
  registration optimum is not the identity.
- A street canyon (``street_world``, ``street_scan``): scans ray-cast
  from several keyframe poses in one consistent world, so a map built
  from their features has the scan's true pose as its optimum.
"""

from __future__ import annotations

import numpy as np


def bench_scan(rng: np.random.Generator, n_rings: int,
               n_points: int) -> np.ndarray:
    """float32 [n_rings, n_points, 3] scan; every lane is valid."""
    n_seg = 48
    az = np.sort(rng.uniform(-np.pi, np.pi, size=(n_rings, n_points)),
                 axis=-1)
    elev = np.radians(np.linspace(2.0, -24.8, n_rings))[:, None]
    seg_base = rng.uniform(8.0, 20.0, size=(n_rings, n_seg))
    seg_of = np.minimum((az + np.pi) / (2 * np.pi) * n_seg,
                        n_seg - 1).astype(int)
    rr = (np.take_along_axis(seg_base, seg_of, axis=1)
          + 0.5 * np.sin(7 * az) + rng.normal(scale=0.01, size=az.shape))
    xy = rr * np.cos(elev)
    xyz = np.stack([xy * np.cos(az), xy * np.sin(az), rr * np.sin(elev)],
                   axis=-1)
    return xyz.astype(np.float32)


def street_world(rng: np.random.Generator):
    """A street canyon: ground 1.73 m below the sensor, building fronts
    at y = +/-15 m, far walls at x = +/-60 m, 24 poles (radius 0.15 m)
    along both sidewalks and 10 parked cars (boxes 4.2 x 1.8 x 1.5 m)
    along both kerbs. (A narrower street puts most ground neighbourhoods
    next to a wall, and the plane fits there bias the registration.)"""
    n_poles, n_cars, half_width = 24, 10, 15.0
    px = rng.uniform(-35.0, 35.0, size=n_poles)
    py = np.where(rng.random(n_poles) < 0.5, -1.0, 1.0) \
        * (half_width - 2.0 + rng.uniform(-0.5, 0.5, size=n_poles))
    cx = rng.uniform(-30.0, 30.0, size=n_cars)
    cy = np.where(rng.random(n_cars) < 0.5, -1.0, 1.0) * (half_width - 3.8)
    cars = np.stack([cx - 2.1, cx + 2.1, cy - 0.9, cy + 0.9], -1)
    return dict(poles=np.stack([px, py], -1), cars=cars,
                half_width=half_width)


def street_scan(world, rng: np.random.Generator, n_rings: int,
                n_points: int, origin=(0.0, 0.0), yaw: float = 0.0,
                noise: float = 0.01) -> np.ndarray:
    """float32 [n_rings, n_points, 3] HDL-64-like scan of ``street_world``
    in the sensor frame, taken from ``origin`` (x, y) with heading
    ``yaw``: one ray per lane over 2.0 .. -24.8 degrees of elevation and
    ``noise`` metres of range noise. Every lane hits a surface."""
    az = np.sort(rng.uniform(-np.pi, np.pi, size=(n_rings, n_points)),
                 axis=-1)
    elev = np.radians(np.linspace(2.0, -24.8, n_rings))[:, None]
    dx = np.cos(elev) * np.cos(az + yaw)
    dy = np.cos(elev) * np.sin(az + yaw)
    dz = np.broadcast_to(np.sin(elev), az.shape)
    ox, oy = origin

    def ahead(t):
        return np.where(t > 1e-6, t, np.inf)

    with np.errstate(divide="ignore", invalid="ignore"):
        t = ahead(-1.73 / dz)                              # ground
        for wall in (60.0, -60.0):
            t = np.minimum(t, ahead((wall - ox) / dx))
        for wall in (world["half_width"], -world["half_width"]):
            t = np.minimum(t, ahead((wall - oy) / dy))
        for cx, cy in world["poles"]:                      # cylinders
            fx, fy = ox - cx, oy - cy
            a = dx * dx + dy * dy
            b = 2 * (fx * dx + fy * dy)
            c = fx * fx + fy * fy - 0.15 ** 2
            disc = b * b - 4 * a * c
            tp = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
            t = np.minimum(t, np.where(disc >= 0, ahead(tp), np.inf))
        for x0, x1, y0, y1 in world["cars"]:               # slab test
            lo, hi = [], []
            for o, dd, a0, a1 in ((ox, dx, x0, x1), (oy, dy, y0, y1),
                                  (0.0, dz, -1.73, -0.23)):
                t0, t1 = (a0 - o) / dd, (a1 - o) / dd
                lo.append(np.minimum(t0, t1))
                hi.append(np.maximum(t0, t1))
            near, far = np.maximum.reduce(lo), np.minimum.reduce(hi)
            hit = (near <= far) & (near > 1e-6)
            t = np.minimum(t, np.where(hit, near, np.inf))
    t = t + rng.normal(scale=noise, size=t.shape)
    wx, wy = t * dx, t * dy                 # world-aligned, from origin
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([c * wx + s * wy, -s * wx + c * wy, t * dz],
                    -1).astype(np.float32)


def to_world(pts: np.ndarray, origin=(0.0, 0.0), yaw: float = 0.0):
    """Sensor-frame points [N, 3] of a scan taken at ``origin``/``yaw``
    in the world frame."""
    c, s = np.cos(yaw), np.sin(yaw)
    x = c * pts[:, 0] - s * pts[:, 1] + origin[0]
    y = s * pts[:, 0] + c * pts[:, 1] + origin[1]
    return np.stack([x, y, pts[:, 2]], -1)


def keyframe_copies(rng: np.random.Generator, pts: np.ndarray) -> np.ndarray:
    """float64 [7 * N, 3]: ``pts`` at 7 keyframe poses (copy 0 at the
    identity, the others within +/-2 m and +/-0.02 rad of yaw) with 1 cm
    of sensor noise."""
    out = []
    for k in range(7):
        yaw = 0.0 if k == 0 else rng.uniform(-0.02, 0.02)
        off = np.zeros(3) if k == 0 else rng.uniform(-2.0, 2.0, size=3) \
            * np.array([1.0, 1.0, 0.05])
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0],
                        [0, 0, 1.0]])
        out.append(pts @ rot.T + off
                   + rng.normal(scale=0.01, size=pts.shape))
    return np.concatenate(out)
