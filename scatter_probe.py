"""Probe, on a CUDA card, the two facts the port's float sums rest on:

1. which scatter-add gives the same bits from one call to the next:
   ``index_add_`` (atomics) against ``index_put_(accumulate=True)``
   (a sort by destination, then a sum per destination), on 400,000 rows
   of width 10, 3 and 1 into 150,001 rows with heavy duplication, and a
   pose graph's 6x6 blocks into [240, 240]; with both ops' times (CUDA
   events, mean of 20 calls after 3) and the largest difference between
   their sums; whether a batch whose lanes own disjoint rows sums each
   lane as its lone call does; and ``torch.segment_reduce`` as a second
   fixed-order route;
2. whether the kNN path's per-point reductions (squared distances, the
   masked mean and covariance, the plane fit, a 3-term dot product)
   give a lane of a [8, N, ...] batch the bits of its lone [N, ...] call,
   at N = 512, 2048 and 4096.

    python3 scatter_probe.py     # from the repository root, one card

Prints one JSON object: per op, [calls with the first call's bits,
calls], and the batch checks as booleans.
"""

from __future__ import annotations

import json
import os
import sys

import torch


def same_bits(fn, reps: int = 12):
    ref = fn()
    torch.cuda.synchronize()
    return [sum(int(torch.equal(fn(), ref)) for _ in range(reps)), reps]


def mean_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def scatter_ops(dev, g) -> dict:
    out = {}
    n, c = 400_000, 150_000
    for width in (10, 3, 1):
        idx = torch.randint(0, 5000, (n,), generator=g).to(dev)
        shape = (n, width) if width > 1 else (n,)
        src = (torch.randn(shape, generator=g) * 100).to(dev)
        dst = (c + 1,) + shape[1:]

        def add():
            return torch.zeros(dst, device=dev).index_add_(0, idx, src)

        def put():
            return torch.zeros(dst, device=dev).index_put_((idx,), src,
                                                           accumulate=True)

        out[f"width_{width}"] = {
            "index_add_": same_bits(add),
            "index_put_accumulate": same_bits(put),
            "index_add_ms": mean_ms(add),
            "index_put_accumulate_ms": mean_ms(put),
            "max_abs_difference": float((add() - put()).abs().max())}
        if width == 3:
            order = torch.sort(idx, stable=True).indices
            lengths = torch.bincount(idx, minlength=c + 1)
            out["segment_reduce"] = same_bits(lambda: torch.segment_reduce(
                src[order], "sum", lengths=lengths, axis=0))
    k, m, d = 40, 400, 6
    bi = torch.randint(0, k, (m,), generator=g).to(dev)
    bj = torch.randint(0, k, (m,), generator=g).to(dev)
    vals = torch.randn(m, d, d, generator=g).to(dev)
    ar = torch.arange(d, device=dev)
    rows = (bi[:, None] * d + ar)[:, :, None].expand(-1, d, d)
    cols = (bj[:, None] * d + ar)[:, None, :].expand(-1, d, d)
    out["pose_graph_blocks"] = same_bits(lambda: torch.zeros(
        k * d, k * d, device=dev).index_put((rows, cols), vals,
                                            accumulate=True))
    lanes, per = 8, 60000
    lidx = torch.randint(0, 3000, (lanes, per), generator=g).to(dev)
    lsrc = torch.randn(lanes, per, 3, generator=g).to(dev)
    own = (lidx + 3001 * torch.arange(lanes, device=dev)[:, None]).reshape(-1)
    batch = torch.zeros(lanes * 3001, 3, device=dev).index_put_(
        (own,), lsrc.reshape(-1, 3), accumulate=True).reshape(lanes, 3001, 3)
    lone = torch.stack([torch.zeros(3001, 3, device=dev).index_put_(
        (lidx[b],), lsrc[b], accumulate=True) for b in range(lanes)])
    out["batch_lanes_equal_lone"] = bool(torch.equal(batch, lone))
    return out


def fit_reductions(dev, g) -> dict:
    from lidar_feature_extraction_tpu_torch.ops import residuals

    out = {}
    lanes, k, slots = 8, 15, 8
    for n in (512, 2048, 4096):
        cand = (torch.randn(lanes, n, 27 * slots, 3, generator=g) * 2
                + 10).to(dev)
        qry = (torch.randn(lanes, n, 3, generator=g) + 10).to(dev)
        nb = (torch.randn(lanes, n, k, 3, generator=g) * 3 + 20).to(dev)
        nv = (torch.rand(lanes, n, k, generator=g) < 0.8).to(dev)
        w = torch.randn(lanes, n, 3, generator=g).to(dev)

        def sq(c, q):
            d = c - q[..., None, :]
            return torch.sum(d * d, dim=-1)

        checks = {
            "sq_dist": lambda x: sq(x[0], x[1]),
            "mean": lambda x: residuals.masked_mean_and_cov(x[2], x[3])[0],
            "cov": lambda x: residuals.masked_mean_and_cov(x[2], x[3])[1],
            "fit_plane": lambda x: residuals.fit_plane(x[2], x[3]),
            "dot3": lambda x: torch.sum(x[4] * x[1], dim=-1),
        }
        args = (cand, qry, nb, nv, w)
        out[n] = {name: all(torch.equal(fn(args)[b], fn([a[b] for a in args]))
                            for b in range(lanes))
                  for name, fn in checks.items()}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("scatter_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "torch": torch.__version__,
                      "scatter": scatter_ops(dev, g),
                      "fits_batch_lanes_equal_lone": fit_reductions(dev, g)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
