"""Float scatter-adds whose order of summation is fixed on the card.

``index_add_`` on a CUDA tensor adds through atomics, in whatever order
the threads arrive, so a float sum changes in its last bits from one run
to the next, and a map or a downsample built from those sums moves the
registrations that use it (ROADMAP.md §C16). ``index_put_`` with
``accumulate=True`` runs on CUDA as a stable sort of the destinations
followed by a sum over each destination's run in that sorted order: the
same bits every run, and, when a batch offsets each lane's destinations,
the same bits for a lane as for its lone call. On the CPU it is the other
way round: ``index_add_`` adds in index order, the arithmetic the parity
tests hold, while ``index_put_(accumulate=True)`` splits a large input
between threads and has no fixed order. ``scatter_probe.py`` measures
both ops on the card.
"""

from __future__ import annotations

import torch


def index_add_rows(out: torch.Tensor, index: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """``out[index[k]] += src[k]`` along dim 0, in place; returns ``out``.
    ``index`` is int64 [N], ``src`` [N, ...] with ``out``'s trailing
    shape."""
    if out.is_cuda:
        return out.index_put_((index,), src, accumulate=True)
    return out.index_add_(0, index, src)


def index_add_rows_in_order(out: torch.Tensor, index: torch.Tensor,
                            src: torch.Tensor) -> torch.Tensor:
    """``out`` [N, ...] with ``src``'s rows added at ``index`` along dim
    0, out of place, each destination's rows one after another in
    ``src``'s order, ``((out[d] + s_1) + s_2) + ...``, as XLA's scatter
    adds them, on every device by construction: the rows go in passes,
    pass p adding each destination's p-th row, so no pass adds two rows
    into one destination and ``index_add_`` (atomics on the card) adds
    each row once, exactly. A row a pass does not take goes to a spare
    row past ``out``'s end. One host read, the number of passes."""
    n = index.shape[0]
    pos = torch.arange(n, device=index.device)
    order = torch.sort(index, stable=True).indices
    dest = index[order]
    first = torch.ones_like(dest, dtype=torch.bool)
    first[1:] = dest[1:] != dest[:-1]
    # a row's rank among its destination's rows, in src's order
    start = torch.where(first, pos, 0).cummax(0).values
    rank = torch.empty_like(pos).index_put_((order,), pos - start)
    passes = int(rank.max()) + 1 if n else 0
    spare = out.shape[0]
    rows = torch.where(
        rank == torch.arange(passes, device=index.device)[:, None],
        index, spare)
    acc = torch.cat([out, out.new_zeros((1,) + tuple(out.shape[1:]))])
    for p in range(passes):
        acc.index_add_(0, rows[p], src)
    return acc[:spare]
