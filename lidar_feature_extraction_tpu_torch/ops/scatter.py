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
