"""Row decomposition of the grid over the shards of the 1-D ring.

An integer-only copy of ``tpulbm.dist.sharding.decompose_rows``, and the
torch helpers that cut a state into row shards and put them back together.

The ring shards rows by ``decompose_rows``, the reference's remainder-
balanced split (d2q9-bgk.c:834-862): 1024 rows over 3 shards are 342, 341
and 341. The JAX package needs even, 8-aligned shards (XLA's static shapes,
the TPU's DMA tiling) and pads an uneven grid by periodic extension
(``padded_split*``); the port's ring kernel takes any shard height, so it
runs the uneven split as it is, and computes the same function. The padding
policies and the even-split checks have no counterpart here until a route
needs them (the 2-D torus).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def decompose_rows(ny: int, n_ranks: int) -> Tuple[List[int], List[int]]:
    """(rows_per_rank, row_offsets) with the reference's balancing rules
    (d2q9-bgk.c:834-862)."""
    base = ny // n_ranks
    left = ny % n_ranks
    one_for_last = 0
    one_less_second_last = 0
    if base < 3 and left:
        left -= 1
        one_for_last = 1
    elif base < 3 and not left:
        one_for_last = 1
        one_less_second_last = 1
    ny_local = []
    displs = []
    for proc in range(n_ranks):
        if proc < n_ranks - 2:
            rows = base
        elif proc == n_ranks - 2:
            rows = base - one_less_second_last
        else:
            rows = base + one_for_last
        if proc < left:
            rows += 1
        ny_local.append(rows)
        displs.append(0 if proc == 0 else displs[proc - 1] + ny_local[proc - 1])
    return ny_local, displs


def ring_rows(ny: int, n_shards: int) -> Tuple[List[int], List[int]]:
    """``decompose_rows`` for the ring; raises if a shard would have no
    row."""
    rows, offsets = decompose_rows(ny, n_shards)
    if min(rows) < 1:
        raise ValueError(
            f"ny={ny} rows cannot be split over {n_shards} shards (each "
            f"shard needs at least one row)")
    return rows, offsets


def shard_rows(f: torch.Tensor, obstacles: torch.Tensor,
               mesh: Sequence[torch.device]):
    """Cut the (9, ny, nx) state and the (ny, nx) mask into the row shards
    of ``ring_rows``; shard i goes to ``mesh[i]``. Returns (state shards,
    mask shards), lists of contiguous tensors."""
    rows, offsets = ring_rows(f.shape[1], len(mesh))
    fs, obs = [], []
    for dev, h, off in zip(mesh, rows, offsets):
        fs.append(f[:, off:off + h].to(dev).contiguous())
        obs.append(obstacles[off:off + h].to(dev).contiguous())
    return fs, obs


def gather_rows(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' rows, in order, as one tensor on ``device`` (the row
    axis is the second of a state, the first of a mask)."""
    dim = 1 if shards[0].dim() == 3 else 0
    return torch.cat([s.to(device) for s in shards], dim=dim)
