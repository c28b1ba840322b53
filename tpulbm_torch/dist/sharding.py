"""Decompositions of the grid: row shards of the 1-D ring, blocks of the
2-D torus.

Integer-only copies of ``tpulbm.dist.sharding.decompose_rows``,
``validate_even_split`` and ``validate_even_col_split``, and the torch
helpers that cut a state into row shards or blocks and put them back
together.

The ring shards rows by ``decompose_rows``, the reference's remainder-
balanced split (d2q9-bgk.c:834-862): 1024 rows over 3 shards are 342, 341
and 341. The JAX package needs even, 8-aligned shards (XLA's static shapes,
the TPU's DMA tiling) and pads an uneven grid by periodic extension
(``padded_split*``); the port's ring kernel takes any shard height, so it
runs the uneven split as it is, and computes the same function. The padding
policies have no counterpart here.

The torus keeps the JAX package's even split (``validate_even_split`` on
rows, ``validate_even_col_split`` on columns): every block is (ny / dy,
nx / dx), and an uneven split raises the JAX package's ``ValueError``.
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


def validate_even_split(ny: int, n_devices: int) -> int:
    """Rows per device for the even split; raises if invalid."""
    if ny % n_devices != 0:
        raise ValueError(
            f"ny={ny} must divide evenly over {n_devices} devices "
            "(pad the grid or choose a different mesh)"
        )
    rows = ny // n_devices
    if rows < 3:
        raise ValueError(
            f"each device needs >= 3 rows (got {rows}); the accelerated row "
            "must stay interior to its shard (see d2q9-bgk.c:838-849)"
        )
    return rows


def validate_even_col_split(nx: int, n_devices: int) -> int:
    """Columns per device for the 2-D torus split; raises if invalid."""
    if nx % n_devices != 0 or nx // n_devices < 3:
        raise ValueError(
            f"nx={nx} must split evenly into >=3-column shards over "
            f"{n_devices} devices"
        )
    return nx // n_devices


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
    of ``ring_rows``; shard i goes to ``mesh[i]``, and a shard whose entry
    is ``None`` (another process's, ``dist.multihost``) is left out.
    Returns (state shards, mask shards), lists of contiguous tensors."""
    rows, offsets = ring_rows(f.shape[1], len(mesh))
    fs, obs = [], []
    for dev, h, off in zip(mesh, rows, offsets):
        if dev is None:
            continue
        fs.append(f[:, off:off + h].to(dev).contiguous())
        obs.append(obstacles[off:off + h].to(dev).contiguous())
    return fs, obs


def gather_rows(shards: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The shards' rows, in order, as one tensor on ``device`` (the row
    axis is the second of a state, the first of a mask)."""
    dim = 1 if shards[0].dim() == 3 else 0
    return torch.cat([s.to(device) for s in shards], dim=dim)


def block_shape(ny: int, nx: int, dy: int, dx: int) -> Tuple[int, int]:
    """(h, w) of the blocks of a dy x dx torus; raises as the JAX package
    does on an uneven or too thin split."""
    return validate_even_split(ny, dy), validate_even_col_split(nx, dx)


def shard_blocks(f: torch.Tensor, obstacles: torch.Tensor,
                 mesh2d: Sequence[Sequence[torch.device]]):
    """Cut the (9, ny, nx) state and the (ny, nx) mask into the dy x dx
    blocks of the torus ``mesh2d`` (``dist.mesh.get_mesh_2d``): block (i, j)
    holds rows [i h, (i + 1) h) and columns [j w, (j + 1) w) and goes to
    ``mesh2d[i][j]``. Returns (state blocks, mask blocks), lists of
    contiguous tensors in row-major block order; a block whose entry is
    ``None`` (another process's) is left out."""
    dy, dx = len(mesh2d), len(mesh2d[0])
    h, w = block_shape(f.shape[1], f.shape[2], dy, dx)
    fs, obs = [], []
    for i in range(dy):
        for j in range(dx):
            dev = mesh2d[i][j]
            if dev is None:
                continue
            rows, cols = slice(i * h, (i + 1) * h), slice(j * w, (j + 1) * w)
            fs.append(f[:, rows, cols].to(dev).contiguous())
            obs.append(obstacles[rows, cols].to(dev).contiguous())
    return fs, obs


def gather_blocks(blocks: Sequence[torch.Tensor], dy: int, dx: int,
                  device) -> torch.Tensor:
    """The row-major blocks of a dy x dx torus as one tensor on ``device``
    (the inverse of ``shard_blocks``, for states and masks alike)."""
    rows = [torch.cat([b.to(device) for b in blocks[i * dx:(i + 1) * dx]],
                      dim=-1) for i in range(dy)]
    return torch.cat(rows, dim=-2)


def regions(ny: int, nx: int, mesh) -> List[Tuple[int, int, int, int]]:
    """(row0, row1, col0, col1) of every shard of ``mesh``, in shard order:
    the whole grid on one device, ``ring_rows``' row shards on a ring, the
    row-major blocks on a torus (a nested ``mesh``)."""
    if isinstance(mesh[0], (list, tuple)):
        dy, dx = len(mesh), len(mesh[0])
        h, w = block_shape(ny, nx, dy, dx)
        return [(i * h, (i + 1) * h, j * w, (j + 1) * w)
                for i in range(dy) for j in range(dx)]
    rows, offsets = ring_rows(ny, len(mesh))
    return [(off, off + h, 0, nx) for h, off in zip(rows, offsets)]
