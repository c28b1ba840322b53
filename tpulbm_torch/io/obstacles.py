"""Obstacle-file parsing.

The obstacle file is a sparse list of ``x y 1`` lines marking blocked cells
(d2q9-bgk.c:912-957). Returns the dense boolean mask (shape ``(ny, nx)``,
True = blocked) and the free-cell count; duplicate entries count once
(d2q9-bgk.c:945-947).

Parsing uses numpy's C tokenizer rather than a Python loop; files over
``_NATIVE_THRESHOLD`` bytes go through the native C++ parser
(tpulbm_torch/csrc/io_native.cpp) when the toolchain is available. Both
paths are differential-tested against each other.
"""

from __future__ import annotations

import os

import numpy as np

_NATIVE_THRESHOLD = 1 << 20  # 1 MiB


class ObstacleFileError(ValueError):
    pass


def read_obstacles(path: str | os.PathLike, nx: int, ny: int):
    try:
        use_native = os.path.getsize(path) > _NATIVE_THRESHOLD
    except OSError:
        use_native = False
    if use_native:
        from tpulbm_torch.io import native

        result = native.read_obstacles(str(path), nx, ny)
        if result is not None:
            return result
    with open(path, "rb") as fp:
        raw = fp.read()
    data = np.array(raw.split(), dtype=np.int64)
    if data.size % 3 != 0:
        raise ObstacleFileError("expected 3 values per line in obstacle file")
    triples = data.reshape(-1, 3)
    xs, ys, blocked = triples[:, 0], triples[:, 1], triples[:, 2]
    if xs.size:
        if xs.min() < 0 or xs.max() > nx - 1:
            raise ObstacleFileError("obstacle x-coord out of range")
        if ys.min() < 0 or ys.max() > ny - 1:
            raise ObstacleFileError("obstacle y-coord out of range")
        if not np.all(blocked == 1):
            raise ObstacleFileError("obstacle blocked value should be 1")
    mask = np.zeros((ny, nx), dtype=bool)
    mask[ys, xs] = True
    num_free = nx * ny - int(mask.sum())
    return mask, num_free


def write_obstacles(path: str | os.PathLike, mask: np.ndarray) -> None:
    """Write a dense mask back out in the sparse ``x y 1`` format."""
    ys, xs = np.nonzero(mask)
    with open(path, "w") as fp:
        for x, y in zip(xs, ys):
            fp.write(f"{x} {y} 1\n")
