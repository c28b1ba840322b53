"""Input-deck generator: a numpy-only copy of ``tpulbm.tools.make_deck``
(the port imports nothing of ``tpulbm``), on the port's own ``io`` and
``core.params``; it writes the same bytes.

The reference ships four fixed decks whose obstacle geometry is a closed box
(all four boundary walls blocked — the lid-driven-cavity setup). This tool
synthesizes the same geometry (plus optional interior obstacles) at any size,
so larger grids (e.g. 4096x4096 for multi-chip runs) use decks structurally
identical to the shipped ones.

CLI:
    python -m tpulbm_torch.tools.make_deck --nx 4096 --ny 4096 --iters 2000 \
        [--density 0.1 --accel 0.01 --omega 1.85 --reynolds-dim 10] \
        [--block y0 x0 h w]... [--out-dir data]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.io.obstacles import write_obstacles
from tpulbm_torch.io.params_file import write_params


def box_obstacles(nx: int, ny: int, blocks=()) -> np.ndarray:
    """Closed-box walls (the shipped decks' geometry) plus optional interior
    rectangles given as (y0, x0, h, w)."""
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0, :] = True
    mask[-1, :] = True
    mask[:, 0] = True
    mask[:, -1] = True
    for y0, x0, h, w in blocks:
        mask[y0 : y0 + h, x0 : x0 + w] = True
    return mask


def make_deck(nx, ny, iters, out_dir=".", density=0.1, accel=0.01,
              omega=1.85, reynolds_dim=10, blocks=(), name=None):
    name = name or f"{nx}x{ny}"
    params = LBMParams(nx=nx, ny=ny, max_iters=iters,
                       reynolds_dim=reynolds_dim, density=density,
                       accel=accel, omega=omega)
    os.makedirs(out_dir, exist_ok=True)
    ppath = os.path.join(out_dir, f"input_{name}.params")
    opath = os.path.join(out_dir, f"obstacles_{name}.dat")
    write_params(ppath, params)
    write_obstacles(opath, box_obstacles(nx, ny, blocks))
    return ppath, opath


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Generate a tpu-lbm input deck")
    p.add_argument("--nx", type=int, required=True)
    p.add_argument("--ny", type=int, required=True)
    p.add_argument("--iters", type=int, required=True)
    p.add_argument("--density", type=float, default=0.1)
    p.add_argument("--accel", type=float, default=0.01)
    p.add_argument("--omega", type=float, default=1.85)
    p.add_argument("--reynolds-dim", type=int, default=10)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--name", default=None)
    p.add_argument(
        "--block", nargs=4, type=int, action="append", default=[],
        metavar=("Y0", "X0", "H", "W"),
        help="interior rectangular obstacle (repeatable)",
    )
    args = p.parse_args(argv)
    ppath, opath = make_deck(
        args.nx, args.ny, args.iters, out_dir=args.out_dir,
        density=args.density, accel=args.accel, omega=args.omega,
        reynolds_dim=args.reynolds_dim, blocks=args.block, name=args.name,
    )
    print(ppath)
    print(opath)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
