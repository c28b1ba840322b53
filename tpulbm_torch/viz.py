"""Visualization of the final state: a numpy-only copy of
``tpulbm.viz`` (the port imports nothing of ``tpulbm``).

The reference ships a gnuplot script plotting |u| as an image
(final_state.plt: ``plot 'final_state.dat' using 1:2:5 with image``). This
module renders the same figure from either a ``final_state.dat`` file or an
in-memory state, via matplotlib when available (a copy of the gnuplot script
lives at scripts/final_state.plt for parity).

CLI: ``python -m tpulbm_torch.viz final_state.dat [-o final_state.png]``
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def load_final_state(path: str):
    """(u_x, u_y, |u|, pressure, obstacles) 2-D fields from final_state.dat."""
    data = np.loadtxt(path)
    nx = int(data[:, 0].max()) + 1
    ny = int(data[:, 1].max()) + 1
    if data.shape[0] != nx * ny:
        raise ValueError(f"{path}: expected {nx * ny} rows, got {data.shape[0]}")
    # y-major ascending order (d2q9-bgk.c:1071-1115)
    grids = [data[:, c].reshape(ny, nx) for c in (2, 3, 4, 5, 6)]
    return tuple(grids)


def plot_speed(speed: np.ndarray, out_path: str, title: str = "Fluid Velocity"):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(
            "matplotlib unavailable; use scripts/final_state.plt with gnuplot"
        ) from e
    fig, ax = plt.subplots(figsize=(6, 6 * speed.shape[0] / speed.shape[1]))
    im = ax.imshow(speed, origin="lower", aspect="equal", cmap="viridis")
    ax.set_title(title)
    ax.set_xlabel("cell # along x-dimension")
    ax.set_ylabel("cell # along y-dimension")
    fig.colorbar(im, ax=ax, label="|u|")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Plot |u| from final_state.dat")
    p.add_argument("final_state")
    p.add_argument("-o", "--output", default="final_state.png")
    args = p.parse_args(argv)
    _, _, u, _, _ = load_final_state(args.final_state)
    out = plot_speed(u, args.output)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
