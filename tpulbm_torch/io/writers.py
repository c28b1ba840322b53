"""Output writers, byte-compatible with the reference formats.

- ``final_state.dat``: one line per cell, y-major ascending, with
  ``"%d %d %.12E %.12E %.12E %.12E %d"`` = x, y, u_x, u_y, |u|, pressure,
  obstacle (d2q9-bgk.c:1115). Obstacle cells write zero velocity and the
  ambient pressure ``density/3`` (d2q9-bgk.c:1076-1080).
- ``av_vels.dat``: ``"%d:\\t%.12E"`` per timestep (d2q9-bgk.c:1136).

The formatted-text hot path (a million lines for 1024x1024) is delegated to
the port's native C++ writer (tpulbm_torch.io.native), which formats each
float32 exactly without stdio, when it is available; the pure-Python path
produces identical bytes (it and C's printf "%.12E" agree).
"""

from __future__ import annotations

import os

import numpy as np

from tpulbm_torch.core.lattice import C_SQ
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.io import native
from tpulbm_torch.utils.profiling import spanned


def final_state_fields(f: np.ndarray, obstacles: np.ndarray, params: LBMParams):
    """Macroscopic output fields from a (9, ny, nx) state.

    Mirrors write_values' per-cell computation (d2q9-bgk.c:1071-1112):
    u = m / rho on free cells, zeros on obstacles; pressure = rho/3 on free
    cells, density/3 on obstacles. All float32.
    """
    f = np.asarray(f, dtype=np.float32)
    obst = np.asarray(obstacles, dtype=bool)
    dens = f.sum(axis=0, dtype=np.float32)
    m_x = f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])
    m_y = f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])
    with np.errstate(divide="ignore", invalid="ignore"):
        u_x = np.where(obst, np.float32(0.0), m_x / dens)
        u_y = np.where(obst, np.float32(0.0), m_y / dens)
    u = np.sqrt(u_x * u_x + u_y * u_y, dtype=np.float32)
    ambient = np.float32(params.density) * C_SQ
    pressure = np.where(obst, ambient, dens * C_SQ).astype(np.float32)
    return u_x, u_y, u, pressure


@spanned("lbm.io.final_state")
def write_final_state(
    path: str | os.PathLike,
    f: np.ndarray,
    obstacles: np.ndarray,
    params: LBMParams,
    fields=None,
) -> None:
    """``fields`` may carry precomputed (u_x, u_y, u, pressure) planes (e.g.
    from tpulbm_torch.diag.observables.output_fields on the device);
    otherwise they are derived here from the raw state."""
    if fields is None:
        u_x, u_y, u, pressure = final_state_fields(f, obstacles, params)
    else:
        u_x, u_y, u, pressure = (
            np.asarray(a, dtype=np.float32) for a in fields
        )
    obst_i = np.asarray(obstacles, dtype=np.int32)
    if native.available():
        native.write_final_state(str(path), u_x, u_y, u, pressure, obst_i)
        return
    ny, nx = obst_i.shape
    lines = []
    for yy in range(ny):
        ux_r, uy_r, u_r, p_r, o_r = u_x[yy], u_y[yy], u[yy], pressure[yy], obst_i[yy]
        for xx in range(nx):
            lines.append(
                "%d %d %.12E %.12E %.12E %.12E %d\n"
                % (xx, yy, ux_r[xx], uy_r[xx], u_r[xx], p_r[xx], o_r[xx])
            )
    with open(path, "w") as fp:
        fp.write("".join(lines))


@spanned("lbm.io.av_vels")
def write_av_vels(path: str | os.PathLike, av_vels: np.ndarray) -> None:
    av = np.asarray(av_vels, dtype=np.float32)
    if native.available():
        native.write_av_vels(str(path), av)
        return
    with open(path, "w") as fp:
        fp.write(
            "".join("%d:\t%.12E\n" % (i, v) for i, v in enumerate(av))
        )
