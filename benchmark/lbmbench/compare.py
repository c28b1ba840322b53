"""The numbers that decide ``correct``, and their limits.

Each number compares what the timed path produced with the plain
reference (``reference.py``), which recomputes it from the same deck,
draws and mask:

- ``av_rel``: the widest gap of an av_vels value, over every step
  compared, over the reference's largest value of the series (the first
  steps' values are sums of |u| that cancel to ~1e-5, whose own rounding
  would otherwise set the number);
- ``av_head``: ``av_rel`` over the first ``HEAD_STEPS`` steps from rest
  alone (the start of a long solve, each kept solve of a sweep), before
  the control in bfloat16 diverges;
- ``state_rel``: the widest gap of a population after a runner call, over
  the reference's largest population;
- ``field_rel``: the widest gap of a final_state.dat column, u_x, u_y and
  |u| over the reference's largest |u|, pressure over its largest
  pressure;
- ``re_rel``: the relative gap of the Reynolds number;
- ``faults``: bookkeeping that must hold exactly: steps counted, every av
  value of the history finite and positive, every line of the written
  files where it belongs (exact, limit 0).

The limits lie between the program's readings over a dozen seeds and
more (the lower) and those of the control, the reference computed in
bfloat16 in the program's place (the upper); PERF.md gives both.
"""

from __future__ import annotations

import numpy as np

HEAD_STEPS = 256

LIMITS = {
    "av_head": 2e-2,
    "av_rel": 8e-2,
    "state_rel": 8e-3,
    "field_rel": 1e-1,
    "re_rel": 3e-2,
    "faults": 0,
}


def gap(a, b, scale=None) -> float:
    """max |a - b| over ``scale``, by default max |b|."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return float("inf")
    if scale is None:
        scale = np.max(np.abs(b))
    return float(np.max(np.abs(a - b)) / scale)


def field_gap(planes, ref) -> float:
    """``field_rel`` of (4, ny, nx) u_x, u_y, |u|, pressure against the
    reference's."""
    speed = np.max(np.abs(ref[2]))
    return max([gap(planes[i], ref[i], speed) for i in range(3)]
               + [gap(planes[3], ref[3])])


def history_faults(av: np.ndarray) -> int:
    """av values of a history that are not finite and positive."""
    return int(np.count_nonzero(~(np.isfinite(av) & (av > 0))))


def read_av_vels(path, n_steps: int):
    """(the av series, faults) of an av_vels.dat of ``n_steps`` lines
    ``"%d:\\t%.12E"``: a line out of place is a fault."""
    lines = open(path).read().splitlines()
    idx, av = [], []
    for line in lines:
        i, _, v = line.partition(":\t")
        idx.append(int(i))
        av.append(float(v))
    faults = abs(len(lines) - n_steps) + int(np.count_nonzero(
        np.asarray(idx[:n_steps]) != np.arange(min(n_steps, len(idx)))))
    return np.asarray(av), faults


def read_final_state(path, mask: np.ndarray):
    """((4, ny, nx) u_x, u_y, |u|, pressure, faults) of a final_state.dat:
    the x, y and obstacle columns must list the grid y-major, with the
    mask."""
    ny, nx = mask.shape
    rows = np.array(open(path).read().split(), dtype=np.float64)
    if rows.size != ny * nx * 7:
        return None, ny * nx
    rows = rows.reshape(ny * nx, 7)
    ys, xs = np.divmod(np.arange(ny * nx), nx)
    faults = int(np.count_nonzero(rows[:, 0] != xs)
                 + np.count_nonzero(rows[:, 1] != ys)
                 + np.count_nonzero(rows[:, 6] != mask.reshape(-1)))
    return rows[:, 2:6].T.reshape(4, ny, nx), faults
