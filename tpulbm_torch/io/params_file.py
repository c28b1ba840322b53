"""Parameter-deck parser.

Reads the reference's 7-line whitespace-separated parameter file
(d2q9-bgk.c:781-800): nx, ny, maxIters, reynolds_dim, density, accel, omega.
"""

from __future__ import annotations

import os

from tpulbm_torch.core.params import LBMParams


class ParamFileError(ValueError):
    pass


def read_params(path: str | os.PathLike) -> LBMParams:
    with open(path, "r") as fp:
        tokens = fp.read().split()
    if len(tokens) < 7:
        raise ParamFileError(
            f"param file {path!r}: expected 7 values, got {len(tokens)}"
        )
    names = ["nx", "ny", "maxIters", "reynolds_dim", "density", "accel", "omega"]
    vals = {}
    for name, tok in zip(names, tokens):
        try:
            vals[name] = int(tok) if name in names[:4] else float(tok)
        except ValueError as e:
            raise ParamFileError(f"could not read param file: {name}") from e
    return LBMParams(
        nx=vals["nx"],
        ny=vals["ny"],
        max_iters=vals["maxIters"],
        reynolds_dim=vals["reynolds_dim"],
        density=vals["density"],
        accel=vals["accel"],
        omega=vals["omega"],
    )


def write_params(path: str | os.PathLike, params: LBMParams) -> None:
    with open(path, "w") as fp:
        fp.write(
            f"{params.nx}\n{params.ny}\n{params.max_iters}\n"
            f"{params.reynolds_dim}\n{params.density}\n{params.accel}\n"
            f"{params.omega}\n"
        )
