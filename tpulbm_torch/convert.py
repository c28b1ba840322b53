"""State carried between ``tpulbm`` (JAX) and ``tpulbm_torch``.

``from_tpulbm`` takes the JAX package's parameters (any object with the
``LBMParams`` fields, such as its dataclass, or a dict of them) and numpy
copies of its state and obstacle mask, and returns the port's
``(LBMParams, f, obstacles)`` on a device. ``to_numpy`` goes back: a dict of
the parameter fields (``tpulbm.LBMParams(**d)`` rebuilds them) and numpy
arrays. Neither imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpulbm_torch.core.params import LBMParams

_FIELDS = [fld.name for fld in dataclasses.fields(LBMParams)]


def from_tpulbm(params_like, f: np.ndarray, obstacles: np.ndarray,
                device="cpu"):
    if isinstance(params_like, dict):
        params = LBMParams(**{name: params_like[name] for name in _FIELDS})
    else:
        params = LBMParams(
            **{name: getattr(params_like, name) for name in _FIELDS})
    f = np.asarray(f, dtype=np.float32)
    obstacles = np.asarray(obstacles, dtype=bool)
    if f.shape != (9, params.ny, params.nx) or obstacles.shape != (
            params.ny, params.nx):
        raise ValueError(
            f"state {f.shape} / mask {obstacles.shape} do not match the "
            f"({params.ny}, {params.nx}) grid")
    return (
        params,
        torch.tensor(f, device=device),
        torch.tensor(obstacles, device=device),
    )


def to_numpy(params: LBMParams, f: torch.Tensor, obstacles: torch.Tensor):
    return (
        dataclasses.asdict(params),
        f.detach().cpu().numpy(),
        obstacles.detach().cpu().numpy(),
    )
