"""Lattice state construction.

The state is one SoA tensor ``f`` of shape ``(9, ny, nx)`` float32, the
layout of ``tpulbm.core.state``: channel-major, ``x`` contiguous, so a CUDA
warp reading 32 neighbouring cells of one channel reads 128 contiguous bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from tpulbm_torch.core.lattice import NSPEEDS
from tpulbm_torch.core.params import LBMParams


def initial_state(params: LBMParams, device="cpu") -> torch.Tensor:
    """Equilibrium-at-rest initial condition (d2q9-bgk.c:879-902).

    Channel 0 gets ``density*4/9``, axis channels ``density/9``, diagonal
    channels ``density/36`` — all computed in float32.
    """
    rho = np.float32(params.density)
    w0 = rho * np.float32(4.0) / np.float32(9.0)
    w1 = rho / np.float32(9.0)
    w2 = rho / np.float32(36.0)
    per_channel = torch.tensor(
        np.array([w0, w1, w1, w1, w1, w2, w2, w2, w2], dtype=np.float32),
        device=device,
    )
    return per_channel[:, None, None].expand(
        NSPEEDS, params.ny, params.nx
    ).contiguous()
