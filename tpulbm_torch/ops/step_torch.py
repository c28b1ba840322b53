"""Single-device plain PyTorch timestep: the port's oracle.

Counterpart of ``tpulbm.ops.step_jnp``: full-grid pull streaming with
``torch.roll`` (periodic in both axes), the masked inflow acceleration, BGK
collision and bounce-back, and the |u| sum — the fused ``timestep`` +
``accelerate_flow`` pair of the reference (d2q9-bgk.c:442-704). It runs on
any device. ``--backend torch`` runs it, and the plain version beside each
CUDA kernel (``ops.kstep``, ``ops.resident``, ``ops.kstep_tile``) is built
on it.
"""

from __future__ import annotations

import torch

from tpulbm_torch.core import physics
from tpulbm_torch.core.lattice import CX, CY, NSPEEDS
from tpulbm_torch.core.params import LBMParams


def pull(f: torch.Tensor) -> list[torch.Tensor]:
    """Streaming by pull: t_k(y, x) = f_k(y - c_ky, x - c_kx), periodic
    (the gather loop of d2q9-bgk.c:520-540 on a torus)."""
    return [
        torch.roll(f[k], shifts=(CY[k], CX[k]), dims=(0, 1))
        for k in range(NSPEEDS)
    ]


def accelerate(
    f: torch.Tensor, obstacles: torch.Tensor, params: LBMParams,
    row: int | None = None,
) -> torch.Tensor:
    """Masked inflow acceleration of global row ny-2 (d2q9-bgk.c:442-478).

    Adds w1 to channel 1 and w2 to 5,8, subtracts the same from 3,6,7 — only
    where the cell is free and channels 3,6,7 stay positive after the update
    (the knife-edge guard of d2q9-bgk.c:457-460). ``row`` is the index of
    that row in ``f``: ``params.accel_row`` for the whole grid, another for
    a band of rows. Returns a new tensor.
    """
    w1, w2 = params.accel_w1, params.accel_w2
    if row is None:
        row = params.accel_row
    fr = f[:, row]
    mask = (
        ~obstacles[row]
        & (fr[3] - w1 > 0.0)
        & (fr[6] - w2 > 0.0)
        & (fr[7] - w2 > 0.0)
    )
    zero = torch.zeros_like(fr[0])
    dw1 = torch.where(mask, zero + w1, zero)
    dw2 = torch.where(mask, zero + w2, zero)
    out = f.clone()
    out[1, row] = fr[1] + dw1
    out[3, row] = fr[3] - dw1
    out[5, row] = fr[5] + dw2
    out[6, row] = fr[6] - dw2
    out[7, row] = fr[7] - dw2
    out[8, row] = fr[8] + dw2
    return out


def collide_stream(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    pair_symmetric: bool = False,
):
    """One fused pull + collide + bounce-back sweep over the whole grid.

    Returns the new state and the float32 sum of |u| over free cells
    (the partial ``tot_u`` of d2q9-bgk.c:493-704).
    """
    out, speed = physics.collide(
        pull(f), obstacles, params.omega, pair_symmetric
    )
    return torch.stack(out), speed.sum(dtype=torch.float32)


def lbm_step(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    pair_symmetric: bool = False,
):
    """accelerate -> collide_stream, returning (f', av_vel) for this step
    (the per-iteration order of d2q9-bgk.c:315-394)."""
    f, tot_u = collide_stream(
        accelerate(f, obstacles, params), obstacles, params, pair_symmetric
    )
    return f, scale_sums(tot_u, params)


def run_sums(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    n_steps: int,
    pair_symmetric: bool = False,
):
    """n_steps of accelerate -> collide_stream; returns (final state,
    (n_steps,) float32 series of raw |u| sums, not yet scaled by
    ``free_cells_inv`` — what the kernels' chunks return)."""
    sums = []
    for _ in range(n_steps):
        f, tot_u = collide_stream(
            accelerate(f, obstacles, params), obstacles, params,
            pair_symmetric,
        )
        sums.append(tot_u)
    return f, torch.stack(sums)


def run_steps(
    f: torch.Tensor,
    obstacles: torch.Tensor,
    params: LBMParams,
    n_steps: int,
    pair_symmetric: bool = False,
):
    """n_steps of lbm_step; returns (final state, av_vels series)."""
    f, sums = run_sums(f, obstacles, params, n_steps, pair_symmetric)
    return f, scale_sums(sums, params)


def scale_sums(sums: torch.Tensor, params: LBMParams) -> torch.Tensor:
    """Raw sums of |u| over the free cells as average velocities: times the
    float32 ``free_cells_inv`` (tpulbm/core/params.py:32), on the sums'
    device. The one statement of the av series' scale, which every route
    keeps bitwise."""
    return sums * torch.tensor(params.free_cells_inv, dtype=torch.float32,
                               device=sums.device)
