"""Diagnostics over a (9, ny, nx) state, on its device.

Counterpart of ``tpulbm.diag.observables``:
- av_velocity (d2q9-bgk.c:707-757): mean |u| over free cells.
- calc_reynolds (d2q9-bgk.c:1002-1008): av_vel * reynolds_dim / viscosity.
- total_density (d2q9-bgk.c:1011-1032): mass-conservation check.
- output_fields: the final_state.dat planes.
All float32; ``obstacles`` is boolean, True on blocked cells.
"""

from __future__ import annotations

import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.ops.step_torch import scale_sums


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def moments(f: torch.Tensor):
    """(density, momentum_x, momentum_y) per cell (d2q9-bgk.c:723-746)."""
    dens = f.sum(dim=0)
    m_x = f[1] + f[5] + f[8] - (f[3] + f[6] + f[7])
    m_y = f[2] + f[5] + f[6] - (f[4] + f[7] + f[8])
    return dens, m_x, m_y


def velocity_field(f: torch.Tensor):
    """(u_x, u_y, |u|) with u = m / rho; not masked by obstacles."""
    dens, m_x, m_y = moments(f)
    u_x = m_x / dens
    u_y = m_y / dens
    return u_x, u_y, torch.sqrt(u_x * u_x + u_y * u_y)


def speed_sum(f: torch.Tensor, obstacles: torch.Tensor) -> torch.Tensor:
    """The float32 sum of |u| over the free cells of ``f``: av_velocity
    before its scale, which the shards of a ring or torus take alone."""
    _, _, u = velocity_field(f)
    return torch.where(obstacles, torch.zeros_like(u), u).sum(
        dtype=torch.float32)


def av_velocity(f: torch.Tensor, obstacles: torch.Tensor,
                params: LBMParams) -> torch.Tensor:
    return scale_sums(speed_sum(f, obstacles), params)


def reynolds_of(av: torch.Tensor, params: LBMParams) -> torch.Tensor:
    """The Reynolds number of the average velocity ``av``."""
    return av * _f32(params.reynolds_dim, av) / _f32(params.viscosity, av)


def calc_reynolds(f: torch.Tensor, obstacles: torch.Tensor,
                  params: LBMParams) -> torch.Tensor:
    return reynolds_of(av_velocity(f, obstacles, params), params)


def total_density(f: torch.Tensor) -> torch.Tensor:
    return f.sum(dtype=torch.float32)


def output_fields(f: torch.Tensor, obstacles: torch.Tensor, density: float):
    """(u_x, u_y, |u|, pressure) for final_state output (obstacle cells:
    zero velocity, ambient pressure density/3 — d2q9-bgk.c:1076-1111).
    Four (ny, nx) planes are less than half the state's bytes to read back."""
    zero = torch.zeros((), dtype=torch.float32, device=f.device)
    c_sq = _f32(1.0, f) / _f32(3.0, f)
    dens, m_x, m_y = moments(f)
    u_x = torch.where(obstacles, zero, m_x / dens)
    u_y = torch.where(obstacles, zero, m_y / dens)
    u = torch.sqrt(u_x * u_x + u_y * u_y)
    pressure = torch.where(obstacles, _f32(density, f) * c_sq, dens * c_sq)
    return u_x, u_y, u, pressure
