"""The D2Q9-BGK collision physics on pulled (post-streaming) populations.

PyTorch counterpart of ``tpulbm.core.physics``: the functions take a list of
nine equal-shape float32 tensors ``t[k]`` — the populations that have just
streamed *into* each cell — and keep the float32 operation order of the JAX
version (d2q9-bgk.c:542-700). Every constant is a Python float holding an
exact float32 value, so tensor-scalar arithmetic stays float32.

The simplified equilibrium, with momentum m = sum_k t_k c_k and density rho,

    feq_k = w_k * (rho + 3 (m.c_k) + (3 / (2 rho)) * (3 (m.c_k)^2 - |m|^2))

(d2q9-bgk.c:638-647); the per-cell |u| of the average-velocity series is
|m| / rho (d2q9-bgk.c:667).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpulbm_torch.core.lattice import NSPEEDS, OPP, W0, W1, W2

_W0, _W1, _W2 = float(W0), float(W1), float(W2)
_HALF = 0.5
_IC_SQ = 3.0


def macroscopics(t: Sequence[torch.Tensor]):
    """density, 1/density, momentum components and |m|^2 (d2q9-bgk.c:542-590)."""
    dens = t[0] + t[1] + t[2] + t[3] + t[4] + t[5] + t[6] + t[7] + t[8]
    densinv = torch.reciprocal(dens)
    m_x = t[1] + t[5] + t[8] - t[3] - t[6] - t[7]
    m_y = t[2] + t[5] + t[6] - t[4] - t[7] - t[8]
    u_sq = m_x * m_x + m_y * m_y
    return dens, densinv, m_x, m_y, u_sq


def equilibrium(dens, densinv, m_x, m_y, u_sq, pair_symmetric: bool = False):
    """The nine simplified BGK equilibria (d2q9-bgk.c:592-647).

    ``pair_symmetric=True`` shares the quadratic term of each
    opposite-direction pair, the form the CUDA kernels run:

        feq_k   = w (dens + q_k) + 3 w (m.c_k)
        feq_opp = w (dens + q_k) - 3 w (m.c_k)

    It rounds differently from the canonical form, so the two are compared
    by tolerance, never bitwise."""
    mu = (None, m_x, m_y, -m_x, -m_y, m_x + m_y, -m_x + m_y, -m_x - m_y, m_x - m_y)
    half_inv3 = _HALF * densinv * _IC_SQ
    feq0 = _W0 * (dens - half_inv3 * u_sq)
    if pair_symmetric:
        feq = [feq0] + [None] * (NSPEEDS - 1)
        for k, opp in ((1, 3), (2, 4), (5, 7), (6, 8)):
            w = _W1 if k <= 4 else _W2
            imu = mu[k] * _IC_SQ  # 3 (m.c_k)
            wb = w * (dens + half_inv3 * (imu * mu[k] - u_sq))
            wi = w * imu
            feq[k] = wb + wi
            feq[opp] = wb - wi
        return feq
    feq = [feq0]
    for k in range(1, NSPEEDS):
        w = _W1 if k <= 4 else _W2
        imu = mu[k] * _IC_SQ  # 3 (m.c_k)
        feq.append(w * (dens + imu + half_inv3 * (imu * mu[k] - u_sq)))
    return feq


def collide(
    t: Sequence[torch.Tensor],
    obstacle_mask: torch.Tensor,
    omega: float,
    pair_symmetric: bool = False,
):
    """BGK relax on free cells, bounce-back of the pulled values on obstacles
    (d2q9-bgk.c:649-700). ``obstacle_mask`` is boolean, True on blocked
    cells. Returns (nine post-collision planes, per-cell |u|, zero on
    obstacles)."""
    dens, densinv, m_x, m_y, u_sq = macroscopics(t)
    feq = equilibrium(dens, densinv, m_x, m_y, u_sq, pair_symmetric)
    om = float(np.float32(omega))
    out = []
    for k in range(NSPEEDS):
        relaxed = t[k] + om * (feq[k] - t[k])
        out.append(torch.where(obstacle_mask, t[OPP[k]], relaxed))
    speed = torch.where(
        obstacle_mask, torch.zeros_like(dens), torch.sqrt(u_sq) * densinv
    )
    return out, speed
