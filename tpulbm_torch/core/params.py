"""Simulation parameters.

Mirrors the 7-scalar parameter deck of the reference (``t_param``,
d2q9-bgk.c:79-92) plus the derived ``free_cells_inv`` normaliser that the
reference computes while reading the obstacle file (d2q9-bgk.c:945-950).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LBMParams:
    nx: int
    ny: int
    max_iters: int
    reynolds_dim: int
    density: float
    accel: float
    omega: float
    # 1 / (number of obstacle-free cells); 0.0 until obstacles are loaded.
    free_cells_inv: float = 0.0

    def with_free_cells(self, num_free_cells: int) -> "LBMParams":
        if num_free_cells <= 0:
            raise ValueError(
                "obstacle map blocks every cell; no fluid to simulate"
            )
        inv = float(np.float32(1.0) / np.float32(num_free_cells))
        return dataclasses.replace(self, free_cells_inv=inv)

    @property
    def viscosity(self) -> float:
        # nu = (2/omega - 1) / 6 in float32, as d2q9-bgk.c:1005.
        om = np.float32(self.omega)
        return float(
            np.float32(1.0) / np.float32(6.0) * (np.float32(2.0) / om - np.float32(1.0))
        )

    @property
    def accel_w1(self) -> float:
        # density * accel / 9 (d2q9-bgk.c:445), float32 arithmetic.
        return float(
            np.float32(self.density) * np.float32(self.accel) * np.float32(1.0 / 9.0)
        )

    @property
    def accel_w2(self) -> float:
        # density * accel / 36 (d2q9-bgk.c:446), float32 arithmetic.
        return float(
            np.float32(self.density) * np.float32(self.accel) * np.float32(1.0 / 36.0)
        )

    @property
    def accel_row(self) -> int:
        # The inflow-accelerated row is the second row from the top of the
        # global grid (d2q9-bgk.c:448-449 with the decomposition of :834-862).
        return self.ny - 2

    @property
    def total_updates(self) -> int:
        return self.nx * self.ny * self.max_iters
