"""High-level simulation driver, on one device or a ring of shards.

Counterpart of ``tpulbm.sim.simulation``: initialise from a parameter deck
and an obstacle file, run the step loop in chunks (the av series is read
back once per chunk), then expose the final state, the av_vels series and
the Reynolds number, and write the reference's output files. With a
``mesh`` of N >= 2 devices (``dist.mesh.get_mesh``) the state and the mask
are held as the row shards of ``dist.sharding.shard_rows`` and stepped by
the ring runner; ``f``, ``reynolds()`` and ``write_outputs()`` gather the
shards on the first device.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.diag.observables import calc_reynolds, output_fields
from tpulbm_torch.dist.runner import make_runner, resolve_backend
from tpulbm_torch.dist.sharding import gather_rows, shard_rows
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.io.writers import write_av_vels, write_final_state


@dataclasses.dataclass
class SimulationResult:
    params: LBMParams
    f: torch.Tensor
    av_vels: np.ndarray
    reynolds: float
    elapsed_s: float


class Simulation:
    def __init__(
        self,
        params: LBMParams,
        obstacles: np.ndarray,
        backend: str = "auto",
        device="cuda",
        mesh=None,
    ):
        if params.free_cells_inv == 0.0:
            params = params.with_free_cells(
                params.nx * params.ny - int(np.asarray(obstacles).sum())
            )
        self.params = params
        self.mesh = ([torch.device(device)] if mesh is None
                     else [torch.device(d) for d in mesh])
        self.device = self.mesh[0]
        self.backend = resolve_backend(backend, self.device)
        self.obstacles = torch.as_tensor(
            np.asarray(obstacles, dtype=bool), device=self.device)
        f = initial_state(params, self.device)
        if len(self.mesh) > 1:
            self.shards, self.obst_shards = shard_rows(f, self.obstacles,
                                                       self.mesh)
        else:
            self.shards, self.obst_shards = [f], [self.obstacles]
        self._gathered = None
        self.step_count = 0
        self.av_vels = np.zeros((params.max_iters,), dtype=np.float32)
        self._runners = {}

    @classmethod
    def from_files(
        cls,
        param_file: str | os.PathLike,
        obstacle_file: str | os.PathLike,
        backend: str = "auto",
        device="cuda",
        mesh=None,
    ) -> "Simulation":
        params = read_params(param_file)
        mask, num_free = read_obstacles(obstacle_file, params.nx, params.ny)
        return cls(params.with_free_cells(num_free), mask, backend=backend,
                   device=device, mesh=mesh)

    @property
    def f(self) -> torch.Tensor:
        """The (9, ny, nx) state on the first device: on a ring, the shards
        gathered once after each runner call."""
        if len(self.shards) == 1:
            return self.shards[0]
        if self._gathered is None:
            self._gathered = gather_rows(self.shards, self.device)
        return self._gathered

    def settle(self) -> None:
        """Finish set-up before a timed region: wait for the uploads and,
        on the ``cuda`` backend, build and load the kernels (the reference
        starts its clock after ``initialise``, d2q9-bgk.c:278-279)."""
        if self.backend in ("cuda", "cuda-p2p"):
            from tpulbm_torch.ops import _build

            _build.library()
        for dev in set(self.mesh):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _runner(self, n_steps: int):
        if n_steps not in self._runners:
            self._runners[n_steps] = make_runner(
                self.params, n_steps, backend=self.backend,
                device=self.device, mesh=self.mesh)
        return self._runners[n_steps]

    @staticmethod
    def _plan_chunks(total: int, chunk: int) -> list:
        """Chunk sizes covering ``total`` steps: full chunks and one
        remainder, so at most two runners are built per run."""
        n_full, rem = divmod(total, chunk)
        return [chunk] * n_full + ([rem] if rem else [])

    def run(
        self,
        n_steps: Optional[int] = None,
        chunk: Optional[int] = None,
        progress: bool = False,
    ) -> SimulationResult:
        """Advance ``n_steps`` (default: the deck's maxIters minus steps
        already taken), returning the accumulated result."""
        remaining = self.params.max_iters - self.step_count
        total = remaining if n_steps is None else n_steps
        if total > remaining:
            raise ValueError(
                f"run of {total} steps would exceed the deck's maxIters="
                f"{self.params.max_iters} (already at step {self.step_count})"
            )
        chunk = max(1, min(total if chunk is None else chunk, total))
        t0 = time.perf_counter()
        for n in self._plan_chunks(total, chunk):
            if len(self.mesh) > 1:
                self._gathered = None
                self.shards, av = self._runner(n)(self.shards,
                                                  self.obst_shards)
            else:
                f, av = self._runner(n)(self.shards[0], self.obstacles)
                self.shards = [f]
            av_np = av.cpu().numpy()
            if not np.isfinite(av_np[-1]):
                # Divergence check, the runtime form of the reference's
                # disabled FP traps (d2q9-bgk.c:60,195): BGK goes unstable
                # for omega near 2 or too strong a forcing. Bookkeeping
                # advances through the last finite step first.
                bad = int(np.argmax(~np.isfinite(av_np)))
                self.av_vels[self.step_count : self.step_count + bad] = (
                    av_np[:bad])
                self.step_count += bad
                raise FloatingPointError(
                    f"simulation diverged (non-finite average velocity "
                    f"at step {self.step_count}); check omega "
                    f"({self.params.omega}) and accel ({self.params.accel})"
                )
            self.av_vels[self.step_count : self.step_count + n] = av_np
            self.step_count += n
            if progress:
                print(
                    f"step {self.step_count}/{self.params.max_iters} "
                    f"av_vel={av_np[-1]:.6E}",
                    flush=True,
                )
        reyn = self.reynolds()
        return SimulationResult(
            params=self.params,
            f=self.f,
            av_vels=self.av_vels[: self.step_count].copy(),
            reynolds=reyn,
            elapsed_s=time.perf_counter() - t0,
        )

    # -- observables ------------------------------------------------------
    def reynolds(self) -> float:
        return float(calc_reynolds(self.f, self.obstacles, self.params))

    # -- persistence ------------------------------------------------------
    def write_outputs(self, out_dir: str | os.PathLike = ".") -> None:
        """Write final_state.dat + av_vels.dat; the output planes are
        computed on the device and read back once."""
        fields = [a.cpu().numpy() for a in output_fields(
            self.f, self.obstacles, self.params.density)]
        os.makedirs(out_dir, exist_ok=True)
        write_final_state(
            os.path.join(out_dir, "final_state.dat"),
            None,
            self.obstacles.cpu().numpy(),
            self.params,
            fields=fields,
        )
        write_av_vels(
            os.path.join(out_dir, "av_vels.dat"),
            self.av_vels[: self.step_count],
        )
