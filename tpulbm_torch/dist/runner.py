"""The single-device step-loop runner.

``make_runner(params, n_steps, backend, device)`` returns
``runner(f, obstacles) -> (f', av_vels)``: ``f`` the (9, ny, nx) float32
state, ``obstacles`` the (ny, nx) bool mask, both on ``device``;
``av_vels`` the (n_steps,) float32 series on the same device, each step's
sum of |u| over free cells times ``free_cells_inv`` (params.py:32). The
series is read back by the caller once per runner call, never per step.

Backends (the single-device routing of tpulbm/dist/runner.py:1720-1801):

- ``cuda``: the hand-written kernels, on the family that ``dist.tiers``
  names for the grid. ``"resident"`` runs ``resident.resident_chunk`` (K2)
  in chunks of ``resident.RESIDENT_K`` steps plus a remainder, as
  ``_make_resident_runner``; ``"fused"`` runs ``kstep.skew_chunk`` (K1, 8
  steps) and ``kstep.kstep_chunk`` for the sub-8 remainder, as
  ``_make_skew_runner``; ``"tile"`` runs ``kstep_tile.tile_chunk`` (K4) in
  8-step chunks plus one remainder chunk, as the fold, 2-D skew and 2-D
  K-step runners. The kernels take any shape, so the TPU tiers' 8/128
  alignment conditions only choose the route.
- ``torch``: the plain oracle ``ops.step_torch`` (canonical equilibrium, as
  the JAX package's ``jnp`` backend), on any device.
- ``auto``: ``cuda`` on a CUDA device, ``torch`` on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.dist import tiers
from tpulbm_torch.ops import kstep, kstep_tile, resident, step_torch

BACKENDS = ("auto", "cuda", "torch")


def resolve_backend(backend: str, device) -> str:
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend 'cuda' runs the CUDA kernels and needs a CUDA device, "
            f"got {device}")
    return backend


def _chunks(fn, k: int, n_steps: int, rem_fn=None) -> list:
    """[(fn, k)] * (n_steps // k) plus [(rem_fn or fn, the remainder)]."""
    n_full, rem = divmod(n_steps, k)
    return [(fn, k)] * n_full + ([(rem_fn or fn, rem)] if rem else [])


def kernel_plan(params: LBMParams, n_steps: int) -> list:
    """The ``cuda`` backend's chunks: [(chunk_fn, k), ...] covering n_steps.
    Each chunk_fn(f, obst_f, params, k) returns (f', raw sums[k])."""
    route = tiers.family(params.ny, params.nx, n_steps)
    if route == "resident":
        return _chunks(resident.resident_chunk,
                       min(n_steps, resident.RESIDENT_K), n_steps)
    if route == "tile":
        return _chunks(kstep_tile.tile_chunk, kstep_tile.TILE_K, n_steps)
    return _chunks(_skew, kstep.SKEW_K, n_steps, kstep.kstep_chunk)


def _skew(f, obst_f, params, k):
    return kstep.skew_chunk(f, obst_f, params)


def run_plan(plan, f, obst_f, params: LBMParams):
    """Run the chunks of ``plan`` from state ``f``; returns (f', av_vels)."""
    sums = []
    for chunk_fn, k in plan:
        f, s = chunk_fn(f, obst_f, params, k)
        sums.append(s)
    free_inv = torch.tensor(params.free_cells_inv, dtype=torch.float32,
                            device=f.device)
    return f, torch.cat(sums) * free_inv


def make_runner(params: LBMParams, n_steps: int, backend: str = "auto",
                device="cuda") -> Callable:
    device = torch.device(device)
    backend = resolve_backend(backend, device)

    def check_device(f, obstacles):
        for t in (f, obstacles):
            if t.device.type != device.type:
                raise ValueError(
                    f"runner built for backend {backend!r} on {device} got "
                    f"a tensor on {t.device}")

    if backend == "torch":
        def runner(f, obstacles):
            check_device(f, obstacles)
            return step_torch.run_steps(f, obstacles, params, n_steps)

        return runner

    plan = kernel_plan(params, n_steps)

    def runner(f, obstacles):
        check_device(f, obstacles)
        return run_plan(plan, f, obstacles.to(torch.float32), params)

    return runner
