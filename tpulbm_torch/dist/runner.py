"""The step-loop runners: one device, and the 1-D ring of shards.

``make_runner(params, n_steps, backend, device, mesh=None)`` returns, on one
device, ``runner(f, obstacles) -> (f', av_vels)``: ``f`` the (9, ny, nx)
float32 state, ``obstacles`` the (ny, nx) bool mask, both on ``device``;
``av_vels`` the (n_steps,) float32 series on the same device, each step's
sum of |u| over free cells times ``free_cells_inv`` (params.py:32). The
series is read back by the caller once per runner call, never per step.

With a ``mesh`` (``dist.mesh.get_mesh``) of N >= 2 devices it returns the
ring runner, ``runner(shards, obst_shards) -> (shards', av_vels)``: the
lists of row shards of ``dist.sharding.shard_rows``, shard i on mesh[i];
``av_vels`` on mesh[0]. The ring is the counterpart of the JAX package's
``shard_map`` runners (tpulbm/dist/runner.py:110-1098,1870-1905): every
chunk of k <= 8 steps, each shard's last k rows go to the next shard's lo
slab and its first k rows to the previous shard's hi slab (the ``_ring_slabs``
of runner.py:110-128; the wrap is the periodic y boundary), and one
``kstep_tile.ring_chunk`` (K4 ring mode) steps each shard. k is the least of
8, the smallest shard's rows and the steps left. Each shard keeps its raw
per-step sums on its own device; they are added once after the loop, on
mesh[0], in shard order, and scaled by ``free_cells_inv`` (the deferred
``psum`` of runner.py:1884-1887, d2q9-bgk.c:367-374). Shards follow
``decompose_rows``, so any ny runs without padding.

Backends (the single-device routing of tpulbm/dist/runner.py:1720-1801):

- ``cuda``: the hand-written kernels, on the family that ``dist.tiers``
  names for the grid. ``"resident"`` runs ``cluster.cluster_resident_chunk``
  (K5) where ``cluster.resident_route`` (128^2), else
  ``resident.resident_chunk`` (K2: 128x256, 256^2, where K5 measured no
  faster, and the 100K-135K-cell shapes beyond one cluster), in chunks of
  ``resident.RESIDENT_K`` steps plus a remainder, as
  ``_make_resident_runner``; ``"fused"`` (``_make_skew_runner``) and
  ``"tile"`` (the fold, 2-D skew and 2-D K-step runners) run
  ``kstep_tile.tile_chunk`` (K4) in 8-step chunks plus one remainder chunk.
  The kernels take any shape, so the TPU tiers' 8/128 alignment conditions
  only choose the route. K1 (``kstep.skew_chunk``, ``kstep.kstep_chunk``)
  is on no route: it is the one-pass-per-step kernel that ``chip_smoke.py``
  holds K4 against.
- ``torch``: the plain oracle ``ops.step_torch`` (canonical equilibrium, as
  the JAX package's ``jnp`` backend), on any device.
- ``auto``: ``cuda`` on a CUDA device, ``torch`` on the CPU.

On a ring, ``cuda`` copies the slabs on each device's compute stream (peer
copies between cards) and launches ``ring_chunk`` once per shard; ``torch``
runs its plain version (canonical equilibrium) per shard. ``cuda-p2p`` is
the counterpart of ``--backend pallas-rdma`` (``pallas_kstep_rdma``,
``pallas_resident_rdma``, whose slab exchange runs inside the kernel): as in
the JAX package, on one device it says so and runs the single-device route;
on a ring it runs the ``cuda`` ring. Copies on a side stream that overlap
the interior rows' steps measured no gain worth their schedule on four
H100s (PERF.md).
"""

from __future__ import annotations

import sys
from typing import Callable, Sequence

import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.dist import tiers
from tpulbm_torch.dist.sharding import ring_rows
from tpulbm_torch.ops import cluster, kstep, kstep_tile, resident, step_torch

BACKENDS = ("auto", "cuda", "torch", "cuda-p2p")


def resolve_backend(backend: str, device) -> str:
    device = torch.device(device)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend in ("cuda", "cuda-p2p") and device.type != "cuda":
        raise ValueError(
            f"backend {backend!r} runs the CUDA kernels and needs a CUDA "
            f"device, got {device}")
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
        fn = (cluster.cluster_resident_chunk
              if cluster.resident_route(params.ny, params.nx)
              else resident.resident_chunk)
        return _chunks(fn, min(n_steps, resident.RESIDENT_K), n_steps)
    return _chunks(kstep_tile.tile_chunk, kstep_tile.TILE_K, n_steps)


def _skew(f, obst_f, params, k):
    """K1's 8-step chunk as a plan's chunk function (off every route)."""
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
                device="cuda", mesh: Sequence | None = None) -> Callable:
    if mesh is not None and len(mesh) > 1:
        mesh = [torch.device(d) for d in mesh]
        backend = resolve_backend(backend, mesh[0])
        return make_ring_runner(
            params, n_steps, mesh,
            _plain_ring if backend == "torch" else kstep_tile.ring_chunk)
    device = torch.device(device if mesh is None else mesh[0])
    if backend == "cuda-p2p":
        # The JAX package's route for pallas-rdma on one device
        # (tpulbm/dist/runner.py:1709-1719)
        print(f"tpulbm_torch: cuda-p2p unsupported for local shape "
              f"({params.ny}, {params.nx}) on 1 devices; falling back to the "
              f"single-device route", file=sys.stderr, flush=True)
        backend = "cuda"
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


def _plain_ring(lo, shard, hi, obst_band, params, k, row_base):
    """The ``torch`` backend's shard step: the plain ring chunk with the
    canonical equilibrium, as ``step_torch.run_steps``."""
    return kstep_tile.ring_chunk_ref(lo, shard, hi, obst_band, params, k,
                                     row_base, pair_symmetric=False)


def _copy_slabs(k: int, shards, mesh):
    """The ring's slab copies, on each device's compute stream: [(lo, hi)]
    per shard."""
    n = len(shards)
    return [(shards[(d - 1) % n][:, -k:].to(dev).contiguous(),
             shards[(d + 1) % n][:, :k].to(dev).contiguous())
            for d, dev in enumerate(mesh)]


def make_ring_runner(params: LBMParams, n_steps: int,
                     mesh: Sequence[torch.device],
                     chunk_fn: Callable) -> Callable:
    """The ring runner over ``mesh`` (see the module docstring).
    ``chunk_fn(lo, shard, hi, obst_band, params, k, row_base)`` steps one
    shard: ``kstep_tile.ring_chunk`` (which takes its plain version on CPU
    tensors) or ``_plain_ring``."""
    mesh = list(mesh)
    n, ny, nx = len(mesh), params.ny, params.nx
    rows, offsets = ring_rows(ny, n)
    if n_steps < 1:
        raise ValueError(f"ring runner of {n_steps} steps")
    k_max = min(kstep_tile.TILE_K, min(rows), n_steps)
    plan = [k for _, k in _chunks(None, k_max, n_steps)]

    def runner(shards, obst_shards):
        if len(shards) != n or len(obst_shards) != n:
            raise ValueError(f"ring runner over {n} shards got "
                             f"{len(shards)} and {len(obst_shards)}")
        for d, (f, o) in enumerate(zip(shards, obst_shards)):
            if (f.shape != (9, rows[d], nx) or o.shape != (rows[d], nx)
                    or f.device != mesh[d] or o.device != mesh[d]):
                raise ValueError(
                    f"shard {d}: state {tuple(f.shape)} on {f.device}, mask "
                    f"{tuple(o.shape)} on {o.device}; the ring wants rows "
                    f"{rows[d]} of the ({ny}, {nx}) grid on {mesh[d]}")
        # Shard d's (h + 2 k_max, nx) mask band; a chunk of k steps takes
        # its rows [k_max - k, k_max + h + k).
        masks = [torch.cat([o.to(mesh[d], torch.float32) for o in (
                     obst_shards[(d - 1) % n][-k_max:], obst_shards[d],
                     obst_shards[(d + 1) % n][:k_max])])
                 for d in range(n)]
        shards = list(shards)
        sums = [[] for _ in range(n)]
        for k in plan:
            new = []
            for d, (lo, hi) in enumerate(_copy_slabs(k, shards, mesh)):
                band = masks[d][k_max - k:k_max + rows[d] + k]
                f, s = chunk_fn(lo, shards[d], hi, band, params, k,
                                (offsets[d] - k) % ny)
                new.append(f)
                sums[d].append(s)
            shards = new
        av = None
        for d in range(n):   # the deferred reduction, in shard order
            s = torch.cat(sums[d]).to(mesh[0])
            av = s if av is None else av + s
        free_inv = torch.tensor(params.free_cells_inv, dtype=torch.float32,
                                device=mesh[0])
        return shards, av * free_inv

    return runner
