"""Paired, alternating timing of the ring or torus runner on several
backends.

    python -m tpulbm_torch.tools.ring_ab data/input_8192x8192.params \\
        data/obstacles_8192x8192.dat --device-count 4 \\
        --backends cuda,cuda-p2p --pairs 4
    python -m tpulbm_torch.tools.ring_ab data/input_1024x1024.params \\
        data/obstacles_1024x1024.dat --mesh-shape 2x2
    python -m tpulbm_torch.dist.launch --local-smoke 2x2 \\
        --module tpulbm_torch.tools.ring_ab data/input_1024x1024.params \\
        data/obstacles_1024x1024.dat --mesh-shape 2x2

Loads the deck once, cuts its rest state into the ring's shards
(``dist.sharding.shard_rows``) or, with ``--mesh-shape DYxDX``, the
torus's blocks (``shard_blocks``), and builds one runner of the deck's
step count per backend. The torus's backends are its routes: ``p2p``,
the one-process torus of the ``cuda`` backend (``make_runner``: torus
mode of K6, the exchange inside the kernel, where its limits hold), and
``k4``, K4's torus mode a block and chunk with the host's two-phase
exchange (``make_torus_runner`` with ``kstep_tile.torus_chunk``, over the
``Transport``). With ``--multihost`` (one process of a group, as
``dist.launch --local-smoke PxL --module tpulbm_torch.tools.ring_ab``
starts them) the mesh is the global one, each process times its own
shards or blocks, and process 0 prints. After a warm-up call of each,
whose states must be bitwise those of the first backend's (the routes
compute one function), it times ``--pairs`` rounds, the backends in order
on even rounds and reversed on odd ones (so A B B A ...): every call from
a fresh copy of the same input shards, made before the clock starts (a
runner call takes its input over and leaves a later state in it); the
clock started after every card (and process) has finished the work before
it, stopped after every card has finished and the av series is read back
(it is gathered from every process). Prints one line per call, then one
JSON line of the samples and each backend's median MLUPS. A change that
moves a backend by less than the spread of its own samples is not shown by
this run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import torch

from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import multihost
from tpulbm_torch.dist.mesh import get_mesh, get_mesh_2d
from tpulbm_torch.dist.runner import make_runner, make_torus_runner
from tpulbm_torch.dist.sharding import shard_blocks, shard_rows
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import kstep_tile


def _sync(devices) -> None:
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _torus_runner(route, params, steps, mesh, transport):
    if route == "p2p":
        return make_runner(params, steps, "cuda", mesh=mesh,
                           transport=transport)
    if route == "k4":
        return make_torus_runner(params, steps, mesh, kstep_tile.torus_chunk,
                                 transport)
    raise ValueError(f"the torus's routes are p2p and k4, not {route!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("param_file")
    ap.add_argument("obstacle_file")
    ap.add_argument("--device-count", type=int, default=None)
    ap.add_argument("--mesh-shape", default=None,
                    help="DYxDX: the torus's routes (p2p, k4) in place of "
                         "the ring's backends")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backends", default=None,
                    help="default cuda,cuda-p2p (ring) or p2p,k4 (torus)")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--multihost", action="store_true",
                    help="one process of a group: the global mesh")
    args = ap.parse_args(argv)
    try:
        return _main(args)
    finally:
        if args.multihost:
            multihost.shutdown()


def _main(args) -> int:
    """The timing of ``main``'s parsed arguments."""
    params = read_params(args.param_file)
    if args.max_iters is not None:
        params = dataclasses.replace(params, max_iters=args.max_iters)
    mask, n_free = read_obstacles(args.obstacle_file, params.nx, params.ny)
    params = params.with_free_cells(n_free)
    steps = params.max_iters
    if args.multihost:
        from tpulbm_torch.cli import _start_processes

        mesh = _start_processes(args)
    elif args.mesh_shape:
        mesh = get_mesh_2d(*map(int, args.mesh_shape.lower().split("x")),
                           args.device)
    else:
        mesh = get_mesh(args.device_count, args.device)
    every = [d for row in mesh for d in row] if args.mesh_shape else mesh
    tr = multihost.Transport(every)
    devices = [d for d in every if d is not None]
    if args.mesh_shape:
        backends = (args.backends or "p2p,k4").split(",")
        runners = {b: _torus_runner(b, params, steps, mesh, tr)
                   for b in backends}
        cut = shard_blocks
    else:
        backends = (args.backends or "cuda,cuda-p2p").split(",")
        runners = {b: make_runner(params, steps, b, mesh=mesh, transport=tr)
                   for b in backends}
        cut = shard_rows
    say = tr.rank == 0
    if devices[0].type == "cuda" and say:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(smi.stdout.strip(), flush=True)
    obst = torch.as_tensor(mask, device=devices[0])
    shards, obst_shards = cut(initial_state(params, devices[0]), obst, mesh)
    same, first = {}, None
    for b in backends:   # warm-up: kernel build, first launches
        out, av = runners[b]([s.clone() for s in shards], obst_shards)
        av.cpu()
        first = first or out
        same[b] = not tr.any(not all(torch.equal(x, y)
                                     for x, y in zip(out, first)))
        del out
    samples = {b: [] for b in backends}
    for r in range(args.pairs):
        for b in (backends if r % 2 == 0 else backends[::-1]):
            state = [s.clone() for s in shards]
            _sync(devices)
            tr.barrier()
            t0 = time.perf_counter()
            _, av = runners[b](state, obst_shards)
            av.cpu()
            _sync(devices)
            sec = time.perf_counter() - t0
            mlups = params.nx * params.ny * steps / sec / 1e6
            samples[b].append(mlups)
            if say:
                print(f"[ab] round {r} {b}: {sec:.4f} s, {mlups:.1f} MLUPS",
                      flush=True)
    if say:
        print(json.dumps({
            "grid": [params.ny, params.nx], "steps": steps,
            "layout": ",".join(str(d) for d in devices),
            "processes": tr.world, "mesh_shape": args.mesh_shape,
            "same_state": same, "mlups": samples,
            "median_mlups": {b: statistics.median(v)
                             for b, v in samples.items()},
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
