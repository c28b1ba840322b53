"""Paired, alternating timing of the ring runner on several backends.

    python -m tpulbm_torch.tools.ring_ab data/input_8192x8192.params \\
        data/obstacles_8192x8192.dat --device-count 4 \\
        --backends cuda,cuda-p2p --pairs 4

Loads the deck once, cuts its rest state into the ring's shards
(``dist.sharding.shard_rows``) and builds one runner of the deck's step
count per backend. After a warm-up call of each, it times ``--pairs``
rounds, the backends in order on even rounds and reversed on odd ones (so
A B B A ...): every call from a fresh copy of the same input shards, made
before the clock starts (a runner call takes its input over and leaves a
later state in it); the clock stopped after every card has finished and
the av series is read back. Prints one line per call, then one JSON line
of the samples and each backend's median MLUPS. A change that moves a
backend by less than the spread of its own samples is not shown by this
run.
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
from tpulbm_torch.dist.mesh import get_mesh
from tpulbm_torch.dist.runner import make_runner
from tpulbm_torch.dist.sharding import shard_rows
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params


def _sync(mesh) -> None:
    for dev in set(mesh):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("param_file")
    ap.add_argument("obstacle_file")
    ap.add_argument("--device-count", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backends", default="cuda,cuda-p2p")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--max-iters", type=int, default=None)
    args = ap.parse_args(argv)

    params = read_params(args.param_file)
    if args.max_iters is not None:
        params = dataclasses.replace(params, max_iters=args.max_iters)
    mask, n_free = read_obstacles(args.obstacle_file, params.nx, params.ny)
    params = params.with_free_cells(n_free)
    mesh = get_mesh(args.device_count, args.device)
    if mesh[0].type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        print(smi.stdout.strip(), flush=True)
    obst = torch.as_tensor(mask, device=mesh[0])
    shards, obst_shards = shard_rows(initial_state(params, mesh[0]), obst,
                                     mesh)
    backends = args.backends.split(",")
    steps = params.max_iters
    runners = {b: make_runner(params, steps, b, mesh=mesh) for b in backends}
    for b in backends:   # warm-up: kernel build, first launches
        runners[b]([s.clone() for s in shards], obst_shards)[1].cpu()
    samples = {b: [] for b in backends}
    for r in range(args.pairs):
        for b in (backends if r % 2 == 0 else backends[::-1]):
            state = [s.clone() for s in shards]
            _sync(mesh)
            t0 = time.perf_counter()
            _, av = runners[b](state, obst_shards)
            av.cpu()
            _sync(mesh)
            sec = time.perf_counter() - t0
            mlups = params.nx * params.ny * steps / sec / 1e6
            samples[b].append(mlups)
            print(f"[ab] round {r} {b}: {sec:.4f} s, {mlups:.1f} MLUPS",
                  flush=True)
    layout = ",".join(str(d) for d in mesh)
    print(json.dumps({
        "grid": [params.ny, params.nx], "steps": steps, "layout": layout,
        "mlups": samples,
        "median_mlups": {b: statistics.median(v) for b, v in samples.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
