"""Command-line entry point of the PyTorch/CUDA port.

    python -m tpulbm_torch <paramfile> <obstaclefile> [options]

The same positional arguments, options, result block (Reynolds number,
wall/user/system time — d2q9-bgk.c:409-416), messages and exit codes as
``python -m tpulbm``; writes reference-format final_state.dat and
av_vels.dat into --out-dir. ``--device-count N`` runs a 1-D ring of N row
shards (``dist.mesh``), one per visible card by default; ``--mesh-shape
DYxDX`` a 2-D torus of dy x dx blocks; ``--device cpu --device-count 4``
runs four CPU shards on the plain versions of the kernels.
``--multihost`` runs the ring (or, with ``--mesh-shape``, the torus) over
every process of a ``torch.distributed`` group (``dist.multihost``;
``python -m tpulbm_torch.dist.launch`` or torchrun starts them), process 0
printing the result block and writing the outputs. Checkpoints are the JAX
package's npz files or, with ``--ckpt-backend dcp`` (the counterpart of
orbax), ``torch.distributed.checkpoint`` directories that each process
writes its own shards into (``sim.checkpoint``).
"""

from __future__ import annotations

import argparse
import dataclasses
import resource
import sys
import time


# the main thread's spans of the checkpoint path (lbm.ckpt.wait nests in
# lbm.ckpt.copy where a save waits on the one before)
CKPT_SPANS = ("lbm.ckpt.copy", "lbm.ckpt.wait")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpulbm_torch",
        description="D2Q9-BGK lattice-Boltzmann solver (PyTorch + CUDA)",
    )
    p.add_argument("paramfile")
    p.add_argument("obstaclefile")
    p.add_argument("--out-dir", default=".", help="output directory")
    p.add_argument(
        "--backend",
        choices=["auto", "cuda", "torch", "cuda-p2p"],
        default="auto",
        help="compute path: the hand-written CUDA kernels, the plain PyTorch "
             "oracle, cuda-p2p (the counterpart of the in-kernel-RDMA "
             "pallas-rdma: on N >= 2 shards the ring whose kernel hands the "
             "slabs between shards itself, up to 64 chunks a launch, across "
             "the processes of a host through CUDA IPC; the single-device "
             "route with a warning on one shard, the cuda ring with a "
             "warning where the ring crosses hosts), or auto (cuda on a "
             "CUDA device, torch on the CPU)",
    )
    p.add_argument(
        "--device-count",
        type=int,
        default=None,
        help="number of shards in the 1-D ring (default: all visible CUDA "
             "devices; 1 on the CPU); shard i runs on cuda:(i %% count)",
    )
    p.add_argument(
        "--mesh-shape",
        default=None,
        metavar="DYxDX",
        help="2-D torus mesh: shard BOTH grid axes, e.g. 2x4 "
             "(overrides --device-count); block (i, j) runs on "
             "cuda:((i * DX + j) %% count)",
    )
    p.add_argument(
        "--multihost",
        action="store_true",
        help="start torch.distributed (TPULBM_COORDINATOR/TPULBM_NUM_PROCS/"
             "TPULBM_PROC_ID or torchrun's MASTER_ADDR/MASTER_PORT/RANK/"
             "WORLD_SIZE env) and run over the global host-contiguous ring "
             "(or --mesh-shape torus) of every process's shards; process 0 "
             "writes outputs. See python -m tpulbm_torch.dist.launch",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to run on (default cuda; fails if no GPU is visible)",
    )
    p.add_argument(
        "--max-iters", type=int, default=None, help="override deck maxIters"
    )
    p.add_argument(
        "--chunk", type=int, default=None,
        help="steps per runner call (the av series is read back per call)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=None,
        help="save a checkpoint every N steps",
    )
    p.add_argument(
        "--checkpoint-dir", default=None, help="checkpoint directory"
    )
    p.add_argument(
        "--checkpoint-keep", type=int, default=None, metavar="N",
        help="after each checkpoint, delete the directory's oldest complete "
             "checkpoints until N remain (default: keep every one)",
    )
    p.add_argument(
        "--ckpt-backend", choices=("npz", "dcp"), default="npz",
        help="checkpoint storage: npz (single atomic file, the JAX "
             "package's format) or dcp (async sharded save with "
             "torch.distributed.checkpoint; each process writes its own "
             "shards)",
    )
    p.add_argument(
        "--resume", default=None,
        help="checkpoint file or directory to resume from",
    )
    p.add_argument(
        "--profile-dir", default=None,
        help="capture a torch.profiler trace of the step loop into this dir",
    )
    p.add_argument("--progress", action="store_true")
    p.add_argument(
        "--no-output", action="store_true",
        help="skip writing final_state.dat/av_vels.dat (like PROFILE builds "
             "of the reference, d2q9-bgk.c:419-421)",
    )
    p.add_argument(
        "--metrics-file", default=None,
        help="append one JSON line per chunk (step, av_vel, wall time, "
             "throughput) — live observability for dashboards",
    )
    p.add_argument(
        "--debug", action="store_true",
        help="print av_velocity and total_density each chunk (the reference's "
             "DEBUG block, d2q9-bgk.c:380-393)",
    )
    p.add_argument(
        "--launch-counts", default=None, metavar="FILE",
        help="write the kernel launches of this run (ops._build.LAUNCHES) "
             "as one JSON object to FILE (FILE.<process> under --multihost)",
    )
    return p


def die(message: str) -> "int":
    """Reference-style fatal error (d2q9-bgk.c:1145-1151): one clean line on
    stderr, exit status 1 — no traceback."""
    print(f"Error: {message}", file=sys.stderr, flush=True)
    return 1


def k2_line(counted: dict):
    """The line of K2's own counters (``ops.resident.counters()``): a
    step's time and the shares of its warps' time, the mean over the cards
    that counted a launch; None where none did."""
    cards = [w for w in counted.values() if w["launches"] and w["warp_ns"]]
    if not cards:
        return None

    def mean(value):
        return sum(value(w) for w in cards) / len(cards)

    step = mean(lambda w: (w["warp_ns"] - w["ends_ns"]) / w["warp_steps"])
    cell, barrier, fill, spin, ends = (
        mean(lambda w, key=key: 100 * w[key] / w["warp_ns"])
        for key in ("cell_ns", "barrier_ns", "fill_ns", "spin_ns",
                    "ends_ns"))
    return (f"K2: {step:.0f} ns a step; its warps {cell:.1f} % on cells, "
            f"{barrier:.1f} % at the step barrier, {fill:.1f} % on "
            f"neighbours' edges ({spin:.1f} % spinning), {ends:.1f} % "
            f"loading and reducing")


def _mesh_shape(text):
    dy, sep, dx = text.partition("x")
    if not sep or not dy.isdigit() or not dx.isdigit():
        return None
    return int(dy), int(dx)


def _start_processes(args):
    """--multihost: start the process group with its transport fixed
    before the run (printed on stderr); returns the global mesh."""
    import torch

    from tpulbm_torch.dist import multihost

    env = multihost.dist_env()
    shape = _mesh_shape(args.mesh_shape) if args.mesh_shape else None
    if shape:
        n = shape[0] * shape[1]
    elif args.device_count is not None:
        n = args.device_count
    else:
        n = env.world * multihost.local_shard_count(args.device)
    if n < 1 or n % env.world:
        raise ValueError(f"{n} shards do not split evenly over "
                         f"{env.world} processes")
    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    backend = multihost.choose_transport(args.device, n // env.world,
                                         env.local_world, cards)
    multihost.init_distributed(backend)
    info = multihost.process_mesh_info()
    mesh = (multihost.global_torus_mesh(*shape, device=args.device) if shape
            else multihost.global_ring_mesh(n, device=args.device))
    print(f"multihost: process {info['process_index']}/"
          f"{info['process_count']}, {n // info['process_count']} local / "
          f"{n} global shards, transport {info['transport'] or 'none'}",
          file=sys.stderr, flush=True)
    return mesh


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return _main(args)
    finally:
        if args.multihost:
            from tpulbm_torch.dist import multihost

            multihost.shutdown()


def _main(args) -> int:
    import json

    import numpy as np
    import torch

    from tpulbm_torch.dist.mesh import get_mesh, get_mesh_2d
    from tpulbm_torch.io.obstacles import ObstacleFileError
    from tpulbm_torch.io.params_file import ParamFileError
    from tpulbm_torch.sim import checkpoint as ckpt
    from tpulbm_torch.sim.simulation import Simulation
    from tpulbm_torch.utils.profiling import totals, trace_region

    if args.device == "cuda" and not torch.cuda.is_available():
        return die("--device cuda, but no CUDA device is available "
                   "(torch.cuda.is_available() is false)")
    if args.mesh_shape and not _mesh_shape(args.mesh_shape):
        return die(f"--mesh-shape must be DYxDX (e.g. 2x4), "
                   f"got {args.mesh_shape!r}")
    if args.multihost:
        try:
            mesh = _start_processes(args)
        except Exception as e:  # coordinator unreachable, bad env, ...
            return die(f"torch.distributed initialization failed: {e}")
    try:
        if not args.multihost:
            mesh = (get_mesh_2d(*_mesh_shape(args.mesh_shape),
                                device=args.device) if args.mesh_shape
                    else get_mesh(n_devices=args.device_count,
                                  device=args.device))
        sim = Simulation.from_files(
            args.paramfile, args.obstaclefile, backend=args.backend,
            device=args.device, mesh=mesh, ckpt_backend=args.ckpt_backend,
        )
    except FileNotFoundError as e:
        return die(f"could not open input file: {e.filename}")
    except (ParamFileError, ObstacleFileError, ValueError) as e:
        return die(str(e))
    if args.max_iters is not None:
        sim.params = dataclasses.replace(sim.params, max_iters=args.max_iters)
        sim.av_vels = np.zeros((args.max_iters,), dtype=np.float32)
    if args.resume:
        try:
            sim.restore_checkpoint(args.resume)
        except (FileNotFoundError, ValueError) as e:
            return die(f"cannot resume: {e}")

    sim.settle()
    before = totals().get("lbm.dist.exchange", (0, 0.0))
    ckpt_before = (dict(ckpt.STATS), *(totals().get(name, (0, 0.0))[1]
                                       for name in CKPT_SPANS))
    tic = time.time()
    try:
        with trace_region("mainloop",
                          args.profile_dir if sim.output else None):
            result = sim.run(
                chunk=args.chunk,
                checkpoint_every=args.checkpoint_every,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_keep=args.checkpoint_keep,
                progress=args.progress,
                debug=args.debug,
                metrics_file=args.metrics_file,
            )
    except (ValueError, FloatingPointError) as e:
        return die(str(e))
    toc = time.time()
    ru = resource.getrusage(resource.RUSAGE_SELF)

    # Same result block as the reference MASTER rank (d2q9-bgk.c:409-416);
    # under --multihost only process 0 prints, like MASTER.
    if sim.output:
        print("==done==")
        print("Reynolds number:\t\t%.12E" % result.reynolds)
        print("Elapsed time:\t\t\t%.6f (s)" % (toc - tic))
        print("Elapsed user CPU time:\t\t%.6f (s)" % ru.ru_utime)
        print("Elapsed system CPU time:\t%.6f (s)" % ru.ru_stime)
    tr = sim.transport
    chunks, seconds = (a - b for a, b in zip(
        totals().get("lbm.dist.exchange", (0, 0.0)), before))
    if args.multihost and sim.output and chunks:
        print(f"multihost: transport {tr.backend}, {chunks} chunks, "
              f"host exchange {seconds / chunks * 1e6:.1f} us a chunk",
              file=sys.stderr, flush=True)
    # the checkpoint path's cost: the writer thread's saves (checkpoint.STATS)
    # and the main thread's time in its spans
    stats, *spent = ckpt_before
    saves = ckpt.STATS["saves"] - stats["saves"]
    if sim.output and saves:
        copy, wait = (totals().get(name, (0, 0.0))[1] - s
                      for name, s in zip(CKPT_SPANS, spent))
        write_ms = (ckpt.STATS["write_ns"] - stats["write_ns"]) / saves / 1e6
        mb = (ckpt.STATS["bytes"] - stats["bytes"]) / 1e6
        print(f"checkpoints: {saves} written ({mb:.1f} MB), "
              f"{ckpt.STATS['removed'] - stats['removed']} removed, "
              f"{write_ms:.1f} ms a write on the writer thread; the main "
              f"thread {1e3 * copy:.1f} ms in lbm.ckpt.copy, "
              f"{1e3 * wait:.1f} ms in lbm.ckpt.wait, "
              f"{ckpt.STATS['held'] - stats['held']} held",
              file=sys.stderr, flush=True)
    from tpulbm_torch.ops import ring_p2p

    # K6's own wait counters (cuda-p2p, the torus and the grid kind), the
    # mean over this process's cards; the grid kind's waits for the rows
    # it loads where it counted any
    waits = [w for w in ring_p2p.WAITS.values() if w["cta_ns"]]
    if sim.output and waits:
        wait, remote, fill = (
            100 * sum(w[key] / w["cta_ns"] for w in waits) / len(waits)
            for key in ("wait_ns", "remote_ns", "fill_ns"))
        rows = f", {fill:.1f} % on the rows it loads" if fill else ""
        where = " (process 0's cards)" if args.multihost else ""
        print(f"K6 waited {wait:.1f} % of its CTA time on neighbours' flags "
              f"({remote:.1f} % on other cards'){rows}{where}",
              file=sys.stderr, flush=True)
    from tpulbm_torch.ops import resident

    # K2's own counters, where it counted (a --profile-dir run)
    line = k2_line(resident.counters())
    if sim.output and line:
        print(line, file=sys.stderr, flush=True)

    # The grid kind's item shape (the one-card route outside the resident
    # gate): which items the run's launches stepped
    from tpulbm_torch.ops import _build

    if sim.output and _build.LAUNCHES["grid_p2p"]:
        p = sim.params
        h, w, ratio = ring_p2p.grid_item(p.ny, p.nx)
        print(f"grid kind: {p.ny} x {p.nx} in {h} x {w} items, {ratio:.3f} "
              f"updates computed an owned one", file=sys.stderr, flush=True)

    if not args.no_output:
        sim.write_outputs(args.out_dir)
    if args.launch_counts:
        path = args.launch_counts
        if args.multihost:
            path = f"{path}.{tr.rank}"
        with open(path, "w") as fh:
            json.dump(_build.LAUNCHES, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
