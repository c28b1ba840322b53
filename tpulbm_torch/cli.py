"""Command-line entry point of the PyTorch/CUDA port.

    python -m tpulbm_torch <paramfile> <obstaclefile> [options]

The same positional arguments, result block (Reynolds number, wall/user/
system time — d2q9-bgk.c:409-416) and exit codes as ``python -m tpulbm``;
writes reference-format final_state.dat and av_vels.dat into --out-dir.
``--device-count N`` runs a 1-D ring of N row shards (``dist.mesh``), one
per visible card by default; ``--device cpu --device-count 4`` runs four
CPU shards on the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import resource
import sys
import time


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
             "oracle, cuda-p2p (the in-kernel-RDMA variant's name: the cuda "
             "ring on N >= 2 shards, the single-device route with a warning "
             "on one), or auto (cuda on a CUDA device, torch on the CPU)",
    )
    p.add_argument(
        "--device-count",
        type=int,
        default=None,
        help="number of shards in the 1-D ring (default: all visible CUDA "
             "devices; 1 on the CPU); shard i runs on cuda:(i %% count)",
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
    p.add_argument("--progress", action="store_true")
    p.add_argument(
        "--no-output", action="store_true",
        help="skip writing final_state.dat/av_vels.dat (like PROFILE builds "
             "of the reference, d2q9-bgk.c:419-421)",
    )
    return p


def die(message: str) -> "int":
    """Reference-style fatal error (d2q9-bgk.c:1145-1151): one clean line on
    stderr, exit status 1 — no traceback."""
    print(f"Error: {message}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from tpulbm_torch.dist.mesh import get_mesh
    from tpulbm_torch.io.obstacles import ObstacleFileError
    from tpulbm_torch.io.params_file import ParamFileError
    from tpulbm_torch.sim.simulation import Simulation

    if args.device == "cuda" and not torch.cuda.is_available():
        return die("--device cuda, but no CUDA device is available "
                   "(torch.cuda.is_available() is false)")
    try:
        mesh = get_mesh(n_devices=args.device_count, device=args.device)
        sim = Simulation.from_files(
            args.paramfile, args.obstaclefile, backend=args.backend,
            device=args.device, mesh=mesh,
        )
    except FileNotFoundError as e:
        return die(f"could not open input file: {e.filename}")
    except (ParamFileError, ObstacleFileError, ValueError) as e:
        return die(str(e))
    if args.max_iters is not None:
        sim.params = dataclasses.replace(sim.params, max_iters=args.max_iters)
        sim.av_vels = np.zeros((args.max_iters,), dtype=np.float32)

    sim.settle()
    tic = time.time()
    try:
        result = sim.run(chunk=args.chunk, progress=args.progress)
    except (ValueError, FloatingPointError) as e:
        return die(str(e))
    toc = time.time()
    ru = resource.getrusage(resource.RUSAGE_SELF)

    # Same result block as the reference MASTER rank (d2q9-bgk.c:409-416).
    print("==done==")
    print("Reynolds number:\t\t%.12E" % result.reynolds)
    print("Elapsed time:\t\t\t%.6f (s)" % (toc - tic))
    print("Elapsed user CPU time:\t\t%.6f (s)" % ru.ru_utime)
    print("Elapsed system CPU time:\t%.6f (s)" % ru.ru_stime)

    if not args.no_output:
        sim.write_outputs(args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
