"""Start a multi-process run: the counterpart of
``scripts/launch_multihost.sh`` (and of the reference's PBS submit script,
mpi_submit:1-64).

    python -m tpulbm_torch.dist.launch [--local-smoke PxL] [--timeout S] \\
        [--module M] <paramfile> <obstaclefile> [CLI options]

Without ``--local-smoke`` it runs one process of the CLI with
``--multihost``, for a host of a group whose environment is already set:
``TPULBM_COORDINATOR`` (``host:port`` or a ``file://`` URL),
``TPULBM_NUM_PROCS`` and ``TPULBM_PROC_ID`` on each host, as the JAX
package's launcher takes them. ``torchrun --nproc-per-node P -m
tpulbm_torch ... --multihost`` starts a group as well.

``--local-smoke PxL`` starts P processes of L shards each on this machine
(``TPULBM_LOCAL_SHARDS=L``; local rank i on ``cuda:((i L + j) % cards)``),
which meet at a ``file://`` store in a fresh temporary directory. On the
``cuda`` device it builds the kernel library once before it starts them,
so they load it instead of compiling it all at once. When one process
fails (or ``--timeout`` seconds pass) it stops the others; it exits with
the first non-zero code (124 on the timeout). ``--module M`` runs
``python -m M`` in place of the CLI, with the same arguments and
``--multihost`` (``tpulbm_torch.tools.ring_ab`` times a ring's or torus's
routes in turns across the processes). As torchrun, it sets
``OMP_NUM_THREADS`` (the machine's cores over P) where it is not set, and
it points gloo's and NCCL's sockets at the loopback interface
(``GLOO_SOCKET_IFNAME``, ``NCCL_SOCKET_IFNAME``) unless told otherwise.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _option(args, name, default=None):
    """The value of ``--name VALUE`` or ``--name=VALUE`` in ``args``."""
    for i, a in enumerate(args):
        if a == name and i + 1 < len(args):
            return args[i + 1]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return default


def _stop(procs, grace_s: float = 5.0) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def local_smoke(procs: int, shards: int, cli_args, timeout=None,
                module: str = "tpulbm_torch") -> int:
    """Run ``python -m <module> <cli_args> --multihost`` in ``procs`` local
    processes of ``shards`` shards each; returns the exit code."""
    if (_option(cli_args, "--device", "cuda") == "cuda"
            and _option(cli_args, "--backend") != "torch"):
        from tpulbm_torch.ops import _build

        _build.build()
    store = tempfile.mkdtemp(prefix="tpulbm_torch_launch_")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    # as torchrun, keep the processes' CPU threads from oversubscribing
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1)
                                               // procs)))
    # the processes are local: their sockets use the loopback interface
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.update(TPULBM_COORDINATOR=f"file://{store}/store",
               TPULBM_NUM_PROCS=str(procs), TPULBM_LOCAL_SHARDS=str(shards),
               LOCAL_WORLD_SIZE=str(procs))
    cmd = [sys.executable, "-m", module, *cli_args, "--multihost"]
    running = []
    rc = 0
    try:
        for i in range(procs):
            running.append(subprocess.Popen(cmd, env=dict(
                env, TPULBM_PROC_ID=str(i), LOCAL_RANK=str(i))))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in running]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                rc = failed[0]
                print(f"tpulbm_torch.dist.launch: a process exited {rc}; "
                      f"stopping the others", file=sys.stderr, flush=True)
                break
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                rc = 124
                print(f"tpulbm_torch.dist.launch: {timeout} s passed; "
                      f"stopping the processes", file=sys.stderr, flush=True)
                break
            time.sleep(0.05)
    finally:
        _stop(running)
        shutil.rmtree(store, ignore_errors=True)
    return rc


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    shape, timeout, module = None, None, "tpulbm_torch"
    while args and args[0] in ("--local-smoke", "--timeout", "--module"):
        if len(args) < 2:
            print(f"Error: {args[0]} needs a value", file=sys.stderr)
            return 2
        if args[0] == "--local-smoke":
            shape = args[1]
        elif args[0] == "--module":
            module = args[1]
        else:
            timeout = float(args[1])
        args = args[2:]
    if shape is None:
        return subprocess.call([sys.executable, "-m", module, *args,
                                "--multihost"], timeout=timeout)
    procs, sep, shards = shape.partition("x")
    if not (sep and procs.isdigit() and shards.isdigit()
            and int(procs) >= 1 and int(shards) >= 1):
        print(f"Error: --local-smoke must be PxL (e.g. 2x2), got {shape!r}",
              file=sys.stderr)
        return 2
    return local_smoke(int(procs), int(shards), args, timeout, module)


if __name__ == "__main__":
    sys.exit(main())
