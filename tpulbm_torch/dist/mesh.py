"""The devices of the 1-D ring and of the 2-D torus, in one process.

Counterpart of ``tpulbm.dist.mesh``: the reference's process topology is a
1-D ring of MPI ranks over grid rows (d2q9-bgk.c:244-247,834-862).
``get_mesh`` returns the device list of a ring whose shards one process
drives, one per entry; ``get_mesh_2d`` is the counterpart of
``tpulbm.dist.mesh.get_mesh_2d`` (``--mesh-shape DYxDX``): a dy x dx nested
list of devices, one per block of the torus. Within a process the halo
slabs move by tensor copies (peer copies between cards). Over several
processes (``--multihost``) the global ring and torus come from
``dist.multihost.global_ring_mesh`` and ``global_torus_mesh``, which list
each process's own shards and ``None`` for the others', and
``dist.multihost.Transport`` moves the slabs that cross a process.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch


def get_mesh(n_devices: Optional[int] = None,
             device="cuda") -> List[torch.device]:
    """The ordered devices of a ring of ``n_devices`` shards. On ``cuda``
    shard i sits on ``cuda:(i % torch.cuda.device_count())``, and the
    default is one shard per visible card; on ``cpu`` every shard is on the
    CPU, and the default is one shard. When shards share a card, one line
    on stderr says so."""
    kind = torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        _check_count(n)
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"a ring runs on cuda or cpu, not {device}")
    count = torch.cuda.device_count()
    if count == 0:
        raise ValueError("no CUDA device is visible")
    n = count if n_devices is None else n_devices
    _check_count(n)
    if n > count:
        print(f"tpulbm_torch: {n} shards on {count} CUDA device(s): shard i "
              f"runs on cuda:(i % {count}), so shards share cards",
              file=sys.stderr, flush=True)
    return [torch.device("cuda", i % count) for i in range(n)]


def get_mesh_2d(dy: int, dx: int, device="cuda") -> List[List[torch.device]]:
    """The dy x dx devices of a torus: block (i, j) sits on
    ``cuda:((i * dx + j) % torch.cuda.device_count())``; on ``cpu`` every
    block is on the CPU. When blocks share a card, one line on stderr says
    so."""
    if dy < 1 or dx < 1:
        raise ValueError(f"a torus needs at least one block a side, got "
                         f"{dy}x{dx}")
    kind = torch.device(device).type
    if kind == "cpu":
        return [[torch.device("cpu")] * dx for _ in range(dy)]
    if kind != "cuda":
        raise ValueError(f"a torus runs on cuda or cpu, not {device}")
    count = torch.cuda.device_count()
    if count == 0:
        raise ValueError("no CUDA device is visible")
    if dy * dx > count:
        print(f"tpulbm_torch: {dy}x{dx} blocks on {count} CUDA device(s): "
              f"block (i, j) runs on cuda:((i * {dx} + j) % {count}), so "
              f"blocks share cards", file=sys.stderr, flush=True)
    return [[torch.device("cuda", (i * dx + j) % count) for j in range(dx)]
            for i in range(dy)]


def _check_count(n: int) -> None:
    if n < 1:
        raise ValueError(f"a ring needs at least one shard, got {n}")

