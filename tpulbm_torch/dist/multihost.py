"""Multi-process runs: process-group start-up, the host-contiguous global
mesh, the halo transport between processes, and output gathering to
process 0.

Counterpart of ``tpulbm.dist.multihost`` (``--multihost``). The reference
runs one MPI rank per core over a 1-D ring of grid rows
(d2q9-bgk.c:244-247,834-862); the JAX package runs one process per host
under ``jax.distributed``. Here each process is a member of a
``torch.distributed`` group and holds only its own shards:

- **Start-up.** ``init_distributed`` reads the JAX package's variables
  (``TPULBM_COORDINATOR`` as ``host:port`` or a ``file://`` / ``tcp://``
  URL, ``TPULBM_NUM_PROCS``, ``TPULBM_PROC_ID``) or torchrun's
  (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), and does nothing for a single
  process. It makes two more gloo groups: one for host-side gathers and
  scatters, and one that only checkpoint writers use, so a save on a writer
  thread never interleaves its collectives with the main thread's.
- **The global mesh.** Host-contiguous, as ``global_ring_mesh`` of the JAX
  package: process p owns shards ``[p L, (p + 1) L)``, L its local shard
  count (``TPULBM_LOCAL_SHARDS``, else one a visible card on ``cuda`` and
  one on ``cpu``). Its local shard j sits on ``cuda:((local_rank L + j) %
  cards)``; the mesh lists ``None`` for another process's shard.
- **The transport** (``Transport``) moves every halo piece of a chunk in
  one fixed order: a copy when both shards are in this process, a P2P send
  and receive (``batch_isend_irecv``, every rank posting both sides; the
  pieces for one process packed into one message) when they are not. ``choose_transport`` fixes
  its backend before the run: NCCL where no card serves two processes,
  gloo with the slabs staged through the host where processes share a card
  (NCCL refuses two ranks on one GPU) and on the CPU. A refused NCCL start
  fails the run: nothing falls back. Over the host group it also gathers
  what the cuda-p2p ring's exchange needs of every process
  (``ops.ring_p2p.Exchange``): where each shard lies (``places``: process,
  card, the card's UUID, host) and the IPC handles of the exchange
  memory (``all_gather_object``); and it orders the processes
  (``barrier``) and ORs their error flags (``any``).
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket
import sys
from datetime import timedelta
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# Seconds a collective or P2P operation may wait before the group fails it
TIMEOUT_S = 600

_GROUPS: dict = {}
# Callables that shutdown() runs before it destroys the group
_AT_SHUTDOWN: list = []


@dataclasses.dataclass(frozen=True)
class DistEnv:
    """The process group a run was started in, from the environment."""

    init_method: Optional[str]
    world: int
    rank: int
    local_rank: int
    local_world: int
    local_shards: Optional[int]


def dist_env(environ=None) -> DistEnv:
    """Parse the TPULBM_* variables (the JAX package's launcher) or
    torchrun's; the TPULBM_* ones win where both are set."""
    env = os.environ if environ is None else environ

    def num(*names, default=None):
        for name in names:
            if env.get(name):
                return int(env[name])
        return default

    coordinator = env.get("TPULBM_COORDINATOR")
    if coordinator:
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
    elif env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = "env://"
    else:
        init_method = None
    world = num("TPULBM_NUM_PROCS", "WORLD_SIZE", default=1)
    rank = num("TPULBM_PROC_ID", "RANK", default=0)
    return DistEnv(
        init_method=init_method, world=world, rank=rank,
        local_rank=num("LOCAL_RANK", default=0),
        local_world=num("LOCAL_WORLD_SIZE", default=1),
        local_shards=num("TPULBM_LOCAL_SHARDS"))


def choose_transport(device, local_shards: int, local_world: int,
                     cards: int) -> str:
    """The halo transport's backend: ``gloo`` on the CPU and where a card
    serves two processes of this host (two or more processes and
    local_world x local_shards > cards: NCCL refuses two ranks on one
    GPU), else ``nccl``."""
    if torch.device(device).type != "cuda":
        return "gloo"
    shared = local_world > 1 and local_world * local_shards > cards
    return "gloo" if shared else "nccl"


def init_distributed(backend: str = "gloo", environ=None) -> bool:
    """Start the process group of ``dist_env``; returns True if the run has
    more than one process. A no-op for a single process (nothing configured,
    or a world of 1), as ``tpulbm.dist.multihost.init_distributed``."""
    env = dist_env(environ)
    if env.world == 1:
        return False
    if env.init_method is None:
        raise ValueError(
            f"{env.world} processes but no coordinator: set "
            f"TPULBM_COORDINATOR (host:port or a file:// URL) or "
            f"MASTER_ADDR and MASTER_PORT")
    if not 0 <= env.rank < env.world:
        raise ValueError(f"process id {env.rank} outside a world of "
                         f"{env.world}")
    if not dist.is_initialized():
        timeout = timedelta(seconds=TIMEOUT_S)
        dist.init_process_group(backend, init_method=env.init_method,
                                rank=env.rank, world_size=env.world,
                                timeout=timeout)
        _GROUPS["host"] = dist.new_group(backend="gloo", timeout=timeout)
        _GROUPS["ckpt"] = dist.new_group(backend="gloo", timeout=timeout)
    return dist.get_world_size() > 1


def at_shutdown(fn) -> None:
    """Have ``shutdown`` call ``fn()`` while the group still stands, in
    the order of these calls (the same on every process)."""
    _AT_SHUTDOWN.append(fn)


def shutdown() -> None:
    """Run the ``at_shutdown`` callables, then destroy the process group
    (and its subgroups), if one was started."""
    try:
        while _AT_SHUTDOWN:
            _AT_SHUTDOWN.pop(0)()
    finally:
        _AT_SHUTDOWN.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
        _GROUPS.clear()


def world() -> tuple:
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_output_process() -> bool:
    return world()[0] == 0


def host_group():
    """The gloo group of host-side gathers and scatters (main thread)."""
    return _GROUPS.get("host")


def checkpoint_group():
    """The gloo group that only checkpoint writers use."""
    return _GROUPS.get("ckpt")


def process_mesh_info() -> dict:
    """Shape of the run: processes, this process's slot, the transport."""
    rank, size = world()
    env = dist_env()
    return {
        "process_index": rank,
        "process_count": size,
        "local_rank": env.local_rank,
        "local_world": env.local_world,
        "cards": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "transport": dist.get_backend() if dist.is_initialized() else None,
    }


def local_shard_count(device="cuda", environ=None) -> int:
    """L, the shards of each process when the mesh is not given:
    TPULBM_LOCAL_SHARDS, else the visible cards shared out among this
    host's processes (at least one) on ``cuda``, one on ``cpu``."""
    env = dist_env(environ)
    if env.local_shards:
        return env.local_shards
    if torch.device(device).type == "cuda":
        return max(1, torch.cuda.device_count() // env.local_world)
    return 1


def _local_devices(n_global: int, device) -> List[torch.device]:
    rank, size = world()
    if n_global % size:
        raise ValueError(f"{n_global} shards do not split evenly over "
                         f"{size} processes")
    per = n_global // size
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * per
    if kind != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu, not {device}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise ValueError("no CUDA device is visible")
    env = dist_env()
    if max(env.local_world, 1) * per > cards:
        print(f"tpulbm_torch: process {rank}'s {per} shards on "
              f"cuda:((local_rank * {per} + j) % {cards}): shards share "
              f"cards", file=sys.stderr, flush=True)
    return [torch.device("cuda", (env.local_rank * per + j) % cards)
            for j in range(per)]


def global_ring_mesh(n_shards: Optional[int] = None, device="cuda") -> list:
    """The host-contiguous ring of ``n_shards`` (default: L of every
    process): this process's shards on their devices, ``None`` for the
    others'."""
    rank, size = world()
    n = size * local_shard_count(device) if n_shards is None else n_shards
    if n < 1:
        raise ValueError(f"a ring needs at least one shard, got {n}")
    local = _local_devices(n, device)
    per = len(local)
    return [local[d - rank * per] if d // per == rank else None
            for d in range(n)]


def ring_pieces(k: int, n: int, lead: tuple, nx: int) -> list:
    """The ring's halo pieces of a chunk of k steps (``Transport.move``):
    for each shard d, the last k rows of shard d - 1 (its lo slab) and the
    first k rows of shard d + 1 (its hi slab); the wrap is the periodic y
    boundary. ``lead``: (9,) for states, () for masks."""
    shape = (*lead, k, nx)

    def lo(t):
        return t[..., -k:, :]

    def hi(t):
        return t[..., :k, :]

    return [piece for d in range(n)
            for piece in (((d - 1) % n, d, shape, lo),
                          ((d + 1) % n, d, shape, hi))]


def by_shard(local, values, n: int) -> list:
    """A list of n entries, values[j] at index local[j], None elsewhere
    (``Transport.move``'s sources)."""
    out = [None] * n
    for d, v in zip(local, values):
        out[d] = v
    return out


def card(device: torch.device) -> tuple:
    """(device index, the card's UUID) of a CUDA device, (-1, "") of the
    CPU."""
    if device.type != "cuda":
        return -1, ""
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return index, str(torch.cuda.get_device_properties(index).uuid)


def visible_cards() -> set:
    """The UUIDs of the CUDA cards this process can see."""
    return {card(torch.device("cuda", i))[1]
            for i in range(torch.cuda.device_count())}


def global_torus_mesh(dy: int, dx: int, device="cuda") -> list:
    """The dy x dx torus with its row-major blocks shared out as the
    ring's shards: ``None`` for another process's block."""
    if dy < 1 or dx < 1:
        raise ValueError(f"a torus needs at least one block a side, got "
                         f"{dy}x{dx}")
    flat = global_ring_mesh(dy * dx, device)
    return [flat[i * dx:(i + 1) * dx] for i in range(dy)]


class Transport:
    """Moves pieces of shards between the shards of a global mesh (flat:
    a ring's shards, or a torus's blocks in row-major order; ``None`` for
    a shard of another process). Process p owns shards ``[p L, (p + 1)
    L)``. Without a process group (or in a world of one) every shard is
    local and a move is a copy."""

    def __init__(self, devices: Sequence):
        self.devices = [None if d is None else torch.device(d)
                        for d in devices]
        # a mesh of this process's shards alone is local, whatever the group
        self.rank, self.world = (world() if None in self.devices
                                 else (0, 1))
        n = len(self.devices)
        if n % self.world:
            raise ValueError(f"{n} shards do not split evenly over "
                             f"{self.world} processes")
        self.per = n // self.world
        self.local = [d for d in range(n) if self.owner(d) == self.rank]
        for d, dev in enumerate(self.devices):
            if (dev is None) != (self.owner(d) != self.rank):
                raise ValueError(
                    f"process {self.rank} of {self.world} owns shards "
                    f"{self.local[0]}-{self.local[-1]}; the mesh places "
                    f"shard {d} on {dev}")
        self.device = self.devices[self.local[0]]
        self.comm = self.device
        if self.world > 1:
            backend = dist.get_backend()
            if self.device.type != "cuda" or "nccl" not in backend:
                self.comm = torch.device("cpu")   # staged through the host
            else:
                torch.cuda.set_device(self.device)
        # messages staged from a card go through page-locked host memory
        self.pinned = self.comm.type == "cpu" and self.device.type == "cuda"
        self._places = None

    def owner(self, d: int) -> int:
        return d // self.per

    def is_local(self, d: int) -> bool:
        return self.owner(d) == self.rank

    @property
    def backend(self) -> str:
        if self.world == 1:
            return "copies (one process)"
        if self.pinned:
            return f"{dist.get_backend()} (slabs staged through the host)"
        return dist.get_backend()

    def move(self, pieces, sources) -> list:
        """Move ``pieces``, a list of (src, dst, shape, cut), the same on
        every process: ``cut(sources[src])`` is the piece of shard src that
        shard dst needs, a float32 tensor of ``shape``, made only where src
        is local. Returns the list of pieces, on their destination's device
        where dst is local, else None. The pieces for one process travel
        as one message, packed in list order (one send and one receive a
        peer and call: gloo pays per message); a piece leaves its source as
        a copy, so the next chunk may overwrite the source's storage."""
        out = [None] * len(pieces)
        if self.world == 1:
            for i, (src, dst, _, cut) in enumerate(pieces):
                out[i] = cut(sources[src]).to(self.devices[dst]).contiguous()
            return out
        sends, recvs = {}, {}
        for i, (src, dst, shape, cut) in enumerate(pieces):
            here, there = self.is_local(src), self.is_local(dst)
            if here and there:
                out[i] = cut(sources[src]).to(self.devices[dst]).contiguous()
            elif here:
                sends.setdefault(self.owner(dst), []).append(
                    cut(sources[src]))
            elif there:
                recvs.setdefault(self.owner(src), []).append((i, dst, shape))
        ops, unpack = [], []
        for peer, parts in sends.items():
            buf = self._buffer(sum(p.numel() for p in parts))
            off = 0
            for part in parts:
                buf[off:off + part.numel()].view(part.shape).copy_(
                    part, non_blocking=self.pinned)
                off += part.numel()
            ops.append(dist.P2POp(dist.isend, buf, peer))
        if self.pinned and sends:
            # the staging copies are asynchronous: finish them before gloo
            # reads the buffers
            for d in self.local:
                torch.cuda.current_stream(self.devices[d]).synchronize()
        for peer, parts in recvs.items():
            buf = self._buffer(sum(math.prod(shape) for _, _, shape in parts))
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            unpack.append((parts, buf))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        for parts, buf in unpack:
            off = 0
            for i, dst, shape in parts:
                n = math.prod(shape)
                out[i] = buf[off:off + n].view(shape).to(
                    self.devices[dst], non_blocking=self.pinned)
                off += n
        return out

    def _buffer(self, numel: int) -> torch.Tensor:
        """A fresh message buffer on the transport's device (page-locked
        host memory when the slabs are staged from a card)."""
        return torch.empty(numel, dtype=torch.float32, device=self.comm,
                           pin_memory=self.pinned)

    def all_gather(self, values: Sequence[torch.Tensor]) -> list:
        """The local shards' same-shape ``values`` (in shard order), and
        every other process's: all N in shard order. In a world of one,
        ``values`` itself."""
        if self.world == 1:
            return list(values)
        mine = torch.stack([v.to(self.comm) for v in values])
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        return [p[j] for p in parts for j in range(self.per)]

    def warm(self) -> None:
        """One all-gather over the group: its first collective, where NCCL
        makes its communicators (seconds), so that a timed region after it
        holds none of that."""
        if self.world > 1:
            self.all_gather([torch.zeros(1, device=self.devices[d])
                             for d in self.local])

    def all_gather_object(self, obj) -> list:
        """Every process's ``obj`` (pickled, host group), in process
        order; in a world of one, ``[obj]``."""
        if self.world == 1:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=host_group())
        return out

    def places(self) -> list:
        """(process, card, card UUID, host) of every shard of the mesh:
        card the device index in the owner process (-1 on the CPU), the
        UUID "" on the CPU; gathered over the host group on first use."""
        if self._places is None:
            host = socket.gethostname()
            mine = [(self.rank, *card(self.devices[d]), host)
                    for d in self.local]
            self._places = [p for part in self.all_gather_object(mine)
                            for p in part]
        return self._places

    def barrier(self) -> None:
        """Return once every process has called it (host group)."""
        if self.world > 1:
            dist.barrier(group=host_group())

    def any(self, flag: bool) -> bool:
        """True on every process where ``flag`` is true on one (host
        group)."""
        if self.world == 1:
            return bool(flag)
        t = torch.tensor([int(bool(flag))])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
        return bool(t.item())

    def broadcast(self, obj):
        """``obj`` of process 0 on every process (pickled, host group)."""
        if self.world == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=host_group())
        return box[0]


def gather_to_host(tr: Transport, values: Sequence[torch.Tensor],
                   shapes: Sequence[tuple]) -> Optional[list]:
    """The local shards' ``values`` (host tensors, in shard order, over
    ``tr``) and every other process's, gathered on process 0 (``shapes``:
    all N shapes): all N on process 0, None elsewhere. The counterpart of
    ``tpulbm.dist.multihost.gather_to_host`` and of the reference's
    rank-ordered append (d2q9-bgk.c:1049-1122)."""
    if tr.world == 1:
        return list(values)
    mine = dict(zip(tr.local, values))
    ops, out = [], [None] * len(shapes)
    for d, shape in enumerate(shapes):
        if tr.rank == 0 and tr.is_local(d):
            out[d] = mine[d].cpu()
        elif tr.rank == 0:
            out[d] = torch.empty(shape, dtype=mine[tr.local[0]].dtype)
            ops.append(dist.P2POp(dist.irecv, out[d], tr.owner(d),
                                  group=host_group(), tag=d))
        elif tr.is_local(d):
            ops.append(dist.P2POp(dist.isend, mine[d].cpu().contiguous(),
                                  0, group=host_group(), tag=d))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out if tr.rank == 0 else None


def scatter_from_host(tr: Transport,
                      pieces: Optional[Sequence[torch.Tensor]],
                      shapes: Sequence[tuple]) -> list:
    """The inverse of ``gather_to_host``: ``pieces`` (all N host tensors)
    on process 0, ignored elsewhere; returns the local shards' pieces, in
    shard order, on the host."""
    if tr.world == 1:
        return list(pieces)
    ops, mine = [], {}
    for d, shape in enumerate(shapes):
        if tr.rank == 0 and tr.is_local(d):
            mine[d] = pieces[d]
        elif tr.rank == 0:
            ops.append(dist.P2POp(dist.isend, pieces[d].contiguous(),
                                  tr.owner(d), group=host_group(), tag=d))
        elif tr.is_local(d):
            mine[d] = torch.empty(shape, dtype=torch.float32)
            ops.append(dist.P2POp(dist.irecv, mine[d], 0,
                                  group=host_group(), tag=d))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [mine[d] for d in tr.local]
