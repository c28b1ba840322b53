"""Step-stamped checkpoint / resume: the counterpart of
``tpulbm.sim.checkpoint``.

A snapshot carries the full distribution state, the accumulated av_vels
prefix and the parameter deck, so a run resumes bitwise at its step. Two
storage backends, as the JAX package's:

- ``npz``: one file a snapshot, ``ckpt_%08d.npz`` with the keys ``step``,
  ``f`` (the (9, ny, nx) float32 state, gathered on the host of process
  0), ``av_vels`` and ``params`` (the deck as JSON), written atomically by
  a rename: the file name, keys and layout of the JAX package's, so a
  checkpoint written by either package resumes in the other. The JAX
  package compresses its files; these are stored uncompressed (``np.load``
  reads both), since zlib took seconds for a 1024^2 state, tens of times
  the write (PERF.md).
- ``dcp``: the counterpart of the JAX package's ``orbax`` backend (orbax
  is JAX's). A ``ckpt_%08d.dcp`` directory written by
  ``torch.distributed.checkpoint``, in which every process writes only its
  own shards, each a (9, h, w) piece keyed by its origin
  (``f_r<row0>_c<col0>``) beside its CRC-32 (``crc_r<row0>_c<col0>``):
  the ring's uneven splits (``decompose_rows``: 342/341/341 rows) are not
  DTensor's even chunks. Process 0 adds ``step``, ``av_vels`` and
  ``params`` (the deck's JSON bytes). The directory is written as
  ``.dcp.tmp`` and renamed when complete. ``restore_regions`` reads only
  the pieces that overlap the regions a process owns, onto any mesh and
  process count, with or without a process group, and raises on a piece
  whose checksum or coverage is wrong.

``AsyncCheckpointer`` writes on a thread of its own, so the serialization
overlaps the next chunk, for both backends. With ``keep`` it then deletes the
oldest complete checkpoints below the one it wrote (``prune``) until
``keep`` remain; it never touches a ``*.tmp*`` name, so a write in flight
or one that a killed process left torn is never deleted. Files are atomic
by rename and never fsynced: a killed process leaves the newest complete
checkpoint in place, a host that loses power may not. The thread adds
what it did to ``STATS``; ``Simulation.restore_checkpoint`` adds its
restores.

``HostStage`` makes an npz save's host copy of a state on a CUDA device
off the main thread: a device snapshot, then a copy on a side stream into
one of two pinned host buffers, which the writer thread waits for.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import threading
import time
import warnings
import zipfile
import zlib
from concurrent import futures
from typing import Optional, Sequence, Tuple

import numpy as np
import numpy.lib.format as npformat
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.utils.profiling import span

_NAME_RE = re.compile(r"ckpt_(\d+)\.npz$")
_DCP_RE = re.compile(r"ckpt_(\d+)\.dcp$")
_PIECE_RE = re.compile(r"f_r(\d+)_c(\d+)$")

BACKENDS = ("npz", "dcp")

# What the checkpoint path did in this process since the last
# reset_stats(): checkpoints the writer thread wrote, their bytes (an npz
# file's size; the tensors a dcp writer handed over) and its time in them
# (ns, perf_counter_ns inside the thread, retention included), the
# checkpoints retention deleted, restores, and the saves whose host buffer
# a queued write still read, so the main thread blocked on its join.
STATS: dict = dict.fromkeys(("saves", "bytes", "write_ns", "removed",
                             "restores", "held"), 0)
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    with _STATS_LOCK:
        for key in STATS:
            STATS[key] = 0


def count(**adds) -> None:
    """Add ``adds`` to ``STATS`` (from any thread)."""
    with _STATS_LOCK:
        for key, n in adds.items():
            STATS[key] += n


def save(directory, step: int, f: np.ndarray, av_vels: np.ndarray,
         params: LBMParams, ready=None) -> str:
    """Write ``ckpt_<step>.npz``; with ``ready`` (a CUDA event, as
    ``HostStage.copy`` returns) once the copy into ``f`` has landed."""
    if ready is not None:
        ready.synchronize()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    _savez(
        tmp,
        step=np.int64(step),
        f=np.asarray(f, dtype=np.float32),
        av_vels=np.asarray(av_vels, dtype=np.float32),
        params=json.dumps(dataclasses.asdict(params)),
    )
    os.replace(tmp, path)
    return path


def _savez(path, **arrays) -> None:
    """``np.savez(path, **arrays)``'s file, byte for byte (a stored zip64
    of ``<key>.npy`` members in that order) but for a Fortran-ordered
    array, written here in C order. ``np.savez`` copies each array into
    ``tobytes()`` pieces of 16 MiB under the GIL; here its bytes go to the
    member whole (a 1024^2 save on an H100 host: 25-38 ms, ``np.savez``
    31-53 ms)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            val = np.asarray(val, order="C")
            with zf.open(key + ".npy", "w", force_zip64=True) as member:
                npformat.write_array_header_1_0(
                    member, npformat.header_data_from_array_1_0(val))
                member.write(val.reshape(-1).view(np.uint8).data)


@contextlib.contextmanager
def _one_process_quiet():
    """Silence dcp's warning that it runs in one process, which is asked
    for here (``no_dist``)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def save_dcp(directory, step: int, pieces: dict, av_vels: np.ndarray,
             params: LBMParams, group=None) -> str:
    """Write ``ckpt_<step>.dcp`` from this process's ``pieces``
    ({(row0, col0): (9, h, w) host tensor}). Under a process ``group``
    every member calls it with its own pieces (a collective of that group);
    without one, a single process writes every piece."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    rank = 0 if group is None else dist.get_rank(group)
    path = os.path.join(directory, f"ckpt_{step:08d}.dcp")
    tmp = path + ".tmp"
    if rank == 0:
        os.makedirs(directory, exist_ok=True)
        shutil.rmtree(tmp, ignore_errors=True)
    if group is not None:
        dist.barrier(group=group)
    state = {}
    for (r0, c0), piece in pieces.items():
        piece = piece.contiguous()
        state[f"f_r{r0}_c{c0}"] = piece
        state[f"crc_r{r0}_c{c0}"] = torch.tensor(zlib.crc32(piece.numpy()),
                                                 dtype=torch.int64)
    if rank == 0:
        deck = json.dumps(dataclasses.asdict(params)).encode()
        state["step"] = torch.tensor(step, dtype=torch.int64)
        state["av_vels"] = torch.tensor(np.asarray(av_vels, np.float32))
        state["params"] = torch.tensor(list(deck), dtype=torch.uint8)
    with _one_process_quiet():
        dcp.save(state, storage_writer=dcp.FileSystemWriter(tmp),
                 process_group=group, no_dist=group is None)
    if rank == 0:
        # every member's pieces are on disk once the coordinator's save
        # returns: it wrote the metadata after gathering their results
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    return path


def complete(directory) -> list:
    """(step, path) of every complete checkpoint under ``directory``, npz
    files and dcp directories alike, oldest first."""
    if not os.path.isdir(directory):
        return []
    found = []
    for name in os.listdir(directory):
        m = _NAME_RE.match(name) or _DCP_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(directory, name)))
    return sorted(found)


def prune(directory, keep: int, step: int) -> int:
    """Delete the oldest complete checkpoints under ``directory`` whose
    step is below ``step``, the one just written, until ``keep`` remain;
    returns how many went. Later ones (left by another run) and ``*.tmp*``
    names are never touched."""
    found = complete(directory)
    older = [path for s, path in found if s < step]
    gone = older[:max(0, len(found) - keep)]
    for path in gone:
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
    return len(gone)


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with the next compute chunk:
    ``submit`` queues the write on the checkpointer's one writer thread,
    started at its first write and kept (a thread started a save cost the
    main thread 1.0-1.6 ms on an H100 host), which writes in the order
    submitted, so checkpoints are never reordered and retention runs after
    each rename. ``wait`` joins every queued write and raises the first
    error among them (at a run's end); ``release`` joins those up to the
    last that reads a host buffer its caller is about to refill. The caller
    hands over host arrays that nothing writes until their write is
    joined: the gathered state for ``npz``, this process's pieces for
    ``dcp``, and the history so far, which a run only appends to (no copy
    of it is made: a copy a save grows with the solve, and its fresh pages
    cost milliseconds on the main thread). ``dcp`` joins the last write
    before each submit, so one is in flight at most: its save runs the
    collectives of ``group``, a group that only checkpoint writers use.
    With ``ready``, a CUDA event, the thread first waits for the host copy
    the event ends, outside its clock (``STATS['write_ns']`` times the
    file, the rename and retention alone). With ``keep`` the thread prunes
    the directory after the rename (for ``dcp`` process 0 alone, which
    renames). A join that finds a write queued is the span
    ``lbm.ckpt.wait``; the thread opens no span and adds to ``STATS``."""

    def __init__(self, backend: str = "npz"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown checkpoint backend {backend!r} "
                             f"(choose from {BACKENDS})")
        self.backend = backend
        self._pool: Optional[futures.ThreadPoolExecutor] = None
        # (write, the npz state it reads) in the order submitted
        self._pending: list = []
        self._result: Optional[str] = None

    def submit(self, directory, step, f, av_vels, params,
               group=None, keep: Optional[int] = None, ready=None) -> None:
        reads = None
        if self.backend == "dcp":
            import torch.distributed as dist

            self.wait()
            lead = group is None or dist.get_rank(group) == 0
            nbytes = av_vels.nbytes + sum(p.nbytes for p in f.values())

            def write():
                path = save_dcp(directory, step, f, av_vels, params, group)
                return path, nbytes
        else:
            lead = True
            f = reads = np.asarray(f)

            def write():
                path = save(directory, step, f, av_vels, params)
                return path, os.path.getsize(path)

        def work():
            if ready is not None:
                ready.synchronize()
            t0 = time.perf_counter_ns()
            path, nbytes = write()
            removed = prune(directory, keep, step) if keep and lead else 0
            count(saves=1, bytes=nbytes, removed=removed,
                  write_ns=time.perf_counter_ns() - t0)
            return path

        if self._pool is None:
            self._pool = futures.ThreadPoolExecutor(1, "lbm-ckpt")
        self._pending.append((self._pool.submit(work), reads))

    def release(self, buf: np.ndarray) -> None:
        """Join the queued writes up to the last one that reads ``buf``;
        ``STATS['held']`` counts it where it had not ended."""
        last = [n for n, (_, reads) in enumerate(self._pending)
                if reads is not None and np.may_share_memory(reads, buf)]
        if last:
            if not self._pending[last[-1]][0].done():
                count(held=1)
            self._join(last[-1] + 1)

    def wait(self) -> Optional[str]:
        self._join(len(self._pending))
        return self._result

    def _join(self, n: int) -> None:
        """Join the first ``n`` queued writes, all of them even where one
        raised, then raise the first error."""
        joined, self._pending = self._pending[:n], self._pending[n:]
        if not joined:
            return
        with span("lbm.ckpt.wait"):
            futures.wait([write for write, _ in joined])
        for write, _ in joined:
            self._result = write.result()


class HostStage:
    """The host copy of an npz save of a state on a CUDA device, made off
    the main thread. ``copy`` copies the state on the current stream into a
    device snapshot kept for the stage's life (the next runner call
    overwrites the state's own storage in its first launch), after the
    side stream's last copy out of it; a side stream then copies the
    snapshot into one of two pinned host buffers, in turn, and records an
    event that the writer waits on. Before a buffer is refilled, its
    caller's writer joins the write that last read it (two saves back).
    The pinned buffers come from PyTorch's caching host allocator, so a
    later stage of the same shape takes them over. A stage holds one more
    device state and two pinned host buffers of the state's size."""

    def __init__(self, f: torch.Tensor):
        self.stream = torch.cuda.Stream(f.device)
        self.snapshot = torch.empty_like(f)
        self.snapshot.record_stream(self.stream)
        self.hosts = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
                      for _ in range(2)]
        self.copied = [torch.cuda.Event(blocking=True) for _ in range(2)]
        self.turn = 0

    def copy(self, f: torch.Tensor, writer: AsyncCheckpointer):
        """(the host buffer that will hold ``f``, the event that ends its
        copy)."""
        i, self.turn = self.turn, 1 - self.turn
        host = self.hosts[i].numpy()
        writer.release(host)
        main = torch.cuda.current_stream(f.device)
        main.wait_stream(self.stream)
        self.snapshot.copy_(f)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            self.hosts[i].copy_(self.snapshot, non_blocking=True)
            self.copied[i].record(self.stream)
        return host, self.copied[i]


def latest(directory) -> str | None:
    """The newest checkpoint under ``directory``: npz files and dcp
    directories alike (tpulbm/sim/checkpoint.py:217-227)."""
    found = complete(directory)
    return found[-1][1] if found else None


def is_dcp(path) -> bool:
    return bool(_DCP_RE.search(os.path.basename(os.path.normpath(path))))


def resolve(path_or_dir) -> str:
    """The checkpoint a path names: the file or dcp directory itself, or
    the latest one in a directory; raises FileNotFoundError where there is
    none."""
    path = str(path_or_dir)
    if os.path.isdir(path) and not is_dcp(path):
        path = latest(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {path_or_dir}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint {path}")
    return path


def _check_params(saved: dict, params: LBMParams) -> None:
    current = dataclasses.asdict(params)
    mismatched = {
        k: (saved[k], current[k])
        for k in saved
        # free_cells_inv depends on the obstacle file, checked via the grid;
        # max_iters may legitimately be overridden between sessions.
        if k not in ("free_cells_inv", "max_iters") and saved[k] != current[k]
    }
    if mismatched:
        detail = ", ".join(
            f"{k}: checkpoint={a!r} vs current={b!r}"
            for k, (a, b) in sorted(mismatched.items())
        )
        raise ValueError(f"checkpoint params do not match the deck ({detail})")


def _load_dcp(path, state: dict) -> None:
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException

    try:
        with _one_process_quiet():
            dcp.load(state, storage_reader=dcp.FileSystemReader(path),
                     no_dist=True)
    except (Exception, CheckpointException) as e:  # the latter a BaseException
        raise ValueError(f"corrupt checkpoint {path}: "
                         f"{type(e).__name__}: {e}") from e


def _restore_dcp(path, params: LBMParams, regions):
    import torch.distributed.checkpoint as dcp

    try:
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    except Exception as e:
        raise ValueError(f"corrupt checkpoint {path}: no readable metadata "
                         f"({type(e).__name__}: {e})") from e
    if not {"step", "av_vels", "params"} <= set(meta):
        raise ValueError(f"corrupt checkpoint {path}: it lacks step, "
                         f"av_vels or params")
    head = {"step": torch.zeros((), dtype=torch.int64),
            "av_vels": torch.empty(tuple(meta["av_vels"].size)),
            "params": torch.empty(tuple(meta["params"].size),
                                  dtype=torch.uint8)}
    _load_dcp(path, head)
    _check_params(json.loads(bytes(head["params"].tolist())), params)
    pieces = {}
    for key, m in meta.items():
        match = _PIECE_RE.match(key)
        if match:
            r0, c0 = int(match.group(1)), int(match.group(2))
            _, h, w = m.size
            pieces[key] = (r0, r0 + h, c0, c0 + w)

    def overlap(a, b):
        return (max(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]),
                min(a[3], b[3]))

    need = {}
    for key, box in pieces.items():
        if any(o[0] < o[1] and o[2] < o[3]
               for o in (overlap(box, r) for r in regions)):
            need[key] = torch.empty((9, box[1] - box[0], box[3] - box[2]))
            need["crc" + key[1:]] = torch.zeros((), dtype=torch.int64)
    _load_dcp(path, need)
    out = []
    for region in regions:
        r0, r1, c0, c1 = region
        f = np.empty((9, r1 - r0, c1 - c0), dtype=np.float32)
        filled = 0
        for key, box in pieces.items():
            o = overlap(box, region)
            if not (o[0] < o[1] and o[2] < o[3]):
                continue
            piece = need[key].numpy()
            if zlib.crc32(piece) != int(need["crc" + key[1:]]):
                raise ValueError(f"corrupt checkpoint {path}: piece {key} "
                                 f"fails its CRC-32")
            f[:, o[0] - r0:o[1] - r0, o[2] - c0:o[3] - c0] = piece[
                :, o[0] - box[0]:o[1] - box[0], o[2] - box[2]:o[3] - box[2]]
            filled += (o[1] - o[0]) * (o[3] - o[2])
        if filled != (r1 - r0) * (c1 - c0):
            raise ValueError(f"corrupt checkpoint {path}: its pieces cover "
                             f"{filled} of the {(r1 - r0) * (c1 - c0)} "
                             f"cells of rows [{r0}, {r1}) x columns "
                             f"[{c0}, {c1})")
        out.append(f)
    return int(head["step"]), out, head["av_vels"].numpy()


def restore_regions(path_or_dir, params: LBMParams, regions: Sequence):
    """(step, states, av_vels): the state of each region (row0, row1,
    col0, col1) of the grid, a (9, row1 - row0, col1 - col0) array, from a
    checkpoint file or dcp directory, or the latest one in a directory. A
    dcp checkpoint is read only where its pieces overlap the regions.
    Raises FileNotFoundError where there is no checkpoint, and ValueError
    where its deck differs from ``params`` or it is corrupt."""
    path = resolve(path_or_dir)
    if is_dcp(path):
        return _restore_dcp(path, params, regions)
    with np.load(path, allow_pickle=False) as z:
        step = int(z["step"])
        f = z["f"]
        av_vels = z["av_vels"]
        saved = json.loads(str(z["params"]))
    _check_params(saved, params)
    shape = (9, params.ny, params.nx)
    if f.shape != shape:
        raise ValueError(f"checkpoint state {f.shape} does not match the "
                         f"deck's {shape}")
    return step, [f[:, r0:r1, c0:c1] for r0, r1, c0, c1 in regions], av_vels


def restore(path_or_dir,
            params: LBMParams) -> Tuple[int, np.ndarray, np.ndarray]:
    """(step, f, av_vels) of a checkpoint (``restore_regions``), the whole
    (9, ny, nx) state."""
    step, (f,), av_vels = restore_regions(
        path_or_dir, params, [(0, params.ny, 0, params.nx)])
    return step, f, av_vels
