"""The high-level simulation, on one device, a ring of shards or a torus of
blocks.

Counterpart of ``tpulbm.sim.simulation``: initialise from a parameter deck
and an obstacle file, run the step loop in chunks (the av series is read
back once per chunk, so checkpoints, progress, debug lines and metrics can
come between chunks), then expose the final state, the av_vels series and
the Reynolds number, and write the reference's output files. With a
``mesh`` of N >= 2 devices (``dist.mesh.get_mesh``) the state and the mask
are held as the row shards of ``dist.sharding.shard_rows`` and stepped by
the ring runner; with a 2-D ``mesh`` (``dist.mesh.get_mesh_2d``) as the
blocks of ``dist.sharding.shard_blocks``, stepped by the torus runner.
``f`` gathers them on the first device at each read; ``reynolds()``,
``average_velocity()`` and the debug lines add per-shard sums there, in
shard order; ``write_outputs()`` gathers the output planes and an npz
checkpoint the state on the host. So a ring or torus holds two states at
most, as one device does; a checkpoint restores onto any mesh.

Under several processes (``--multihost``, ``dist.multihost``) the mesh is
the global one, with ``None`` for another process's shards, and a
Simulation holds only its process's shards; ``transport`` moves what
crosses a process boundary. The per-shard sums are gathered to every
process and added in shard order, so every process holds the same av
series and Reynolds number, bitwise those of one process driving every
shard. ``f``, ``write_outputs()`` and an npz checkpoint gather to process
0 (the counterpart of tpulbm/sim/simulation.py:282-307): ``f`` is None on
the other processes, which return from ``write_outputs()`` after the
gather. An npz restore is read by process 0 and scattered; a dcp
checkpoint (``--ckpt-backend dcp``) is written by every process for its
own shards, and each process reads back only the rows it owns.

A runner call takes ownership of the state it is handed (its storage holds
a later chunk's output, as the JAX runners donate theirs): ``run`` keeps no
reference to the shards during the call.

Each part of that work is a span (``utils.profiling.span``):
``lbm.sim.init``, ``lbm.sim.settle``, ``lbm.sim.run`` and inside it, a
runner call at a time, ``lbm.dist.make_runner`` (on the runner's first
call), ``lbm.dist.call``, ``lbm.sim.readback`` and ``lbm.sim.record`` (the
bookkeeping between calls), then ``lbm.sim.result`` (the history copy and
``lbm.sim.reynolds``); ``lbm.io.write`` holds ``lbm.diag.planes`` and the
writers' ``lbm.io.final_state`` and ``lbm.io.av_vels``. A run that
checkpoints adds ``lbm.ckpt.copy`` in ``lbm.sim.record`` (the host copy
of the state, or on a CUDA device the launch of its copies, the history's
view and the hand-off to the writer thread) and ``lbm.ckpt.wait`` (a join
of that thread, inside a save before its copy or at the run's end);
``restore_checkpoint`` is ``lbm.ckpt.restore``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.diag.observables import (
    output_fields,
    reynolds_of,
    speed_sum,
    total_density,
)
from tpulbm_torch.dist import multihost
from tpulbm_torch.dist.runner import make_runner, resolve_backend
from tpulbm_torch.dist.sharding import (
    block_shape,
    gather_blocks,
    gather_rows,
    regions,
    shard_blocks,
    shard_rows,
)
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.io.writers import write_av_vels, write_final_state
from tpulbm_torch.ops.step_torch import scale_sums
from tpulbm_torch.sim import checkpoint as ckpt
from tpulbm_torch.utils.profiling import span, spanned


@dataclasses.dataclass
class SimulationResult:
    """A run's result. ``f`` is the simulation's state after the run, read
    when asked for (gathered on the first device on a ring or torus; under
    several processes a collective, None but on process 0). The
    next ``run`` or restore of the same Simulation takes that state over, as
    a JAX runner's donation deletes its input: ``f`` then raises."""

    params: LBMParams
    av_vels: np.ndarray
    reynolds: float
    elapsed_s: float
    sim: "Simulation" = dataclasses.field(repr=False)
    epoch: int = dataclasses.field(repr=False)

    @property
    def f(self) -> torch.Tensor:
        if self.sim.epoch != self.epoch:
            raise RuntimeError(
                "this result's state was taken over by a later run or "
                "restore of its Simulation; read f before that")
        return self.sim.f


class Simulation:
    @spanned("lbm.sim.init")
    def __init__(
        self,
        params: LBMParams,
        obstacles: np.ndarray,
        backend: str = "auto",
        device="cuda",
        mesh=None,
        ckpt_backend: str = "npz",
    ):
        if params.free_cells_inv == 0.0:
            params = params.with_free_cells(
                params.nx * params.ny - int(np.asarray(obstacles).sum())
            )
        self.params = params

        def dev(d):
            return None if d is None else torch.device(d)

        if mesh is not None and isinstance(mesh[0], (list, tuple)):
            self.mesh = [[dev(d) for d in row] for row in mesh]
            block_shape(params.ny, params.nx, len(mesh), len(mesh[0]))
            flat = [d for row in self.mesh for d in row]
        else:
            self.mesh = ([torch.device(device)] if mesh is None
                         else [dev(d) for d in mesh])
            flat = self.mesh
        self.transport = multihost.Transport(flat)
        self.device = self.transport.device
        self.regions = regions(params.ny, params.nx, self.mesh)
        self.backend = resolve_backend(backend, self.device)
        self.ckpt_backend = ckpt_backend
        self.obstacles = torch.as_tensor(
            np.asarray(obstacles, dtype=bool), device=self.device)
        self.shards, self.obst_shards = self._shard(
            initial_state(params, self.device))
        self.epoch = 0   # counts the runner calls and restores
        self.step_count = 0
        self.av_vels = np.zeros((params.max_iters,), dtype=np.float32)
        self._runners = {}
        self._async_ckpt = ckpt.AsyncCheckpointer(ckpt_backend)
        self._host_f = None   # _host_state's buffer, made at the first save
        self._stage = None    # the HostStage of a CUDA state's npz saves

    @classmethod
    def from_files(
        cls,
        param_file: str | os.PathLike,
        obstacle_file: str | os.PathLike,
        backend: str = "auto",
        device="cuda",
        mesh=None,
        ckpt_backend: str = "npz",
    ) -> "Simulation":
        params = read_params(param_file)
        mask, num_free = read_obstacles(obstacle_file, params.nx, params.ny)
        return cls(params.with_free_cells(num_free), mask, backend=backend,
                   device=device, mesh=mesh, ckpt_backend=ckpt_backend)

    @property
    def torus(self) -> bool:
        return isinstance(self.mesh[0], list)

    @property
    def output(self) -> bool:
        """Whether this process writes the outputs (process 0)."""
        return self.transport.rank == 0

    def _shard(self, f: torch.Tensor):
        """(state shards, mask shards) of the full state ``f`` for the mesh:
        one of each on one device, row shards on a ring, blocks on a
        torus; this process's alone."""
        if self.torus:
            return shard_blocks(f, self.obstacles, self.mesh)
        if len(self.mesh) > 1:
            return shard_rows(f, self.obstacles, self.mesh)
        return [f], [self.obstacles]

    def _gather(self, shards, device) -> Optional[torch.Tensor]:
        """This process's per-shard tensors (states or (h, w) planes) as one
        on ``device``: the one shard itself on one device. Under several
        processes, gathered on process 0's host first; None elsewhere."""
        if self.transport.world > 1:
            lead = tuple(shards[0].shape[:-2])
            shards = multihost.gather_to_host(
                self.transport, [s.cpu() for s in shards],
                [(*lead, r1 - r0, c1 - c0) for r0, r1, c0, c1 in self.regions])
            if shards is None:
                return None
        if len(shards) == 1:
            return shards[0]
        if self.torus:
            return gather_blocks(shards, len(self.mesh), len(self.mesh[0]),
                                 device)
        return gather_rows(shards, device)

    def _shard_sum(self, fn) -> torch.Tensor:
        """fn(state shard, mask shard), a float32 scalar, added over all
        the shards (every process's) on the first device in shard order."""
        total = None
        for s in self.transport.all_gather(
                [fn(f, o) for f, o in zip(self.shards, self.obst_shards)]):
            s = s.to(self.device)
            total = s if total is None else total + s
        return total

    @property
    def f(self) -> Optional[torch.Tensor]:
        """The (9, ny, nx) state on the first device: on a ring or torus, a
        new gather of the shards at each read (under several processes a
        collective, None but on process 0)."""
        return self._gather(self.shards, self.device)

    @spanned("lbm.sim.settle")
    def settle(self) -> None:
        """Finish set-up before a timed region: wait for the uploads, on the
        ``cuda`` backend build and load the kernels, and over several
        processes run the group's first collective, which makes NCCL's
        communicators (the reference starts its clock after
        ``initialise``, d2q9-bgk.c:278-279)."""
        if self.backend in ("cuda", "cuda-p2p"):
            from tpulbm_torch.ops import _build

            _build.library()
        self.transport.warm()
        self._sync()

    def _sync(self) -> None:
        for f in self.shards:
            if f.device.type == "cuda":
                torch.cuda.synchronize(f.device)

    def _runner(self, n_steps: int):
        if n_steps not in self._runners:
            with span("lbm.dist.make_runner"):
                self._runners[n_steps] = make_runner(
                    self.params, n_steps, backend=self.backend,
                    device=self.device, mesh=self.mesh,
                    transport=self.transport)
        return self._runners[n_steps]

    def _advance(self, n_steps: int):
        """One runner call of n_steps; returns the av series on the host.
        The runner takes the shards over: none is held here meanwhile."""
        shards, self.shards = self.shards, []
        self.epoch += 1
        if len(self.mesh) == 1 and not self.torus:
            f, av = self._runner(n_steps)(shards.pop(), self.obstacles)
            shards = [f]
        else:
            shards, av = self._runner(n_steps)(shards, self.obst_shards)
        self.shards = shards
        with span("lbm.sim.readback"):
            return av.cpu().numpy()

    @staticmethod
    def _plan_chunks(start: int, total: int, chunk: int,
                     cadence: Optional[int]) -> list:
        """Chunk sizes covering ``[start, start + total)`` such that every
        multiple of ``cadence`` inside the range ends a chunk (so periodic
        checkpoints actually fire, including after a mid-cadence resume).

        At most two distinct sizes (the main chunk + one remainder) when
        ``start`` sits on a cadence boundary, so at most two runners are
        built per run; a mid-cadence resume adds one alignment head.
        """
        sizes = []
        pos = start
        end = start + total
        if cadence:
            head = min((-pos) % cadence, end - pos)
            if head:
                sizes.append(min(head, chunk))
                pos += sizes[-1]
        while pos < end:
            n = min(chunk, end - pos)
            if cadence:
                n = min(n, (-pos) % cadence or cadence)
            sizes.append(n)
            pos += n
        return sizes

    @spanned("lbm.sim.run")
    def run(
        self,
        n_steps: Optional[int] = None,
        chunk: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        progress: bool = False,
        debug: bool = False,
        metrics_file: Optional[str] = None,
        checkpoint_keep: Optional[int] = None,
    ) -> SimulationResult:
        """Advance ``n_steps`` (default: the deck's maxIters minus steps
        already taken), returning the accumulated result. With
        ``checkpoint_every`` a checkpoint is written at every multiple of
        it and at the end, on a thread that the run joins before it
        returns; ``checkpoint_keep`` N then keeps the newest N complete
        checkpoints of the directory (``checkpoint.prune``), None all."""
        remaining = self.params.max_iters - self.step_count
        total = remaining if n_steps is None else n_steps
        if total > remaining:
            raise ValueError(
                f"run of {total} steps would exceed the deck's maxIters="
                f"{self.params.max_iters} (already at step {self.step_count})"
            )
        if checkpoint_every and not checkpoint_dir:
            raise ValueError("checkpoint_every requires checkpoint_dir")
        if checkpoint_keep is not None and checkpoint_keep < 1:
            raise ValueError(f"checkpoint_keep must be at least 1, got "
                             f"{checkpoint_keep}")
        submit = functools.partial(self._async_ckpt.submit,
                                   keep=checkpoint_keep)
        if chunk is None:
            chunk = total if checkpoint_every is None else checkpoint_every
            if metrics_file and chunk == total:
                chunk = max(1, min(total, 1000))
        chunk = max(1, min(chunk, total))
        if metrics_file:
            parent = os.path.dirname(metrics_file)
            if parent:
                os.makedirs(parent, exist_ok=True)
        # under several processes, process 0 alone prints and writes metrics
        metrics_fp = (open(metrics_file, "a")
                      if metrics_file and self.output else None)
        plan = self._plan_chunks(
            self.step_count, total, chunk, checkpoint_every
        )
        t0 = time.perf_counter()
        done = 0
        try:
            for n in plan:
                av_np = self._advance(n)
                with span("lbm.sim.record"):
                    if not np.isfinite(av_np[-1]):
                        # Divergence check, the runtime form of the
                        # reference's disabled FP traps (d2q9-bgk.c:60,195):
                        # BGK goes unstable for omega near 2 or too strong a
                        # forcing. Bookkeeping advances through the last
                        # finite step first (the state itself is past the
                        # divergence).
                        bad = int(np.argmax(~np.isfinite(av_np)))
                        at = self.step_count
                        self.av_vels[at : at + bad] = av_np[:bad]
                        self.step_count += bad
                        raise FloatingPointError(
                            f"simulation diverged (non-finite average "
                            f"velocity at step {self.step_count}); check "
                            f"omega ({self.params.omega}) and accel "
                            f"({self.params.accel})"
                        )
                    self.av_vels[self.step_count : self.step_count + n] = av_np
                    self.step_count += n
                    done += n
                    if progress and self.output:
                        print(
                            f"step {self.step_count}/{self.params.max_iters} "
                            f"av_vel={av_np[-1]:.6E}",
                            flush=True,
                        )
                    if debug:
                        # The reference's DEBUG block (d2q9-bgk.c:380-393).
                        density = self._shard_sum(
                            lambda f, _: total_density(f))
                        if self.output:
                            print(f"==timestep: {self.step_count - 1}==")
                            print(f"av velocity: {av_np[-1]:.12E}")
                            print(f"tot density: {float(density):.12E}",
                                  flush=True)
                    if metrics_fp is not None:
                        wall = max(time.perf_counter() - t0, 1e-9)
                        metrics_fp.write(json.dumps({
                            "step": self.step_count,
                            "av_vel": float(av_np[-1]),
                            "wall_s": round(wall, 4),
                            # this run's steps over this run's wall time
                            "steps_per_s": round(done / wall, 2),
                        }) + "\n")
                        metrics_fp.flush()
                    if checkpoint_every and checkpoint_dir and (
                        self.step_count % checkpoint_every == 0
                        or done >= total
                    ):
                        # the write overlaps the next chunk on a thread, from
                        # a host copy (the next chunk reuses the state's
                        # storage)
                        with span("lbm.ckpt.copy"):
                            self._checkpoint(checkpoint_dir, submit)
        finally:
            # join the in-flight checkpoint (surfacing its errors) and close
            # the metrics file even when a chunk raised
            try:
                self._async_ckpt.wait()
            except Exception as ckpt_err:
                if sys.exc_info()[1] is None:
                    raise
                # don't mask the in-flight exception with the write failure
                print(f"warning: async checkpoint failed: {ckpt_err}",
                      file=sys.stderr)
            if metrics_fp is not None:
                metrics_fp.close()
        with span("lbm.sim.result"):
            self._sync()
            elapsed = time.perf_counter() - t0
            return SimulationResult(
                params=self.params,
                av_vels=self.av_vels[: self.step_count].copy(),
                reynolds=self.reynolds(),
                elapsed_s=elapsed,
                sim=self,
                epoch=self.epoch,
            )

    # -- observables ------------------------------------------------------
    def _av_velocity(self) -> torch.Tensor:
        return scale_sums(self._shard_sum(speed_sum), self.params)

    @spanned("lbm.sim.reynolds")
    def reynolds(self) -> float:
        return float(reynolds_of(self._av_velocity(), self.params))

    @spanned("lbm.sim.reynolds")
    def average_velocity(self) -> float:
        return float(self._av_velocity())

    # -- persistence ------------------------------------------------------
    @spanned("lbm.io.write")
    def write_outputs(self, out_dir: str | os.PathLike = ".") -> None:
        """Write final_state.dat + av_vels.dat; the output planes are
        computed on each shard's device and read back once. Under several
        processes process 0 gathers them and writes; the others return
        after the gather."""
        with span("lbm.diag.planes"):
            planes = [output_fields(f, o, self.params.density)
                      for f, o in zip(self.shards, self.obst_shards)]
            fields = [self._gather([p[i].cpu() for p in planes], "cpu")
                      for i in range(4)]
        if not self.output:
            return
        os.makedirs(out_dir, exist_ok=True)
        write_final_state(
            os.path.join(out_dir, "final_state.dat"),
            None,
            self.obstacles.cpu().numpy(),
            self.params,
            fields=[f.numpy() for f in fields],
        )
        write_av_vels(
            os.path.join(out_dir, "av_vels.dat"),
            self.av_vels[: self.step_count],
        )

    def _host_state(self) -> Optional[np.ndarray]:
        """A host copy of the gathered state, which no later chunk writes
        (None but on process 0), made once the writer thread is done with
        the last save's. On one region it is one pageable buffer kept for
        the Simulation's life, refilled by a synchronous copy (a fresh
        37.7 MB tensor at 1024² costs its page faults on every save)."""
        if len(self.regions) == 1:
            if self._host_f is None:
                self._host_f = torch.empty_like(self.shards[0],
                                                device="cpu")
            self._async_ckpt.wait()
            return self._host_f.copy_(self.shards[0]).numpy()
        f = self._gather(self.shards, "cpu")
        self._async_ckpt.wait()
        return None if f is None else f.numpy()

    def _checkpoint(self, directory, save):
        """Hand a checkpoint of this step to ``save``: the writer thread's
        ``AsyncCheckpointer.submit``, or the backend's own writer
        (``ckpt.save_dcp``, ``ckpt.save``). For ``dcp`` every process hands
        over host copies of its own shards, for ``npz`` process 0 the
        gathered state (the others return None); the history as far as this
        step, a view (later chunks write only past it). An npz save of one
        region on a CUDA device hands over a pinned buffer that a side
        stream fills (``ckpt.HostStage``) and the event its writer waits
        on, so up to two writes queue; the main thread only queues the
        copies."""
        av_vels = self.av_vels[: self.step_count]
        if self.ckpt_backend == "dcp":
            pieces = {(r0, c0): self.shards[j].to("cpu", copy=True)
                      for j, (r0, _, c0, _) in enumerate(
                          self.regions[d] for d in self.transport.local)}
            group = (multihost.checkpoint_group()
                     if self.transport.world > 1 else None)
            return save(directory, self.step_count, pieces, av_vels,
                        self.params, group=group)
        if len(self.regions) == 1 and self.shards[0].device.type == "cuda":
            if self._stage is None:
                self._stage = ckpt.HostStage(self.shards[0])
            f, ready = self._stage.copy(self.shards[0], self._async_ckpt)
            return save(directory, self.step_count, f, av_vels, self.params,
                        ready=ready)
        f = self._host_state()
        if f is None:
            return None
        return save(directory, self.step_count, f, av_vels, self.params)

    def save_checkpoint(self, directory: str | os.PathLike) -> Optional[str]:
        """Write a checkpoint of this step now; returns its path (None on
        processes other than 0 with ``npz``)."""
        return self._checkpoint(
            directory, ckpt.save_dcp if self.ckpt_backend == "dcp"
            else ckpt.save)

    @spanned("lbm.ckpt.restore")
    def restore_checkpoint(self, path_or_dir: str | os.PathLike) -> None:
        """Resume from a checkpoint of either package, written on any mesh
        and process count: each process takes its shards' rows (from a dcp
        checkpoint it reads them alone; an npz file is read by process 0
        and scattered)."""
        tr = self.transport
        mine = [self.regions[d] for d in tr.local]
        if tr.world == 1:
            step, pieces, av_vels = ckpt.restore_regions(
                path_or_dir, self.params, mine)
        else:
            path, err = tr.broadcast(
                _attempt(ckpt.resolve, path_or_dir) if self.output else None)
            if err is not None:
                raise err
            if ckpt.is_dcp(path):
                step, pieces, av_vels = ckpt.restore_regions(
                    path, self.params, mine)
            else:
                got, err = (_attempt(ckpt.restore, path, self.params)
                            if self.output else (None, None))
                head, err = tr.broadcast(
                    ((got[0], got[2]) if got else None, err))
                if err is not None:
                    raise err
                step, av_vels = head
                pieces = multihost.scatter_from_host(
                    tr, [torch.from_numpy(got[1][:, r0:r1, c0:c1])
                     for r0, r1, c0, c1 in self.regions] if got else None,
                    [(9, r1 - r0, c1 - c0)
                     for r0, r1, c0, c1 in self.regions])
        self.step_count = step
        self.av_vels[: av_vels.size] = av_vels[: self.av_vels.size]
        self.shards = []
        self.epoch += 1
        self.shards = [torch.as_tensor(p).to(tr.devices[d]).contiguous()
                       for d, p in zip(tr.local, pieces)]


def _attempt(fn, *args):
    """(fn(*args), None), or (None, the error) where it raised one of the
    errors a restore reports."""
    try:
        return fn(*args), None
    except (FileNotFoundError, ValueError) as e:
        return None, e
