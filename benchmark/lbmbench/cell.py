"""One run of one cell: the set-up, the kind's window, the checks and the
result line.

The program is reached through its Python API alone:
``tpulbm_torch.sim.simulation.Simulation`` (the constructor, ``settle``,
``run``, ``reynolds``, ``write_outputs``, ``f``, ``step_count``,
``av_vels``), ``tpulbm_torch.core.params.LBMParams`` and the meshes of
``tpulbm_torch.dist.mesh``. It gets only what the harness generated: the
parameters, the obstacle mask and a mesh of devices.
"""

from __future__ import annotations

import contextlib
import gc
import math
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from lbmbench import compare, devtrace, spec


def log(*parts) -> None:
    print("[bench]", *parts, file=sys.stderr, flush=True)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``:
    ``offer(i)`` says which slot item i takes, or None."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng

    def offer(self, i: int):
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None


class Run:
    """What a kind's ``run`` works with."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 trace: bool, device: str, t_start: float):
        from tpulbm_torch.core.params import LBMParams
        from tpulbm_torch.dist.mesh import get_mesh, get_mesh_2d
        from tpulbm_torch.sim.simulation import Simulation

        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.device = seed, seconds, device
        self.t_start = t_start
        cfg = self.config
        self.nx, self.ny = cfg["nx"], cfg["ny"]
        self.cells = self.nx * self.ny
        self.mask = spec.read_obstacles(spec.ROOT / cfg["obstacles"],
                                        self.nx, self.ny)
        self.draws, self.samples = spec.rngs(seed)
        self._params, self._simulation = LBMParams, Simulation
        layout = cfg.get("layout", {})
        if "ring" in layout:
            self.mesh = get_mesh(layout["ring"], device)
            flat = self.mesh
        elif "torus" in layout:
            self.mesh = get_mesh_2d(*layout["torus"], device)
            flat = [d for row in self.mesh for d in row]
        else:
            self.mesh, flat = None, [torch.device(device)]
        self.cards = sorted({d.index or 0 for d in flat if d.type == "cuda"})
        self.session = devtrace.Session(self.cards) if trace else None
        self.spans = []
        self.checks = {}
        self.setup_s = None
        self.peak = 0
        self.out_dir = tempfile.mkdtemp(prefix="lbmbench-")

    # -- the program -----------------------------------------------------
    def params(self, omega: float, accel: float, max_iters: int = None):
        cfg = self.config
        return self._params(
            nx=self.nx, ny=self.ny,
            max_iters=cfg["maxIters"] if max_iters is None else max_iters,
            reynolds_dim=cfg["reynolds_dim"], density=cfg["density"],
            accel=accel, omega=omega)

    def simulation(self, params):
        return self._simulation(params, self.mask,
                                backend=self.config["backend"],
                                device=self.device, mesh=self.mesh)

    # -- timing, spans, trace ----------------------------------------------
    def setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t_start
        self.spans = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.session is not None and self.session.active:
            with torch.profiler.record_function("bench." + name):
                yield
        else:
            yield
        self.spans.append((name, time.perf_counter() - t0))

    def trace_begin(self) -> None:
        if self.session is not None and self.session.prof is None \
                and not self.session.done:
            self.session.start()

    def trace_before(self, elapsed: float) -> None:
        """Before a whole call or solve, ``elapsed`` seconds into the
        window: open the session once the traced sub-window's start has
        come, the middle of the window less half of ``trace_seconds`` (a
        cost that grows through the window reads its mean there)."""
        if elapsed >= (self.seconds - self.traffic["trace_seconds"]) / 2:
            self.trace_begin()

    def trace_after(self, steps: int, units: int = 1, last=None) -> None:
        """After ``units`` whole calls or solves of ``steps`` lattice steps
        in all: count them while the session traces, and close it where
        ``last`` is true or, where ``last`` is None, once
        ``trace_seconds`` have passed since it opened."""
        s = self.session
        if s is not None and s.active:
            s.add(steps, units)
            if last or (last is None and time.perf_counter() - s.t0
                        >= self.traffic["trace_seconds"]):
                s.stop()

    def trace_end(self) -> None:
        if self.session is not None and self.session.active:
            self.session.stop()

    def read_peak(self) -> None:
        self.peak = max((torch.cuda.max_memory_allocated(c)
                         for c in self.cards), default=0)

    def free(self) -> None:
        gc.collect()
        if self.cards:
            torch.cuda.empty_cache()

    # -- checks -------------------------------------------------------------
    def check(self, name: str, value: float) -> None:
        """Hold ``name``'s widest reading; one that is not a number (the
        run diverged) reads as the largest float, which fails any limit."""
        if not math.isfinite(value):
            value = sys.float_info.max
        self.checks[name] = max(value, self.checks.get(name, value))

    def reference(self, omegas, accels, dtype=torch.float32):
        from lbmbench.reference import Reference

        cfg = self.config
        dev = f"cuda:{self.cards[0]}" if self.cards else "cpu"
        return Reference(self.mask, cfg["density"], cfg["reynolds_dim"],
                         omegas, accels, dtype=dtype, device=dev)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None) -> dict:
    """One run; returns the result line's object, ``checks`` last."""
    if t_start is None:
        t_start = time.perf_counter()
    run = Run(cell, seed, seconds, trace, device, t_start)
    try:
        out = cell.kind.run(run)
    finally:
        shutil.rmtree(run.out_dir, ignore_errors=True)
    checks = {name: {"value": value, "limit": compare.LIMITS[name]}
              for name, value in run.checks.items()}
    correct = bool(checks) and out["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    kind = (torch.cuda.get_device_name(run.cards[0]) if run.cards
            else "cpu")
    dev = {"platform": "gpu" if run.cards else "cpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": run.peak}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        s = run.session
        result["metrics"] = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"])(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        dev.update(busy_s=s.busy_s, window_s=s.window_s)
        result["device"] = dev
        result["breakdown"] = s.breakdown()
    else:
        values = dict(out["metrics"], setup_s=run.setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    result["checks"] = checks
    return result
