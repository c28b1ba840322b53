"""A parameter sweep: whole solves of the deck back to back, one at a time
(a closed loop), each with its own (omega, accel) drawn from the seed.

A solve is what a user's sweep script does for each member: build a
``Simulation`` and ``settle`` it (span ``build``), ``run()`` the deck's
maxIters (``run``), read ``reynolds()`` (``reynolds``) and
``write_outputs()`` both files into one directory under TMPDIR, which
every solve overwrites (``write``). Set-up makes ``warmup_solves`` of them.
The window ends with the last solve that began before ``--seconds`` had
passed. ``samples`` solves of the window, drawn from the seed, keep their
files (the directory is renamed); the reference recomputes each from the
state at rest and the files as written are compared with it.
"""

import os
import shutil
import time

import numpy as np

from lbmbench import compare, spec
from lbmbench.cell import Reservoir, log


def run(run):
    cfg, traffic = run.config, run.traffic
    steps = cfg["maxIters"]
    out = os.path.join(run.out_dir, "solve")

    def solve(omega, accel):
        with run.span("build"):
            sim = run.simulation(run.params(omega, accel))
            sim.settle()
        with run.span("run"):
            sim.run()
        with run.span("reynolds"):
            re = sim.reynolds()
        with run.span("write"):
            sim.write_outputs(out)
        return re

    for _ in range(int(traffic["warmup_solves"])):
        solve(*spec.draw(run.draws, cfg))
    run.setup_done()

    pick = Reservoir(int(traffic["samples"]), run.samples)
    kept, times, failed = {}, [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        omega, accel = spec.draw(run.draws, cfg)
        t = time.perf_counter()
        run.trace_before(t - t0)
        try:
            re = solve(omega, accel)
        except FloatingPointError as e:
            log(f"solve {len(times)}: {e}")
            failed += 1
            break
        times.append(time.perf_counter() - t)
        slot = pick.offer(len(times) - 1)
        if slot is not None:
            dest = os.path.join(run.out_dir, f"kept{slot}")
            shutil.rmtree(dest, ignore_errors=True)
            os.rename(out, dest)
            kept[slot] = (dest, omega, accel, re)
        run.trace_after(steps)
    wall = time.perf_counter() - t0
    run.trace_end()
    run.read_peak()
    run.free()
    _check(run, list(kept.values()), steps)
    return {"metrics": {
        "sweep_mlups": run.cells * steps * len(times) / wall / 1e6,
        "solve_ms.p90": float(np.percentile(times, 90)) * 1e3},
        "attempted": len(times) + failed, "failed": failed}


def _check(run, kept, steps):
    """The reference recomputes the kept solves in one batch; their files
    and Reynolds numbers are held to it."""
    ref = run.reference([k[1] for k in kept], [k[2] for k in kept])
    f, av = ref.run(ref.initial(), steps)
    fields = ref.fields(f).cpu().numpy()
    re = ref.reynolds(f)
    faults = 0
    for b, (dest, _, _, re_prog) in enumerate(kept):
        av_prog, bad = compare.read_av_vels(
            os.path.join(dest, "av_vels.dat"), steps)
        planes, bad2 = compare.read_final_state(
            os.path.join(dest, "final_state.dat"), run.mask)
        faults += bad + bad2
        head = compare.HEAD_STEPS
        got = {"av_head": compare.gap(av_prog[:head], av[b][:head]),
               "av_rel": compare.gap(av_prog, av[b]),
               "field_rel": float("inf") if planes is None
               else compare.field_gap(planes, fields[b]),
               "re_rel": abs(re_prog - re[b]) / abs(re[b])}
        log(f"kept solve {b}:", " ".join(f"{k} {v!r}" for k, v in got.items()))
        for name, value in got.items():
            run.check(name, value)
    run.check("faults", faults)
