"""Long solves: one Simulation continues the deck's flow past its maxIters
in runner calls of ``call_steps`` steps (``"deck"``: the deck's maxIters),
back to back: a closed loop, one solve stream, as a user's long solve
``sim.run(n_steps=..., chunk=call_steps)``.

Set-up builds the Simulation with one (omega, accel) drawn from the seed,
settles it and makes ``warmup_calls`` calls of one ``run(n_steps=call)``
each; the reference follows the first from the state at rest (the
start), and the last times a call. The window is K runner calls, K the
calls of that time that fit in ``--seconds`` (at least one, at most what
the Simulation's max_iters, sized from the config's ``max_mlups``,
holds), run as ``run(n_steps=..., chunk=call)`` in segments: one call of
the window, drawn from the seed, is a segment of its own, whose input
state and whose state, av series and Reynolds number the harness keeps
and the reference follows from that input; with ``--trace 1`` the traced
sub-window, the calls of ``trace_seconds`` in the middle of the window,
is another. ``mlups`` is the lattice updates of the K calls over the
window's wall time.
"""

import math
import time

from lbmbench import compare, spec
from lbmbench.cell import log


def run(run):
    cfg, traffic = run.config, run.traffic
    call = (cfg["maxIters"] if traffic["call_steps"] == "deck"
            else int(traffic["call_steps"]))
    warm = int(traffic["warmup_calls"])
    omega, accel = spec.draw(run.draws, cfg)
    calls_max = math.ceil(cfg["max_mlups"] * 1e6 * run.seconds
                          / (run.cells * call))
    sim = run.simulation(run.params(omega, accel,
                                    max_iters=call * (warm + calls_max)))
    sim.settle()
    r = sim.run(n_steps=call)
    start = (None, sim.f.clone(), r.av_vels.copy(), r.reynolds)
    del r
    for _ in range(warm - 1):
        t = time.perf_counter()
        sim.run(n_steps=call)
        t_call = time.perf_counter() - t
    calls = max(1, min(calls_max, int(run.seconds / t_call)))
    pick = int(run.samples.integers(0, calls))
    cuts = {0, pick, pick + 1, calls}
    traced = traced_end = None
    if run.session is not None:
        n = max(1, math.ceil(traffic["trace_seconds"] / t_call))
        traced = max(0, (calls - n) // 2)
        traced_end = min(calls, traced + n)
        cuts |= {traced, traced_end}
    cuts = sorted(cuts)
    run.setup_done()

    sample, done, failed = None, 0, 0
    t0 = time.perf_counter()
    for lo, hi in zip(cuts, cuts[1:]):
        if lo == traced:
            run.trace_begin()
        f_in = sim.f.clone() if lo == pick else None
        at = sim.step_count
        try:
            with run.span("run"):
                r = sim.run(n_steps=(hi - lo) * call, chunk=call)
        except FloatingPointError as e:
            log(f"calls {lo}-{hi - 1}: {e}")
            failed = 1
            break
        if lo == pick:
            sample = (f_in, sim.f.clone(), r.av_vels[at:at + call].copy(),
                      r.reynolds)
        del r
        done = hi
        run.trace_after((hi - lo) * call, hi - lo, last=hi == traced_end)
    wall = time.perf_counter() - t0
    run.trace_end()
    run.read_peak()
    faults = abs(sim.step_count - call * (warm + done))
    faults += compare.history_faults(sim.av_vels[:sim.step_count])
    run.check("faults", faults)
    del sim
    run.free()
    _check(run, [s for s in (start, sample) if s is not None], omega, accel,
           call)
    return {"metrics": {"mlups": run.cells * call * done / wall / 1e6},
            "attempted": calls, "failed": failed}


def _check(run, kept, omega, accel, call):
    """The reference follows each kept call from its input (the state at
    rest for the start) for ``call`` steps, all in one batch."""
    ref = run.reference([omega] * len(kept), [accel] * len(kept))
    f = ref.initial()
    for b, (f_in, *_) in enumerate(kept):
        if f_in is not None:
            f[b] = f_in.to(f.device)
    f, av = ref.run(f, call)
    re = ref.reynolds(f)
    head = compare.HEAD_STEPS
    for b, (f_in, f_out, av_prog, re_prog) in enumerate(kept):
        got = {"av_rel": compare.gap(av_prog, av[b]),
               "state_rel": compare.gap(f_out.cpu().numpy(),
                                        f[b].cpu().numpy()),
               "re_rel": abs(re_prog - re[b]) / abs(re[b])}
        if f_in is None:
            got["av_head"] = compare.gap(av_prog[:head], av[b][:head])
        log("from rest:" if f_in is None else "window call:",
            " ".join(f"{k} {v!r}" for k, v in got.items()))
        for name, value in got.items():
            run.check(name, value)
