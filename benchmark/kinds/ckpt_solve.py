"""Checkpointed long solves: a long solve of the deck (``long_solve``'s
runner calls of ``call_steps`` steps, back to back) that writes a
checkpoint every ``checkpoint.every`` steps into a directory under the
run's ``out_dir`` and keeps the newest ``checkpoint.keep``, as a user's
``sim.run(n_steps=..., chunk=call, checkpoint_every=..., checkpoint_dir=...,
checkpoint_keep=...)``; after ``resume`` (one) resume from the newest
checkpoint.

Set-up: Simulation A, built with one (omega, accel) drawn from the seed
and settled, makes ``warmup_calls`` checkpointing calls (the reference
follows the first from rest; the last times a call), then one call with
checkpointing off, whose state is kept; A is dropped. After
``run.setup_done()``, the harness span ``resume``: Simulation B of the
same deck, ``settle()``, ``restore_checkpoint`` of the directory (the
newest checkpoint, A's last save).

The window is B's K runner calls, K the calls of that time that fit in
``--seconds``, run as checkpointing ``run()``s in segments, each ending in
the join of its last write: B's first call, which must give A's kept
state bit for bit; the call drawn from the seed, whose input state the
harness reads from that call's checkpoint with the plain reader
(``lbmbench/ckpt_plain.py``), so the reference follows the checkpoint and
not the program's state; with ``--trace 1`` the traced sub-window. ``mlups``
is the lattice updates of the K calls over the time of their ``run()``s,
saves and joins included, the harness's reads between segments not.

After the window the directory must hold exactly the checkpoints that the
cadence and ``keep`` leave (``ckpt_plain.expected_steps``) and nothing
else, the newest one B's step, state and history bit for bit. Each miss
is one ``faults``.
"""

import math
import os
import time

import numpy as np
import torch

from lbmbench import ckpt_plain, compare, spec
from lbmbench.cell import log

_long = spec.load_module(spec.HERE / "kinds" / "long_solve.py")


def _same(a, b) -> bool:
    """Bit for bit: shape, dtype and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and (
        a.tobytes() == b.tobytes())


def _program_totals() -> dict:
    """The program's checkpoint counters and the seconds of its main
    thread's checkpoint and runner-call spans, where it has them (a tree
    without them reads zeros): for the log line, not for a metric."""
    out = dict.fromkeys(("saves", "write_ns", "lbm.ckpt.copy",
                         "lbm.ckpt.wait", "lbm.dist.call"), 0)
    try:
        from tpulbm_torch.sim import checkpoint
        from tpulbm_torch.utils import profiling
    except ImportError:
        return out
    stats = getattr(checkpoint, "STATS", {})
    spans = profiling.totals()
    for key in out:
        out[key] = stats[key] if key in stats else (
            spans[key][1] if key in spans else 0)
    return out


def run(run):
    cfg, traffic = run.config, run.traffic
    if int(traffic["resume"]) != 1:
        raise ValueError("the ckpt_solve kind makes one resume in set-up")
    ck = cfg["checkpoint"]
    every, keep = int(ck["every"]), int(ck["keep"])
    directory = os.path.join(run.out_dir, ck["dir"])
    saving = dict(checkpoint_every=every, checkpoint_dir=directory,
                  checkpoint_keep=keep)
    call = (cfg["maxIters"] if traffic["call_steps"] == "deck"
            else int(traffic["call_steps"]))
    warm = int(traffic["warmup_calls"])
    omega, accel = spec.draw(run.draws, cfg)
    calls_max = math.ceil(cfg["max_mlups"] * 1e6 * run.seconds
                          / (run.cells * call))
    params = run.params(omega, accel, max_iters=call * (warm + calls_max))

    a = run.simulation(params)
    a.settle()
    runs = []
    for i in range(warm):
        t = time.perf_counter()
        r = a.run(n_steps=call, chunk=call, **saving)
        t_call = time.perf_counter() - t
        runs.append((i * call, (i + 1) * call))
        if i == 0:
            start = (None, a.f.clone(), r.av_vels.copy(), r.reynolds)
        del r
    history = a.av_vels[:warm * call].copy()
    a.run(n_steps=call, chunk=call)
    kept = a.f.clone()
    del a
    run.free()
    run.setup_done()

    with run.span("resume"):
        sim = run.simulation(params)
        sim.settle()
        sim.restore_checkpoint(directory)
    faults = int(sim.step_count != warm * call)
    faults += int(not _same(sim.av_vels[:warm * call], history))

    calls = max(1, min(calls_max, int(run.seconds / t_call)))
    pick = int(run.samples.integers(0, calls))
    cuts = {0, 1, pick, pick + 1, calls}
    traced = traced_end = None
    if run.session is not None:
        n = max(1, math.ceil(traffic["trace_seconds"] / t_call))
        traced = max(0, (calls - n) // 2)
        if traced < pick < traced + n:
            # the harness reads the drawn call's checkpoint before the
            # trace opens
            traced = pick
        traced_end = min(calls, traced + n)
        cuts |= {traced, traced_end}
    cuts = sorted(cuts)

    sample, done, failed, wall = None, 0, 0, 0.0
    before = _program_totals()
    for lo, hi in zip(cuts, cuts[1:]):
        at = sim.step_count
        if lo == pick:
            found, _ = ckpt_plain.listing(directory)
            got = ckpt_plain.read(found[at]) if at in found else None
            faults += int(got is None or got["step"] != at)
            f_in = (torch.from_numpy(got["f"]) if got is not None
                    else sim.f.cpu())
        if lo == traced:
            run.trace_begin()
        try:
            t = time.perf_counter()
            with run.span("run"):
                r = sim.run(n_steps=(hi - lo) * call, chunk=call, **saving)
            wall += time.perf_counter() - t
        except FloatingPointError as e:
            log(f"calls {lo}-{hi - 1}: {e}")
            failed = 1
            break
        runs.append((at, sim.step_count))
        if lo == 0:
            faults += int(not torch.equal(sim.f, kept))
            kept = None
        if lo == pick:
            sample = (f_in, sim.f.clone(), r.av_vels[at:at + call].copy(),
                      r.reynolds)
        del r
        done = hi
        run.trace_after((hi - lo) * call, hi - lo, last=hi == traced_end)
    run.trace_end()
    run.read_peak()
    after = _program_totals()
    log(f"window: {wall!r} s of run() over {done} calls; the program's "
        f"own counts in it: " + ", ".join(
            f"{k} {after[k] - before[k]!r}" for k in after))

    faults += abs(sim.step_count - call * (warm + done))
    faults += compare.history_faults(sim.av_vels[:sim.step_count])
    found, other = ckpt_plain.listing(directory)
    want = ckpt_plain.expected_steps(runs, every, keep)
    faults += len(set(found) ^ set(want)) + len(other)
    if found:
        newest = ckpt_plain.read(found[max(found)])
        step = newest["step"]
        faults += int(step != sim.step_count)
        faults += int(not _same(newest["f"], sim.f.cpu().numpy()))
        faults += int(not _same(newest["av_vels"], sim.av_vels[:step]))
    log(f"checkpoints: {sorted(found)} against {want}, {other} besides; "
        f"faults {faults}")
    run.check("faults", faults)
    del sim
    run.free()
    _long._check(run, [s for s in (start, sample) if s is not None], omega,
                 accel, call)
    return {"metrics": {"mlups": run.cells * call * done / max(wall, 1e-9)
                        / 1e6},
            "attempted": calls, "failed": failed}
