"""K2's plans timed against each other: CTAs and halo depth at each shape.

    python -m tpulbm_torch.tools.resident_sweep [--ctas 32,64,128,132] \\
        [--depths 1,2,3,4] [--shapes 128x128,128x256,256x256,256x512] \\
        [--steps 512,392] [--count]

For each shape (the deck of ``data/`` where there is one, else a seeded 10 %
random mask; a perturbed rest state drawn from a seed on the card) and step
count, runs K2 (``ops.resident._resident_launch``) under the default plan
and, for every count of CTAs in ``--ctas`` and h in ``--depths`` that
``resident_plan`` takes as given (enough rows and columns a CTA for h, a
window that fits), its CTA grid and a column of bands: each run's state
must be bitwise the default plan's (the same cell code in another
schedule), within 5e-7 of the plain version, and its sums within 3e-4.
Times are CUDA-event ms a call, the plans in turns (forward, then
backward) and averaged, then us a step. Prints the card's name and power
limit, one line a plan, then one JSON line of the records. Exits 1 if a
plan disagrees. Needs a CUDA device.

``--count`` times, in place of the plans, the default plan's counting
instance against its plain one (``_resident_launch(..., count=...)``),
chunk against chunk: batches of ``--reps`` launches in turns plain,
counting, counting, plain, ``--rounds`` times, each counting batch paired
with the plain batch beside it. The counting instance's state and sums
must be bitwise the plain one's, and its first launch must count one
launch and its steps; each record has the cost (the median of the pairs'
time ratios, less 1) and what the counters read over the timed launches:
a step's ns and the shares of the warps' time (``ops.resident.COUNTERS``),
and ``idle_warp_share``, the share of the launch's warp-steps in which a
warp has no cell to compute (from the plan alone), whose warps wait at the
step barrier for the whole step.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from tpulbm_torch.ops import resident
from tpulbm_torch.tools.kernel_ab import ROOT, SEED, _deck, _random, cuda_ms

F_ATOL = 5e-7
SUMS_RTOL = 3e-4


def _case(shape: str, seed: int):
    """(params, float mask, perturbed state) of data/<shape> where it
    exists (the state drawn from seed + 1), else of a seeded random mask,
    on the card."""
    if (ROOT / "data" / f"input_{shape}.params").exists():
        return _deck(shape, seed + 1)
    ny, nx = map(int, shape.split("x"))
    return _random(ny, nx, seed)


def plans(ny, nx, ctas, depths):
    """The default plan, then for every count of CTAs and h of the sweep
    that resident_plan takes as given, its CTA grid and a column of bands
    (cx = 1), each once: (cy, cx, h, cells a thread, threads a CTA)."""
    seen = [resident.resident_plan(ny, nx)]
    for c in ctas:
        for h in depths:
            for cy in (0, c):
                plan = resident.resident_plan(ny, nx, c, h, cy)
                if (plan is not None and plan[0] * plan[1] == c
                        and plan[2] == h and plan not in seen):
                    seen.append(plan)
    return [p for p in seen if p is not None]


def sweep(shape, k, ctas, depths, reps, seed):
    p, o, f = _case(shape, seed)
    out = torch.empty_like(f)
    f_r, s_r = resident.resident_chunk_ref(f, o, p, k)
    records, runs = [], []
    for cy, cx, h, _, _ in plans(p.ny, p.nx, ctas, depths):
        def run(c=cy * cx, h=h, cy=cy):
            return resident._resident_launch(f, o, p, k, out, c, h, cy)
        g, sums, _ = run()
        torch.cuda.synchronize()
        plan = resident.launch_plan(p.ny, p.nx, f.device, cy * cx, h, cy)
        records.append({
            "shape": shape, "steps": k, "cy": plan[0], "cx": plan[1],
            "h": plan[2], "cells": plan[3], "threads": plan[4],
            "smem": plan[5],
            "max_abs_err": (g - f_r).abs().max().item(),
            "sums_rel": ((sums - s_r).abs() / s_r.abs()).max().item(),
            "state": g.clone()})
        runs.append(run)
    ms = [0.0] * len(runs)
    for order in (range(len(runs)), reversed(range(len(runs)))):
        for i in order:
            ms[i] += cuda_ms(runs[i], reps) / 2
    first = records[0]["state"]
    for rec, t in zip(records, ms):
        rec["bitwise_default"] = torch.equal(rec.pop("state"), first)
        rec["ms"] = t
        rec["us_a_step"] = 1e3 * t / k
        rec["ok"] = (rec["bitwise_default"] and rec["max_abs_err"] <= F_ATOL
                     and rec["sums_rel"] <= SUMS_RTOL)
        print(f"[sweep] K2 {shape}, {k} steps, {rec['cy']} x {rec['cx']} "
              f"CTAs of {rec['threads']} threads, h = {rec['h']}, "
              f"{rec['cells']} cell(s) a thread, "
              f"{rec['smem']} B a CTA: {t:.4f} ms, {rec['us_a_step']:.3f} us "
              f"a step; max|df| {rec['max_abs_err']:.3e}, sums rel "
              f"{rec['sums_rel']:.3e}, bitwise the default plan's "
              f"{rec['bitwise_default']}", flush=True)
    return records


def idle_warp_share(ny, nx, k, plan):
    """The share of the warp-steps of a k-step launch of ``plan`` (cy, cx,
    h, cells a thread, threads a CTA) over the (ny, nx) grid in which a warp
    has none of its threads' cells to compute: thread t holds cells t + q
    threads of a phase's first region (the block and h - 1 cells a side,
    rows of cols + 2 (h - 1)), and step j of a phase of p steps computes
    the block and p - 1 - j cells a side (``csrc/resident.cu``)."""
    cy, cx, h, cells, threads = plan
    idle, total, memo = 0, 0, {}
    for bi in range(cy):
        rows = resident.band_start(bi + 1, ny, cy) - resident.band_start(
            bi, ny, cy)
        for bj in range(cx):
            cols = resident.band_start(bj + 1, nx, cx) - resident.band_start(
                bj, nx, cx)
            s = 0
            while s < k:
                p = min(h, k - s)
                for j in range(p):
                    d = h - 1 - (p - 1 - j)   # the region's inset
                    if (rows, cols, d) not in memo:
                        w1, r1 = cols + 2 * (h - 1), rows + 2 * (h - 1)
                        li, cj = np.divmod(np.arange(cells * threads), w1)
                        on = ((li >= d) & (li < r1 - d) & (cj >= d)
                              & (cj < w1 - d))
                        warps = on.reshape(cells, threads).any(0).reshape(
                            -1, 32).any(1)
                        memo[rows, cols, d] = int((~warps).sum())
                    idle += memo[rows, cols, d]
                    total += threads // 32
                s += p
    return idle / total


def count_cost(shape, k, rounds, reps, seed):
    """The default plan's counting instance against its plain one at
    ``shape``, k steps a launch (see the module docstring)."""
    p, o, f = _case(shape, seed)
    card = f.device.index
    outs = {c: torch.empty_like(f) for c in (False, True)}
    runs = {c: (lambda c=c: resident._resident_launch(f, o, p, k, outs[c],
                                                      count=c))
            for c in (False, True)}
    resident.reset_counters()
    (g0, s0, _), (g1, s1, _) = runs[False](), runs[True]()
    first = resident.counters()[card]
    ms = {False: [], True: []}
    for _ in range(rounds):
        for c in (False, True, True, False):
            ms[c].append(cuda_ms(runs[c], reps))
    words = resident.counters()[card]
    ratios = sorted(b / a for a, b in zip(ms[False], ms[True]))
    gy, gx, h, cells, threads, _ = resident.launch_plan(p.ny, p.nx, f.device)
    rec = {"shape": shape, "steps": k, "cy": gy, "cx": gx, "h": h,
           "cells": cells, "threads": threads,
           "plain_ms": sum(ms[False]) / rounds / 2,
           "count_ms": sum(ms[True]) / rounds / 2,
           "cost_pct": 100 * (statistics.median(ratios) - 1),
           "pairs_pct": [100 * (r - 1) for r in ratios],
           "bitwise": torch.equal(g0, g1) and torch.equal(s0, s1),
           "first_exact": (first["launches"] == 1 and first["steps"] == k
                           and first["warp_steps"] == k * gy * gx
                           * threads // 32),
           "step_ns": (words["warp_ns"] - words["ends_ns"])
           / words["warp_steps"],
           **{key[:-3] + "_pct": 100 * words[key] / words["warp_ns"]
              for key in ("cell_ns", "fill_ns", "spin_ns", "barrier_ns",
                          "ends_ns")},
           "idle_warp_pct": 100 * idle_warp_share(
               p.ny, p.nx, k, (gy, gx, h, cells, threads)),
           "counters": words}
    rec["ok"] = rec["bitwise"] and rec["first_exact"]
    print(f"[count] K2 {shape}, {k} steps, {gy} x {gx} CTAs of {threads} "
          f"threads, h = {h}: plain {rec['plain_ms']:.4f} ms, counting "
          f"{rec['count_ms']:.4f} ms a chunk, cost {rec['cost_pct']:+.2f} % "
          f"(median of {len(ratios)} pairs, {rec['pairs_pct'][0]:+.2f} to "
          f"{rec['pairs_pct'][-1]:+.2f}); {rec['step_ns']:.0f} ns a step, "
          f"cells {rec['cell_pct']:.1f} %, fill {rec['fill_pct']:.1f} % "
          f"(spin {rec['spin_pct']:.1f} %), barrier {rec['barrier_pct']:.1f}"
          f" % (warp-steps without a cell {rec['idle_warp_pct']:.1f} %), "
          f"ends {rec['ends_pct']:.1f} %; bitwise {rec['bitwise']}, "
          f"first launch counted exactly {rec['first_exact']}", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ctas", default="32,64,128,132")
    ap.add_argument("--depths", default="1,2,3,4")
    ap.add_argument("--shapes", default="128x128,128x256,256x256,256x512")
    ap.add_argument("--steps", default="512")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--count", action="store_true")
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("resident_sweep: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    ctas = [int(c) for c in args.ctas.split(",")]
    depths = [int(h) for h in args.depths.split(",")]
    records = []
    for i, shape in enumerate(args.shapes.split(",")):
        for k in map(int, args.steps.split(",")):
            if args.count:
                records.append(count_cost(shape, k, args.rounds, args.reps,
                                          SEED + 40 + i))
            else:
                records += sweep(shape, k, ctas, depths, args.reps,
                                 SEED + 40 + i)
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "records": records}), flush=True)
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
