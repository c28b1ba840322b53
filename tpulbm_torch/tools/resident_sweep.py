"""K2's plans timed against each other: CTAs and halo depth at each shape.

    python -m tpulbm_torch.tools.resident_sweep [--ctas 32,64,128,132] \\
        [--depths 1,2,3,4] [--shapes 128x128,128x256,256x256,256x512] \\
        [--steps 512,392]

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
"""

from __future__ import annotations

import argparse
import json
import subprocess

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ctas", default="32,64,128,132")
    ap.add_argument("--depths", default="1,2,3,4")
    ap.add_argument("--shapes", default="128x128,128x256,256x256,256x512")
    ap.add_argument("--steps", default="512")
    ap.add_argument("--reps", type=int, default=20)
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
            records += sweep(shape, k, ctas, depths, args.reps, SEED + 40 + i)
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "records": records}), flush=True)
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
