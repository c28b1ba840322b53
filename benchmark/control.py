#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``: the plain
reference computed in bfloat16, the precision below the configuration's
float32, put in the program's place, and held to the float32 reference
by the numbers of ``lbmbench/compare.py``. Its readings are the upper
ends the limits are set below (PERF.md).

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 [--cpu]

For each seed it draws the run's first (omega, accel) as ``run.py`` does
and follows, from rest, what the cell's first comparison follows: a long
solve's first runner call, a sweep's whole solve. The benchmark's own
runs do not run it.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lbmbench import compare, spec  # noqa: E402
from lbmbench.reference import Reference  # noqa: E402


def readings(cell: spec.Cell, seed: int, device: str) -> dict:
    cfg, traffic = cell.config, cell.traffic
    mask = spec.read_obstacles(spec.ROOT / cfg["obstacles"], cfg["nx"],
                               cfg["ny"])
    omega, accel = spec.draw(spec.rngs(seed)[0], cfg)
    steps = cfg["maxIters"]
    if traffic.get("call_steps", "deck") != "deck":
        steps = int(traffic["call_steps"])
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        ref = Reference(mask, cfg["density"], cfg["reynolds_dim"], [omega],
                        [accel], dtype=dtype, device=device)
        f, av = ref.run(ref.initial(), steps)
        out[dtype] = (f[0].double().cpu().numpy(), av[0], ref.reynolds(f)[0],
                      ref.fields(f)[0].cpu().numpy())
    (f, av, re, fields), (g, bv, rg, gields) = (out[torch.float32],
                                                out[torch.bfloat16])
    head = compare.HEAD_STEPS
    got = {"av_head": compare.gap(bv[:head], av[:head]),
           "av_rel": compare.gap(bv, av), "re_rel": abs(rg - re) / abs(re)}
    if traffic["kind"] == "sweep":
        got["field_rel"] = compare.field_gap(gields, fields)
    else:
        got["state_rel"] = compare.gap(g, f)
    bad = ~np.isfinite(bv)
    got["diverged_at_step"] = int(np.argmax(bad)) if bad.any() else None
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a test's size)")
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_json(spec.ROOT / "BENCHMARK.json"),
                     args.workload)
    device = "cpu" if args.cpu else "cuda:0"
    for seed in args.seeds:
        got = readings(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16", **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
