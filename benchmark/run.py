#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA cards of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic and
its metrics are found by name (``BENCHMARK.json``, ``benchmark/README.md``).
The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared with the plain reference,
each beside its limit. With no CUDA card, or fewer than the cell asks for,
it prints no result and exits 3; where ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``tpulbm`` is loaded once the window has closed, 4.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

FORBIDDEN = {"jax", "jaxlib", "flax", "tpulbm"}


def loaded_forbidden() -> list:
    """Modules whose top-level name, compared whole, is a forbidden one."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from lbmbench import cell as cellrun
    from lbmbench import spec

    torch.set_num_threads(1)
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    cell = spec.Cell(bench, args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    cellrun.log("cards:", card_line())
    cellrun.log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
                f"cell {cell.name}, seed {args.seed}, {args.seconds} s, "
                f"trace {args.trace}")
    result = cellrun.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    from tpulbm_torch.io import native

    cellrun.log("writer:", "native (g++)" if native.available()
                else "Python (no g++: the same bytes, slower)")
    bad = loaded_forbidden()
    if bad:
        print(f"error: loaded in the measuring process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
