"""Regenerate the f64-oracle final-state goldens with the port's oracle, and
hold them against the committed ones.

The counterpart of the JAX package's ``scripts/make_f64_goldens.py``: the
reference ships no final-state golden for 256x256 and 1024x1024, and the
committed ``tests/goldens/{deck}.final_state.f64.npz`` files, which the
golden gate reads for those decks, come from the JAX package's float64
oracle. This tool reruns each deck's full iteration count through the
port's own oracle (``tools.validate_f64.run_f64``, on the card by default;
one engine for every deck), gates its av series against the upstream
golden over the whole series at AV_GATE, and writes the pressure plane
(the only final-state field the gate reads) with the committed files' keys
and dtypes under ``--out-dir``. It never writes into ``tests/goldens/``:
with ``--compare DIR`` (default ``tests/goldens``) it reports, for each
deck, the largest relative difference of the pressure against DIR's golden
and the count of elements that differ, and fails above COMPARE_GATE.

    python -m tpulbm_torch.tools.make_f64_goldens [deck ...] \\
        [--device cuda|cpu] [--out-dir build/f64_goldens] \\
        [--compare tests/goldens] [--max-iters N]

Run from the repository root. Decks default to 256x256 and 1024x1024;
``--max-iters`` cuts the run (the av gate then reads the golden's prefix).
Exits non-zero when a gate fails or, with ``--device cuda`` (the default),
when no GPU is visible.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from tpulbm_torch.tools.validate_f64 import (device_of, load_deck, max_rel,
                                             run_f64)

AV_GATE = 1e-4       # f64 av series against the upstream golden, relative
COMPARE_GATE = 1e-6  # pressure against the committed golden, relative
DEFAULT_OUT = os.path.join("build", "f64_goldens")
GENERATOR = (b"tpulbm_torch tpulbm_torch/tools/make_f64_goldens.py "
             b"(independent f64 oracle in PyTorch; av series cross-checked "
             b"vs upstream golden)")


class GateError(RuntimeError):
    """An oracle run or a regenerated golden failed its gate."""


def check_av(av, golden_file) -> float:
    """The max relative difference of the av series against the first
    len(av) steps of the upstream golden; raises GateError above
    AV_GATE."""
    golden = np.loadtxt(golden_file, usecols=[1], max_rows=len(av))
    if golden.shape != np.shape(av):
        raise GateError(f"{golden_file}: {golden.size} steps, not {len(av)}")
    rel = float(max_rel(av, golden).max())
    if not rel <= AV_GATE:
        raise GateError(f"f64 oracle diverged from the upstream av golden "
                        f"{golden_file}: max rel {rel:.3e} > {AV_GATE:g}")
    return rel


def pressure(f, obst, density) -> np.ndarray:
    """The final state's pressure plane in float64: rho / 3 on free cells,
    the ambient density / 3 on obstacles (d2q9-bgk.c:1076-1080)."""
    return np.where(obst, density / 3.0, f.sum(axis=0) / 3.0)


def write_golden(path, plane, steps) -> None:
    """The npz golden: ``pressure`` float32 (ny, nx), ``steps`` int64,
    ``generator`` bytes, as the committed files."""
    np.savez_compressed(path, pressure=plane.astype(np.float32),
                        steps=np.int64(steps),
                        generator=np.bytes_(GENERATOR))


def compare(path, committed):
    """(max relative difference, elements that differ) of the pressure of
    the npz golden ``path`` against ``committed``."""
    with np.load(path) as a, np.load(committed) as b:
        new, ref = a["pressure"], b["pressure"]
        if new.shape != ref.shape or int(a["steps"]) != int(b["steps"]):
            raise GateError(f"{path}: shape {new.shape} and {int(a['steps'])}"
                            f" steps against {committed}'s {ref.shape} and "
                            f"{int(b['steps'])}")
    return (float(max_rel(new, ref.astype(np.float64)).max()),
            int(np.count_nonzero(new != ref)))


def make_golden(deck, *, device="cuda", out_dir=DEFAULT_OUT,
                data_dir="data", golden_dir="tests/goldens", n_steps=None):
    """Runs ``deck`` through the f64 oracle (its maxIters, or n_steps),
    gates the av series and writes ``{out_dir}/{deck}.final_state.f64.npz``.
    Returns (path, seconds of the oracle, av max rel)."""
    params, obst = load_deck(deck, data_dir)
    n = params.max_iters if n_steps is None else n_steps
    t0 = time.perf_counter()
    f, av = run_f64(params, obst, n, device=device)
    seconds = time.perf_counter() - t0
    rel = check_av(av, os.path.join(golden_dir, f"{deck}.av_vels.dat"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{deck}.final_state.f64.npz")
    write_golden(path, pressure(f, obst, params.density), n)
    return path, seconds, rel


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("decks", nargs="*",
                        default=["256x256", "1024x1024"])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device to run on (default cuda; fails if no "
                             "GPU is visible)")
    parser.add_argument("--out-dir", default=DEFAULT_OUT,
                        help="where the goldens are written (default "
                             "%(default)s; never tests/goldens)")
    parser.add_argument("--compare", default="tests/goldens", metavar="DIR",
                        help="hold each golden against DIR's (default "
                             "%(default)s)")
    parser.add_argument("--max-iters", type=int, default=None,
                        help="override the decks' maxIters")
    args = parser.parse_args(argv)
    try:
        device_of(args.device)
    except RuntimeError as e:
        print(f"Error: --device {args.device}, but {e}", file=sys.stderr)
        return 1
    kept = {os.path.realpath(d) for d in ("tests/goldens", args.compare)}
    if os.path.realpath(args.out_dir) in kept:
        print(f"Error: --out-dir {args.out_dir} holds the committed goldens",
              file=sys.stderr)
        return 1
    failed = False
    for deck in args.decks:
        print(f"{deck}: f64 oracle on {args.device} ...", flush=True)
        try:
            path, seconds, rel = make_golden(
                deck, device=args.device, out_dir=args.out_dir,
                n_steps=args.max_iters)
        except GateError as e:
            print(f"{deck}: FAILED: {e}", flush=True)
            failed = True
            continue
        with np.load(path) as z:
            steps, (ny, nx) = int(z["steps"]), z["pressure"].shape
        print(f"{deck}: {steps} steps in {seconds:.3f} s "
              f"({nx * ny * steps / seconds / 1e6:.1f} MLUPS); av_vels vs "
              f"upstream golden max rel {rel:.3e} (gate {AV_GATE:g}); "
              f"wrote {path}", flush=True)
        committed = os.path.join(args.compare, f"{deck}.final_state.f64.npz")
        if not os.path.exists(committed):
            print(f"{deck}: no committed golden to compare with")
            continue
        try:
            worst, n_diff = compare(path, committed)
        except GateError as e:
            print(f"{deck}: FAILED: {e}", flush=True)
            failed = True
            continue
        ok = worst <= COMPARE_GATE
        failed |= not ok
        print(f"{deck}: pressure vs {committed}: max rel {worst:.3e}, "
              f"{n_diff} of {nx * ny} elements differ "
              f"(gate {COMPARE_GATE:g}): {'ok' if ok else 'FAILED'}",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
