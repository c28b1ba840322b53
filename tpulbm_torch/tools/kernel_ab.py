"""Paired timing of this tree's chunk kernels against another tree's.

    python -m tpulbm_torch.tools.kernel_ab BASE [--match "3 steps"]

BASE is the root of another copy of the repository: an earlier commit
unpacked by ``git archive`` (``git archive ac3136d | tar -x -C build/ab/base``;
``build/`` is git-ignored) or an edited copy. Its ``tpulbm_torch`` package is
imported beside this one, with its own wrappers, C signatures and build
directory, and both kernel libraries are built at once. Each case calls a
public chunk function of each side (``resident_chunk``, ``skew_chunk``,
``tile_chunk``, ``ring_chunk``, as the main path calls them, sums
included; this tree's K6 grid kind, ``grid_p2p_chunks``, over a launch of
chunks at 1024^2, 2048^2, 4096^2, 8192^2 and 100 x 130 against the base
tree's grid kind over the same chunks, where the base has one, and against
the base tree's K4 ``tile_chunk`` chunk by chunk) on the same input,
a perturbed rest state drawn from a seed on the card, at the shapes of the
main path; the states must be bitwise equal and the sums within 3e-4 (the
kernels may sum the same values in another order). Times are CUDA-event ms
a call, in turns base, this, this, base, and the device time a call from
``torch.profiler`` (kernels, copies and fills), which leaves out the host's
launch path: below ~0.1 ms a call the events time the host. Prints the card's name and power limit, one line
per case (``--match``: only the cases whose label holds the text), then
one JSON line of the cases. Exits 1 if a case disagrees.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import _build, kstep, kstep_tile, resident, ring_p2p

ROOT = Path(__file__).resolve().parents[2]
PKG = "tpulbm_torch"
OPS = ("_build", "kstep", "kstep_tile", "resident", "ring_p2p")
SEED = 20260
SUMS_RTOL = 3e-4


def import_tree(root: Path, ops=OPS) -> dict:
    """The ``ops`` modules of the package under ``root`` (those of ``ops``
    that it has), imported beside this process's own: this package's
    entries of ``sys.modules`` are set aside for the import and put back
    after it, so the other tree's modules keep their own globals."""
    def loaded():
        return {n: m for n, m in sys.modules.items()
                if n == PKG or n.startswith(PKG + ".")}

    mine = loaded()
    for name in mine:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        mods = {m: importlib.import_module(f"{PKG}.ops.{m}") for m in ops
                if (root / PKG / "ops" / f"{m}.py").exists()}
    finally:
        sys.path.remove(str(root))
        for name in loaded():
            del sys.modules[name]
        sys.modules.update(mine)
    for mod in mods.values():
        if not Path(mod.__file__).resolve().is_relative_to(root.resolve()):
            raise SystemExit(f"kernel_ab: {mod.__name__} came from "
                             f"{mod.__file__}, not from {root}")
    return mods


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event ms of fn() over reps calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms of fn()'s kernels, copies and fills over reps calls
    (torch.profiler's CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) \
        / 1e3 / reps


def _perturbed(p, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.rand((9, p.ny, p.nx), generator=gen, device="cuda")
    return initial_state(p, "cuda") * (1 + 0.01 * noise)


def _deck(deck, seed):
    """(params, float mask, perturbed state) of data/<deck>, on the card."""
    p = read_params(ROOT / "data" / f"input_{deck}.params")
    mask, n_free = read_obstacles(ROOT / "data" / f"obstacles_{deck}.dat",
                                  p.nx, p.ny)
    p = p.with_free_cells(n_free)
    return (p, torch.tensor(mask, dtype=torch.float32, device="cuda"),
            _perturbed(p, seed))


def _random(ny, nx, seed):
    """A (ny, nx) grid with a seeded 10 % random mask, as _deck."""
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    mask = np.random.RandomState(seed).rand(ny, nx) < 0.1
    p = p.with_free_cells(ny * nx - int(mask.sum()))
    return (p, torch.tensor(mask, dtype=torch.float32, device="cuda"),
            _perturbed(p, seed + 1))


def _ring_args(p, o, f, off, h, k):
    """ring_chunk's arguments for the shard of rows [off, off + h) of f and
    its k-row slabs, cut from the grid (rows wrap) as the ring passes
    them."""
    rows = torch.arange(off - k, off + h + k, device="cuda") % p.ny
    band = f[:, rows]
    return (band[:, :k].contiguous(), band[:, k:k + h].contiguous(),
            band[:, k + h:].contiguous(), o[rows].contiguous(), p, k,
            (off - k) % p.ny)


def _k4_chain(n):
    """A side's n chunks of K4's whole grid (``tile_chunk``) as one call:
    (its ops modules) -> fn(f, o, p, k) -> (the state, the sums)."""
    def make(mods):
        def run(f, o, p, k):
            sums = []
            for _ in range(n):
                f, s = mods["kstep_tile"].tile_chunk(f, o, p, k)
                sums.append(s)
            return f, torch.cat(sums)
        return run
    return make


def _grid(n):
    """A side's grid-kind launch of n chunks (``grid_p2p_chunks``) on a
    copy of f (the launch takes its input over), as _k4_chain."""
    def make(mods):
        def run(f, o, p, k):
            g, _, s = mods["ring_p2p"].grid_p2p_chunks(
                f.clone(), torch.empty_like(f), o, p, k, n)
            return g, s
        return run
    return make


def cases():
    """(label, (side, ops module, function, arguments) of the base and of
    this tree) at the main path's shapes, grouped by input so that one grid
    is on the card at a time; side "base" or "this". A function is a name
    in the module, or a callable that makes it from the side's modules
    (the module then None)."""
    for label, mod, fn, args in _same_cases():
        yield label, ("base", mod, fn, args), ("this", mod, fn, args)
    yield from _route_cases()



def _route_cases():
    """This tree's grid kind against the base tree's grid kind and K4 over
    the chunks of one of this tree's launches (``--match route``; the
    base's grid kind only where the base has one)."""
    k = kstep_tile.TILE_K
    for deck, seed in (("1024x1024", SEED + 1), ("2048x2048", SEED + 6),
                       ("4096x4096", SEED + 8), ("8192x8192", SEED + 7),
                       (None, SEED + 130)):
        p, o, f = _deck(deck, seed) if deck else _random(100, 130, seed)
        n = ring_p2p.grid_outer_per_launch(p.ny, p.nx, k)
        what = f"{p.ny}x{p.nx}, {n} chunks of {k} steps in a launch"
        yield (f"route: K6 grid kind {what} vs base grid kind",
               ("base", None, _grid(n), (f, o, p, k)),
               ("this", None, _grid(n), (f, o, p, k)))
        yield (f"route: K6 grid kind {what} vs base K4",
               ("base", None, _k4_chain(n), (f, o, p, k)),
               ("this", None, _grid(n), (f, o, p, k)))


def _same_cases():
    """(label, ops module, function, arguments): one function of both
    trees."""
    k = kstep_tile.TILE_K
    for deck, seed in (("128x128", SEED), ("128x256", SEED + 13),
                       ("256x256", SEED + 14)):
        p, o, f = _deck(deck, seed)
        yield (f"K2 {deck}, 512 steps", "resident", "resident_chunk",
               (f, o, p, resident.RESIDENT_K))
    p, o, f = _random(256, 512, SEED + 4)
    yield ("K2 256x512, 512 steps", "resident", "resident_chunk",
           (f, o, p, resident.RESIDENT_K))
    p, o, f = _deck("1024x1024", SEED + 1)
    yield ("K1 1024x1024, 8 steps", "kstep", "skew_chunk", (f, o, p))
    yield ("K4 ring 1024x1024 shard 3 of 4 (256 rows), 8 steps",
           "kstep_tile", "ring_chunk", _ring_args(p, o, f, 768, 256, k))
    yield ("K4 ring 1024x1024 shard 0 of 4 (256 rows), 1 step",
           "kstep_tile", "ring_chunk", _ring_args(p, o, f, 0, 256, 1))
    p, o, f = _deck("2048x2048", SEED + 6)
    yield ("K4 2048x2048, 8 steps", "kstep_tile", "tile_chunk", (f, o, p, k))
    yield ("K4 2048x2048, 3 steps", "kstep_tile", "tile_chunk", (f, o, p, 3))
    p, o, f = _deck("4096x4096", SEED + 8)
    yield ("K4 4096x4096, 8 steps", "kstep_tile", "tile_chunk", (f, o, p, k))
    yield ("K4 ring 4096x4096 fold band (28 rows), 8 steps", "kstep_tile",
           "ring_chunk", _ring_args(p, o, f, p.ny - 14, 28, k))
    p, o, f = _deck("8192x8192", SEED + 7)
    yield ("K4 8192x8192, 8 steps", "kstep_tile", "tile_chunk", (f, o, p, k))
    yield ("K4 ring 8192x8192 shard 3 of 4 (2048 rows), 8 steps",
           "kstep_tile", "ring_chunk", _ring_args(p, o, f, 6144, 2048, k))
    yield ("K4 ring 8192x8192 seam band (16 rows), 8 steps", "kstep_tile",
           "ring_chunk", _ring_args(p, o, f, p.ny - 8, 16, k))
    p, o, f = _random(128, 512, SEED + 128)
    yield ("K4 128x512, 8 steps", "kstep_tile", "tile_chunk", (f, o, p, k))


def run_case(label, base_fn, base_args, this_fn, this_args):
    f_b, s_b = base_fn(*base_args)
    f_t, s_t = this_fn(*this_args)
    torch.cuda.synchronize()
    same = torch.equal(f_b, f_t)
    rel = ((s_t - s_b).abs() / s_b.abs()).max().item()
    del f_b, f_t
    reps = min(400, max(5, int(40 / max(
        cuda_ms(lambda: this_fn(*this_args), 3), 1e-3))))
    turns = ((base_fn, base_args), (this_fn, this_args))
    ms = [cuda_ms(lambda fn=fn, a=a: fn(*a), reps)
          for fn, a in (turns[0], turns[1], turns[1], turns[0])]
    dev = [device_ms(lambda fn=fn, a=a: fn(*a), reps) for fn, a in turns]
    base, this = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
    print(f"[ab] {label}: base {ms[0]:.4f} / {ms[3]:.4f} ms, this "
          f"{ms[1]:.4f} / {ms[2]:.4f} ms (turns base, this, this, base; "
          f"{reps} calls a turn); this/base {this / base:.3f}; device "
          f"{dev[0]:.4f} / {dev[1]:.4f} ms, this/base {dev[1] / dev[0]:.3f}; "
          f"state bitwise {same}, sums rel {rel:.3e}", flush=True)
    return {"case": label, "base_ms": [ms[0], ms[3]],
            "this_ms": [ms[1], ms[2]], "ratio": this / base,
            "base_device_ms": dev[0], "this_device_ms": dev[1],
            "state_bitwise": same, "sums_rel": rel,
            "ok": same and rel <= SUMS_RTOL}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path,
                    help="root of the other tree (holds tpulbm_torch/)")
    ap.add_argument("--match", default="",
                    help="run only the cases whose label holds this text")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    base = import_tree(args.base)
    this = {"_build": _build, "kstep": kstep, "kstep_tile": kstep_tile,
            "resident": resident, "ring_p2p": ring_p2p}
    sides = {"base": base, "this": this}

    def resolve(side, mod, fn):
        return fn(sides[side]) if callable(fn) else getattr(sides[side][mod],
                                                            fn)

    with ThreadPoolExecutor(2) as pool:
        for lib in pool.map(lambda b: b.library(),
                            (base["_build"], _build)):
            print(f"[ab] built {lib._name}", flush=True)
    records = []
    for case in cases():
        label, (bs, bmod, bfn, bargs), (ts, tmod, tfn, targs) = case
        if args.match not in label:
            continue
        records.append(run_case(label, resolve(bs, bmod, bfn), bargs,
                                resolve(ts, tmod, tfn), targs))
        del case, bargs, targs
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "base": str(args.base), "cases": records}), flush=True)
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
