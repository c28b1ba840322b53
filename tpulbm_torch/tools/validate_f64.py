"""Independent float64 oracle of the port, in PyTorch, and its study.

The counterpart of the JAX package's ``scripts/validate_f64.py``: a
double-precision D2Q9-BGK step written directly from the physics
specification, sharing no code with the port's float32 path (it imports
none of ``core.physics``, ``core.state``, ``core.lattice`` or ``ops``; only
the deck readers). It keeps the oracle's own arithmetic: the positivity
guard ``f > w`` with w in float64, the equilibrium written in momenta,
|u| = sqrt(|m|^2) / rho, a float64 ``1 / free cells``, the start state
``density * W[k]`` and a pull stream periodic on both axes.

It runs on the card by default. There a block of steps is captured once in
a CUDA graph and replayed, each replay's av values copied on the device
into the series, which is read back once at the end; on the CPU, and for
the steps left over, the same ops run eagerly. Neither path synchronises
with the host between steps.

The study (``main``), as the JAX package's: the f64 oracle against the
upstream goldens (the reference's double build), the port's float32 route
(``Simulation`` on the same device: the runner's kernel plan on the card,
the plain versions on the CPU) against the oracle, and that route against
the goldens.

    python -m tpulbm_torch.tools.validate_f64 [deck=128x128] [steps=2000] \\
        [--device cuda|cpu]

Run from the repository root (``data/``, ``tests/goldens/``). ``--device``
defaults to ``cuda`` and fails when no GPU is visible.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params

# D2Q9 constants, written out from the stencil definition.
C = np.array(
    [(0, 0), (1, 0), (0, 1), (-1, 0), (0, -1),
     (1, 1), (-1, 1), (-1, -1), (1, -1)]
)
W = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4)
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6])

# Steps captured in one CUDA graph: ~57 nodes a step; a block's capture
# costs what its steps would cost eagerly, once.
GRAPH_STEPS = 100


def device_of(device) -> torch.device:
    """``device`` as a torch.device; raises if it is a CUDA device and no
    GPU is visible (there is no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available "
                           "(torch.cuda.is_available() is false)")
    return dev


def load_deck(deck: str, data_dir="data"):
    """(params with the free-cell count, obstacle mask) of data/<deck>."""
    params = read_params(f"{data_dir}/input_{deck}.params")
    obst, num_free = read_obstacles(
        f"{data_dir}/obstacles_{deck}.dat", params.nx, params.ny)
    return params.with_free_cells(num_free), obst


def _stepper(params, obst, dev):
    """The f64 step: step(f, av_slot) returns the next state and writes the
    step's average |u| into the 0-d tensor av_slot."""
    ny, nx = params.ny, params.nx
    rho0 = float(params.density)
    w1 = rho0 * float(params.accel) / 9.0
    w2 = rho0 * float(params.accel) / 36.0
    omega = float(params.omega)
    obst_np = np.asarray(obst, dtype=bool)
    inv_free = 1.0 / int((~obst_np).sum())
    row = ny - 2

    obst_t = torch.as_tensor(obst_np, device=dev)
    free = ~obst_t
    free_row = free[row]
    # the increments of the accelerated row, per population
    accel = torch.tensor([0.0, w1, 0.0, -w1, 0.0, w2, -w2, -w2, w2],
                         dtype=torch.float64, device=dev)[:, None]
    cx = torch.tensor(C[:, 0], dtype=torch.float64, device=dev)[:, None, None]
    cy = torch.tensor(C[:, 1], dtype=torch.float64, device=dev)[:, None, None]
    w = torch.tensor(W, dtype=torch.float64, device=dev)[:, None, None]
    opp = torch.tensor(OPP, dtype=torch.long, device=dev)
    shifts = [(int(C[k, 1]), int(C[k, 0])) for k in range(9)]

    def step(f, av_slot):
        # inflow acceleration with positivity guard
        ok = free_row & (f[3, row] > w1) & (f[6, row] > w2) & (f[7, row] > w2)
        f[:, row] = torch.where(ok, f[:, row] + accel, f[:, row])
        # pull streaming (periodic both axes)
        t = torch.stack([torch.roll(f[k], shifts[k], dims=(0, 1))
                         for k in range(9)])
        # macroscopics + BGK equilibrium
        rho = t.sum(dim=0)
        mx = t[1] + t[5] + t[8] - t[3] - t[6] - t[7]
        my = t[2] + t[5] + t[6] - t[4] - t[7] - t[8]
        usq = mx * mx + my * my
        cu = cx * mx + cy * my
        cu3 = 3 * cu
        feq = w * (rho + cu3 + 1.5 / rho * (cu3 * cu - usq))
        out = t + omega * (feq - t)
        # bounce-back on obstacles
        out = torch.where(obst_t, torch.index_select(t, 0, opp), out)
        av_slot.copy_(
            torch.where(free, torch.sqrt(usq) / rho, 0.0).sum() * inv_free)
        return out

    return step


def run_f64(params, obst, n_steps, *, device="cuda", graph=True):
    """n_steps of the f64 oracle from the rest state ``density * W[k]``.
    Returns (f, av) as numpy float64, (9, ny, nx) and (n_steps,), read back
    once at the end. On a CUDA device blocks of GRAPH_STEPS steps replay a
    CUDA graph unless ``graph`` is false (the eager path it is held to)."""
    dev = device_of(device)
    step = _stepper(params, obst, dev)
    w = torch.tensor(W, dtype=torch.float64, device=dev)
    f = (float(params.density) * w)[:, None, None].expand(
        9, params.ny, params.nx).contiguous()
    av = torch.empty(n_steps, dtype=torch.float64, device=dev)
    done = 0
    block = min(GRAPH_STEPS, n_steps)
    if graph and dev.type == "cuda" and n_steps >= block > 0:
        with torch.cuda.device(dev):
            av_block = torch.empty(block, dtype=torch.float64, device=dev)
            # one step on a side stream before the capture, as CUDA graphs
            # ask, on a scratch copy of the state
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step(f.clone(), av_block[0])
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                s = f
                for j in range(block):
                    s = step(s, av_block[j])
                f.copy_(s)
            del s
            while n_steps - done >= block:
                g.replay()
                av[done:done + block].copy_(av_block)
                done += block
    for i in range(done, n_steps):
        f = step(f, av[i])
    return f.cpu().numpy(), av.cpu().numpy()


def max_rel(a, ref) -> np.ndarray:
    return np.abs(np.asarray(a, np.float64) - ref) / np.abs(ref)


def study(deck, n_steps, *, device="cuda", data_dir="data",
          golden_dir="tests/goldens"):
    """The oracle study of ``deck`` over ``n_steps``: returns a dict of the
    relative differences (arrays over the steps) ``f64_vs_golden``,
    ``f32_vs_f64`` and ``f32_vs_golden``, the oracle's and the f32 route's
    seconds, and the f32 Simulation (its ``backend``, its route)."""
    from tpulbm_torch.sim.simulation import Simulation

    dev = device_of(device)
    params, obst = load_deck(deck, data_dir)
    t0 = time.perf_counter()
    _, av64 = run_f64(params, obst, n_steps, device=dev)
    f64_s = time.perf_counter() - t0
    golden = np.loadtxt(f"{golden_dir}/{deck}.av_vels.dat", usecols=[1],
                        max_rows=n_steps)
    if golden.shape != (n_steps,):
        raise ValueError(f"{deck}: the golden holds {golden.size} steps, "
                         f"fewer than {n_steps}")
    sim = Simulation(dataclasses.replace(params, max_iters=n_steps), obst,
                     device=dev)
    res = sim.run()
    return {
        "params": params, "sim": sim, "f64_s": f64_s,
        "f32_s": res.elapsed_s, "av64": av64, "av32": res.av_vels,
        "f64_vs_golden": max_rel(av64, golden),
        "f32_vs_f64": max_rel(res.av_vels, av64),
        "f32_vs_golden": max_rel(res.av_vels, golden),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("deck", nargs="?", default="128x128")
    parser.add_argument("steps", nargs="?", type=int, default=2000)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device to run on (default cuda; fails if no "
                             "GPU is visible)")
    args = parser.parse_args(argv)
    try:
        device_of(args.device)
    except RuntimeError as e:
        print(f"Error: --device {args.device}, but {e}", file=sys.stderr)
        return 1
    print(f"f64 oracle: {args.deck}, {args.steps} steps on {args.device} "
          f"...", flush=True)
    r = study(args.deck, args.steps, device=args.device)
    rate = r["params"].nx * r["params"].ny * args.steps / r["f64_s"] / 1e6
    print(f"f64 oracle: {r['f64_s']:.3f} s ({rate:.1f} MLUPS)")
    rel = r["f64_vs_golden"]
    print(f"f64 vs double-build goldens: max rel {rel.max():.3e} "
          f"(mean {rel.mean():.3e})")
    rel = r["f32_vs_f64"]
    print(f"port f32 ({r['sim'].backend}) vs f64 oracle: max rel "
          f"{rel.max():.3e} (mean {rel.mean():.3e})")
    print(f"port f32 vs goldens:         max rel "
          f"{r['f32_vs_golden'].max():.3e} (gate 1e-2)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
