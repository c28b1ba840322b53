#!/usr/bin/env python
"""Run a shipped reference deck end-to-end through the Python API of the
PyTorch port (the counterpart of run_reference_deck.py).

    PYTHONPATH=. python examples/torch_run_reference_deck.py [deck=128x128] \
        [--device cuda|cpu] [--max-iters N]

Run from the repository root: the deck is read from data/ and the outputs
are written to out/<deck>. ``--device`` defaults to ``cuda`` and fails when
no GPU is visible; ``--device cpu`` runs the kernels' plain versions.
"""

import argparse
import dataclasses
import sys

import numpy as np
import torch

from tpulbm_torch import Simulation


def main(argv=None):
    """Runs the deck and writes its outputs; returns the run's
    SimulationResult (its ``sim`` is the Simulation)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("deck", nargs="?", default="128x128")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device to run on (default cuda; fails if no "
                             "GPU is visible)")
    parser.add_argument("--max-iters", type=int, default=None,
                        help="override the deck's maxIters")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("Error: --device cuda, but no CUDA device is available "
                 "(torch.cuda.is_available() is false)")

    deck = args.deck
    sim = Simulation.from_files(
        f"data/input_{deck}.params", f"data/obstacles_{deck}.dat",
        device=args.device,
    )
    if args.max_iters is not None:
        # as the CLI's --max-iters: the deck's params and av series resized
        sim.params = dataclasses.replace(sim.params, max_iters=args.max_iters)
        sim.av_vels = np.zeros((args.max_iters,), dtype=np.float32)
    result = sim.run(progress=False)
    print(f"deck {deck}: {result.params.max_iters} steps in "
          f"{result.elapsed_s:.3f} s "
          f"({result.params.total_updates / result.elapsed_s / 1e6:.0f} "
          f"MLUPS)")
    print(f"Reynolds number: {result.reynolds:.4f}")
    sim.write_outputs(f"out/{deck}")
    print(f"wrote out/{deck}/final_state.dat and av_vels.dat")
    return result


if __name__ == "__main__":
    main()
