#!/usr/bin/env python
"""Build a custom scenario programmatically with the PyTorch port: generate a
deck with interior obstacles, run with checkpointing and live metrics, then
plot the flow and resume from the last checkpoint (the counterpart of
custom_simulation.py).

    PYTHONPATH=. python examples/torch_custom_simulation.py \
        [--device cuda|cpu] [--max-iters N]

The outputs go to out/custom, out/custom_ckpts and out/custom_metrics.jsonl
under the working directory. ``--device`` defaults to ``cuda`` and fails
when no GPU is visible; ``--device cpu`` runs the kernels' plain versions.
The 256x512 grid (131,072 cells) is the HBM-edge resident tier's shape: on
the GPU every chunk of the run is one launch of the resident kernel.
"""

import argparse
import sys

import torch

from tpulbm_torch import LBMParams, Simulation
from tpulbm_torch.tools.make_deck import box_obstacles


def main(argv=None):
    """Runs the scenario; returns (the run's SimulationResult, the resumed
    Simulation)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device to run on (default cuda; fails if no "
                             "GPU is visible)")
    parser.add_argument("--max-iters", type=int, default=20000,
                        help="steps to run (default 20000)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("Error: --device cuda, but no CUDA device is available "
                 "(torch.cuda.is_available() is false)")

    ny, nx = 256, 512
    params = LBMParams(
        nx=nx, ny=ny, max_iters=args.max_iters, reynolds_dim=10,
        density=0.1, accel=0.005, omega=1.7,
    )
    # closed box with a cylinder-ish block in the stream
    mask = box_obstacles(nx=nx, ny=ny,
                         blocks=[(ny // 2 - 16, nx // 4, 32, 32)])

    sim = Simulation(params, mask, device=args.device)
    result = sim.run(
        checkpoint_every=5000,
        checkpoint_dir="out/custom_ckpts",
        metrics_file="out/custom_metrics.jsonl",
    )
    print(f"{params.max_iters} steps in {result.elapsed_s:.2f} s; "
          f"Reynolds {result.reynolds:.3f}")
    sim.write_outputs("out/custom")

    try:
        from tpulbm_torch.viz import load_final_state, plot_speed

        _, _, u, _, _ = load_final_state("out/custom/final_state.dat")
        print(plot_speed(u, "out/custom/final_state.png"))
    except RuntimeError as e:
        print(f"(no plot: {e})")

    # resume demonstration: a fresh Simulation continues from the checkpoint
    resumed = Simulation(params, mask, device=args.device)
    resumed.restore_checkpoint("out/custom_ckpts")
    print(f"resumed at step {resumed.step_count}; "
          f"av_vel so far {resumed.av_vels[resumed.step_count - 1]:.3e}")
    return result, resumed


if __name__ == "__main__":
    main()
