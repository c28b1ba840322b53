"""Results checker — Python 3 re-implementation of the reference's golden
regression gate (check/check.py in the reference repo). A numpy-only copy of
``tpulbm.validation.check``, so a host without jax can gate the port.

Same semantics and CLI flags: compares the full av_vels series (column 1) and
the final-state *pressure* field (columns 0,1,5 of final_state.dat = x, y,
pressure; check/check.py:62-68), requires identical coordinates and step
counts (:75-82), and passes iff the max per-element percent difference is
within --tolerance (default 1%; :26-31,134-146). Exit code 0/1.

Usage:
    python -m tpulbm_torch.validation.check \
        --ref-av-vels-file REF.av_vels.dat \
        --ref-final-state-file REF.final_state.dat \
        --av-vels-file av_vels.dat --final-state-file final_state.dat
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


@dataclasses.dataclass
class Diffs:
    max_diff_step: int
    max_diff: float
    max_diff_pcnt: float
    sim_val: float
    ref_val: float
    total: float

    def failed(self, tolerance: float) -> bool:
        return (not np.isfinite(self.max_diff_pcnt)) or (
            abs(self.max_diff_pcnt) > tolerance
        )


def _load_final_state(final_state_path: str) -> np.ndarray:
    """(n_cells, 3) array of x, y, pressure — from the reference text
    format, or from a framework-generated f64-oracle golden (.npz with a
    ``pressure`` plane; scripts/make_f64_goldens.py) for the decks whose
    final_state golden is stripped upstream."""
    if str(final_state_path).endswith(".npz"):
        with np.load(final_state_path) as z:
            p = z["pressure"]
        ny, nx = p.shape
        xs = np.tile(np.arange(nx), ny)
        ys = np.repeat(np.arange(ny), nx)
        return np.column_stack([xs, ys, p.ravel()]).astype(np.float64)
    return np.loadtxt(final_state_path, usecols=[0, 1, 5])


def final_state_golden(golden_dir, deck: str):
    """The final-state golden of ``deck`` in ``golden_dir``, picked as the
    JAX package's ``make check`` picks it (Makefile:36-60): the reference's
    ``{deck}.final_state.dat``, else the f64-oracle pressure golden
    ``{deck}.final_state.f64.npz`` (for the decks whose text golden is
    stripped upstream), else None, where av_vels alone is gated."""
    for name in (f"{deck}.final_state.dat", f"{deck}.final_state.f64.npz"):
        path = os.path.join(golden_dir, name)
        if os.path.exists(path):
            return path
    return None


def _load(av_vels_path: str, final_state_path: str):
    av_vels = np.loadtxt(av_vels_path, usecols=[1])
    return av_vels, _load_final_state(final_state_path)


def _diff_values(ref_vals: np.ndarray, sim_vals: np.ndarray) -> Diffs:
    diff = ref_vals - sim_vals
    with np.errstate(divide="ignore", invalid="ignore"):
        diff_pcnt = 100.0 * (diff / (ref_vals - diff))
    i = int(np.argmax(np.abs(diff_pcnt)))
    return Diffs(
        max_diff_step=i,
        max_diff=float(diff[i]),
        max_diff_pcnt=float(diff_pcnt[i]),
        sim_val=float(sim_vals[i]),
        ref_val=float(ref_vals[i]),
        total=float(np.sum(np.abs(diff))),
    )


def check_results(
    ref_av_vels: str,
    ref_final_state: str,
    av_vels: str,
    final_state: str,
    tolerance: float = 1.0,
    verbose: bool = True,
):
    """Returns (passed: bool, av_diffs: Diffs, fs_diffs: Diffs)."""
    av_ref, fs_ref = _load(ref_av_vels, ref_final_state)
    av_sim, fs_sim = _load(av_vels, final_state)

    if np.any(fs_ref[:, 0:2] != fs_sim[:, 0:2]):
        raise ValueError("Final state files coordinates were not the same")
    if av_ref.size != av_sim.size:
        raise ValueError("Different number of steps in av_vels files")

    av = _diff_values(av_ref, av_sim)
    fs = _diff_values(fs_ref[:, 2], fs_sim[:, 2])

    if verbose:
        print(f"Total difference in av_vels : {av.total:.12E}")
        print(
            f"Biggest difference (at step {av.max_diff_step:d}) : {av.max_diff:.12E}"
        )
        print(
            f"  {av.sim_val:.12E} vs. {av.ref_val:.12E} = {av.max_diff_pcnt:.2g}%"
        )
        print()
        jj = int(fs_sim[fs.max_diff_step, 0])
        ii = int(fs_sim[fs.max_diff_step, 1])
        print(f"Total difference in final_state : {fs.total:.12E}")
        print(f"Biggest difference (at coord ({jj:d},{ii:d})) : {fs.max_diff:.12E}")
        print(
            f"  {fs.sim_val:.12E} vs. {fs.ref_val:.12E} = {fs.max_diff_pcnt:.2g}%"
        )
        print()

    av_failed = av.failed(tolerance)
    fs_failed = fs.failed(tolerance)
    if verbose:
        if fs_failed:
            print("final state failed check")
        if av_failed:
            print("av_vels failed check")
        if not (av_failed or fs_failed):
            print("Both tests passed!")
    return not (av_failed or fs_failed), av, fs


def check_av_vels(
    ref_av_vels: str,
    av_vels: str,
    tolerance: float = 1.0,
    verbose: bool = True,
):
    """av_vels-only gate for decks whose final_state golden is stripped
    upstream (reference .MISSING_LARGE_BLOBS). Returns (passed, av_diffs)."""
    av_ref = np.loadtxt(ref_av_vels, usecols=[1])
    av_sim = np.loadtxt(av_vels, usecols=[1])
    if av_ref.size != av_sim.size:
        raise ValueError("Different number of steps in av_vels files")
    av = _diff_values(av_ref, av_sim)
    av_failed = av.failed(tolerance)
    if verbose:
        print(f"Total difference in av_vels : {av.total:.12E}")
        print(
            f"Biggest difference (at step {av.max_diff_step:d}) : {av.max_diff:.12E}"
        )
        print(
            f"  {av.sim_val:.12E} vs. {av.ref_val:.12E} = {av.max_diff_pcnt:.2g}%"
        )
        print()
        print("av_vels failed check" if av_failed else "av_vels test passed!")
    return not av_failed, av


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Golden-results checker for tpulbm (reference-compatible)",
        fromfile_prefix_chars="@",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--tolerance", nargs=1, default=[1], type=float)
    parser.add_argument("--ref-av-vels-file", nargs=1, required=True)
    parser.add_argument("--ref-final-state-file", nargs=1)
    parser.add_argument("--av-vels-file", nargs=1, required=True)
    parser.add_argument("--final-state-file", nargs=1)
    parser.add_argument(
        "--av-vels-only", action="store_true",
        help="gate on the av_vels series only (for decks whose final_state "
        "golden is stripped upstream)",
    )
    args = parser.parse_args(argv)
    try:
        if args.av_vels_only:
            passed, _ = check_av_vels(
                args.ref_av_vels_file[0],
                args.av_vels_file[0],
                tolerance=args.tolerance[0],
            )
        else:
            if not (args.ref_final_state_file and args.final_state_file):
                parser.error(
                    "--ref-final-state-file/--final-state-file required "
                    "unless --av-vels-only"
                )
            passed, _, _ = check_results(
                args.ref_av_vels_file[0],
                args.ref_final_state_file[0],
                args.av_vels_file[0],
                args.final_state_file[0],
                tolerance=args.tolerance[0],
            )
    except ValueError as e:
        print(str(e))
        return 1
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
