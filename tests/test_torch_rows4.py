"""The deployment of the benchmark's ``solve-1024-rows4`` cell at a test's
size on the CPU: the cuda-p2p ring over four row shards, whose plain
version ``dist.runner.make_p2p_runner`` runs on CPU shards
(``ring_p2p.p2p_chunks_ref``: the landing slots chosen by the epoch's
parity, pull0 on a call's first launch, the epoch carried across calls,
the sums added by ``_deferred_sum``), against the benchmark's plain
reference (``benchmark/lbmbench/reference.py``, imported by path: it
imports nothing of the program). Imports no JAX.

A 64 x 64 deck with a box obstacle and a wall row; three runner calls of
40, 37 (a 5-step remainder) and 40 steps, in launches of at most 2
chunks; (omega, accel) drawn from the seed as the benchmark draws them.

Tolerances: both sides compute in float32, in another order (the
reference pulls the whole grid and relaxes with ``torch.lerp``; the
program steps 8-step chunks of each shard and adds the shards' sums), so
they part by rounding alone: the state by ~4e-6 of its largest
population, the av series by ~3e-5 of its largest value (the first
steps' sums of |u| cancel to ~1e-5 of it, where rounding in another order
shows most), the Reynolds number by ~2e-5 (the reference sums |u| in
float64, the program in float32). The limits leave about five times that.
The reference in bfloat16 in the program's place fails each by more than
a hundred times (``test_the_reference_in_bfloat16_fails_each_limit``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.diag.observables import calc_reynolds
from tpulbm_torch.dist import runner, sharding
from tpulbm_torch.dist.mesh import get_mesh
from tpulbm_torch.ops import ring_p2p

ROOT = Path(__file__).resolve().parent.parent
N, SHARDS, CALLS = 64, 4, (40, 37, 40)
LIMITS = {"state_rel": 2e-5, "av_rel": 2e-4, "re_rel": 1e-4}


def _reference_module():
    path = ROOT / "benchmark" / "lbmbench" / "reference.py"
    spec = importlib.util.spec_from_file_location("lbmbench_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


Reference = _reference_module().Reference


def _deck():
    mask = np.zeros((N, N), dtype=bool)
    mask[20:30, 12:22] = True
    mask[0] = True
    return mask


def _draw(seed: int):
    """(omega, accel) as float32 values, as benchmark/lbmbench/spec.py's
    ``draw``: omega uniform in [1.80, 1.90], accel 0.005 times a factor
    uniform in [0.8, 1.2]."""
    rng = np.random.default_rng([seed, 0])
    omega = float(np.float32(rng.uniform(1.80, 1.90)))
    accel = float(np.float32(0.005 * rng.uniform(0.8, 1.2)))
    return omega, accel


def _program(mask, omega, accel):
    """The p2p ring over four CPU shards from rest, three calls: (the
    gathered state, the av series, the Reynolds number)."""
    p = LBMParams(nx=N, ny=N, max_iters=sum(CALLS), reynolds_dim=10,
                  density=0.1, accel=accel, omega=omega).with_free_cells(
                      int(mask.size - mask.sum()))
    mesh = get_mesh(SHARDS, device="cpu")
    runners = {n: runner.make_p2p_runner(p, n, mesh, max_outer=2)
               for n in set(CALLS)}
    rest = Reference(mask, 0.1, 10, [omega], [accel]).initial()[0]
    shards, obst = sharding.shard_rows(rest.clone(), torch.tensor(mask),
                                       mesh)
    avs = []
    for n in CALLS:
        shards, av = runners[n](shards, obst)
        avs.append(av)
    f = sharding.gather_rows(shards, "cpu")
    return (f.double().numpy(), torch.cat(avs).double().numpy(),
            float(calc_reynolds(f, torch.tensor(mask), p)))


def _reference(mask, omega, accel, dtype=torch.float32):
    """The plain reference from rest in ``dtype``, as ``_program``'s
    triple."""
    ref = Reference(mask, 0.1, 10, [omega], [accel], dtype=dtype)
    f, av = ref.run(ref.initial(), sum(CALLS))
    return f[0].double().numpy(), av[0], ref.reynolds(f)[0]


def _gaps(got, want):
    (f, av, re), (f_ref, av_ref, re_ref) = got, want
    return {"state_rel": np.abs(f - f_ref).max() / np.abs(f_ref).max(),
            "av_rel": np.abs(av - av_ref).max() / np.abs(av_ref).max(),
            "re_rel": abs(re - re_ref) / abs(re_ref)}


@pytest.mark.parametrize("seed", [3, 2026, 3100000001])
def test_p2p_ring_of_four_rows_matches_the_plain_reference(seed):
    mask = _deck()
    omega, accel = _draw(seed)
    ring_p2p.reset_waits()
    got = _program(mask, omega, accel)
    assert got[1].shape == (sum(CALLS),)
    gaps = _gaps(got, _reference(mask, omega, accel))
    for name, limit in LIMITS.items():
        assert gaps[name] <= limit, (name, gaps[name])
    # no K6 ran: the wait counters count nothing on the CPU
    assert ring_p2p.WAITS == {}


def test_the_reference_in_bfloat16_fails_each_limit():
    """The control: the reference in bfloat16, the precision below the
    deck's float32, in the program's place."""
    mask = _deck()
    omega, accel = _draw(3)
    gaps = _gaps(_reference(mask, omega, accel, torch.bfloat16),
                 _reference(mask, omega, accel))
    for name, limit in LIMITS.items():
        assert gaps[name] > 100 * limit, (name, gaps[name])
