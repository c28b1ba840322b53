"""A closed-box deck outside the resident gate, as the benchmark's
``solve-8192`` cell runs the 8192^2 deck, at a test's size on the CPU,
against the benchmark's plain reference (``benchmark/lbmbench/reference.py``,
imported by path: it imports nothing of the program). Imports no JAX.

A 384 x 384 deck of ``tools.make_deck``'s geometry (the four walls
blocked, as every shipped deck), 147,456 cells, past the gate's 135K
(``dist.runner.resident_route`` false): on a card it runs on K6's grid
kind. 200 steps from rest, (omega, accel) drawn from the seed as the
benchmark draws them for the 8192^2 deck (accel 0.01 times a factor in
[0.8, 1.2]). Two routes of the program:

- ``Simulation`` with backend ``auto`` on the CPU (``settle``, ``run`` in
  calls of 64 steps), the plain step;
- the card's route as its plain version: ``kernel_plan``'s launches of the
  grid kind, whose CPU version is K4's plain chain
  (``ring_p2p.grid_p2p_chunks_ref``), the state whose bits the grid kind
  writes.

Each is held to the reference by ``compare.gap`` (the benchmark's
numbers, ``benchmark/lbmbench/compare.py``). Both sides compute in
float32, in another order, so they part by rounding alone (readings of
seeds 3 and 3100000001: the state 3.8e-6, the av series 3.0e-5, the
Reynolds number 2.7e-5). The limits leave about five times that:

- ``state_rel`` 2e-5: the populations after 200 steps, over the largest;
  the reference pulls the whole grid and relaxes with ``torch.lerp``, the
  program's steps fold the same terms in another order;
- ``av_rel`` 2e-4: the av series over its largest value; the first steps'
  sums of |u| cancel to ~1e-5 of it, where rounding in another order shows
  most;
- ``re_rel`` 1e-4: the reference sums |u| in float64, the program in
  float32.

The reference in bfloat16 in the program's place fails each by more than
a hundred times (``test_the_reference_in_bfloat16_fails_each_limit``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.diag.observables import calc_reynolds
from tpulbm_torch.dist import runner
from tpulbm_torch.ops import ring_p2p
from tpulbm_torch.sim.simulation import Simulation
from tpulbm_torch.tools.make_deck import box_obstacles

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
N, STEPS, CALL = 384, 200, 64
LIMITS = {"state_rel": 2e-5, "av_rel": 2e-4, "re_rel": 1e-4}


def _load(name):
    path = ROOT / "benchmark" / "lbmbench" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"lbmbench_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


Reference = _load("reference").Reference
gap = _load("compare").gap


def _draw(seed: int):
    """(omega, accel) as float32 values, as benchmark/lbmbench/spec.py's
    ``draw`` for the 8192^2 deck: omega uniform in [1.80, 1.90], accel 0.01
    times a factor uniform in [0.8, 1.2]."""
    rng = np.random.default_rng([seed, 0])
    omega = float(np.float32(rng.uniform(1.80, 1.90)))
    accel = float(np.float32(0.01 * rng.uniform(0.8, 1.2)))
    return omega, accel


def _params(mask, omega, accel):
    return LBMParams(nx=N, ny=N, max_iters=STEPS, reynolds_dim=10,
                     density=0.1, accel=accel, omega=omega).with_free_cells(
                         int(mask.size - mask.sum()))


def _simulation(mask, omega, accel):
    """Simulation on the CPU: (state, av series, Reynolds number)."""
    sim = Simulation(_params(mask, omega, accel), mask, backend="auto",
                     device="cpu")
    sim.settle()
    r = sim.run(n_steps=STEPS, chunk=CALL)
    return sim.f, r.av_vels, r.reynolds


def _grid_plan(mask, omega, accel):
    """The card's route at this shape (the grid kind's launches), run as
    its plain version on the CPU: (state, av series, Reynolds number)."""
    p = _params(mask, omega, accel)
    plan = runner.kernel_plan(p, STEPS)
    assert {fn for fn, _, _ in plan} == {ring_p2p.grid_p2p_chunks}
    f, av = runner.run_plan(plan, initial_state(p), torch.tensor(mask).float(),
                            p)
    return f, av.numpy(), float(calc_reynolds(f, torch.tensor(mask), p))


def _reference(mask, omega, accel, dtype=torch.float32):
    """The plain reference from rest in ``dtype``, as the program's
    triple."""
    ref = Reference(mask, 0.1, 10, [omega], [accel], dtype=dtype)
    f, av = ref.run(ref.initial(), STEPS)
    return f[0], av[0], ref.reynolds(f)[0]


def _gaps(got, want):
    (f, av, re), (f_ref, av_ref, re_ref) = got, want
    return {"state_rel": gap(f.double().numpy(), f_ref.double().numpy()),
            "av_rel": gap(av, av_ref),
            "re_rel": abs(re - re_ref) / abs(re_ref)}


def test_the_deck_is_outside_the_resident_gate():
    """The deck runs on the grid kind on a card, not on K2; its mask is
    make_deck's closed box."""
    mask = box_obstacles(N, N)
    assert not runner.resident_route(N, N)
    assert mask[0].all() and mask[-1].all()
    assert mask[:, 0].all() and mask[:, -1].all()
    assert int(mask.sum()) == 4 * N - 4


@pytest.mark.parametrize("route", [_simulation, _grid_plan],
                         ids=["simulation", "grid_plan"])
@pytest.mark.parametrize("seed", [3, 3100000001])
def test_wide_deck_matches_the_plain_reference(route, seed):
    mask = box_obstacles(N, N)
    omega, accel = _draw(seed)
    got = route(mask, omega, accel)
    assert got[1].shape == (STEPS,)
    gaps = _gaps(got, _reference(mask, omega, accel))
    for name, limit in LIMITS.items():
        assert gaps[name] <= limit, (name, gaps[name])


def test_the_reference_in_bfloat16_fails_each_limit():
    """The control: the reference in bfloat16, the precision below the
    deck's float32, in the program's place."""
    mask = box_obstacles(N, N)
    omega, accel = _draw(3)
    gaps = _gaps(_reference(mask, omega, accel, torch.bfloat16),
                 _reference(mask, omega, accel))
    for name, limit in LIMITS.items():
        assert gaps[name] > 100 * limit, (name, gaps[name])
