"""tpulbm_torch physics and plain timestep against the JAX package.

Same inputs, made from a seed with numpy, go through the JAX function and its
PyTorch counterpart. Tolerances: XLA on the CPU does not round every float32
op as strict IEEE does (it contracts and reorders some), so the two differ
in the last bits: about 3.7e-9 in f after one step on the 128^2 deck, and
1.27e-7 in f with 3.5e-5 relative in the av series after 200 steps
(measured). The gates below sit a few times above those ceilings.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm.core import physics as jphysics
from tpulbm.core.params import LBMParams as JParams
from tpulbm.core.state import initial_state as j_initial_state
from tpulbm.ops import step_jnp
from tpulbm_torch.core import physics
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.diag import observables
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import step_torch

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _deck(name="128x128"):
    p = read_params(os.path.join(DATA, f"input_{name}.params"))
    mask, n_free = read_obstacles(
        os.path.join(DATA, f"obstacles_{name}.dat"), p.nx, p.ny)
    return p.with_free_cells(n_free), mask


def _jparams(p):
    return JParams(**dataclasses.asdict(p))


def test_params_derived_values_match():
    """The f32 derived values (params.py:25-60) are the JAX package's exactly."""
    p, _ = _deck()
    jp = _jparams(p)
    for name in ("viscosity", "accel_w1", "accel_w2", "accel_row",
                 "free_cells_inv", "total_updates"):
        assert getattr(p, name) == getattr(jp, name), name


def test_initial_state_bitwise():
    p, _ = _deck("128x256")
    f = initial_state(p).numpy()
    assert f.shape == (9, p.ny, p.nx) and p.ny != p.nx
    assert f.dtype == np.float32
    assert np.array_equal(f, np.asarray(j_initial_state(_jparams(p))))


@pytest.mark.parametrize("pair_symmetric", [False, True])
def test_collide_matches_jax(pair_symmetric):
    """Both equilibrium forms on random planes; op-by-op JAX on the CPU
    rounds each op as IEEE does, so 2 ULP of f32 covers it."""
    rng = np.random.RandomState(0)
    base = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, np.float32) * 0.1
    t = (base[:, None, None] * (1 + 0.2 * rng.rand(9, 64, 64))).astype(
        np.float32)
    mask = rng.rand(64, 64) < 0.2
    out_j, sp_j = jphysics.collide(
        [jnp.asarray(x) for x in t], jnp.asarray(mask), 1.85,
        pair_symmetric=pair_symmetric)
    out_t, sp_t = physics.collide(
        [torch.tensor(x) for x in t], torch.tensor(mask), 1.85,
        pair_symmetric=pair_symmetric)
    for k in range(9):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(sp_t.numpy(), np.asarray(sp_j),
                               rtol=2.4e-7, atol=0)
    # bounce-back writes the pulled values of the opposite direction
    assert np.array_equal(out_t[1].numpy()[mask], t[3][mask])


def test_one_step_matches_jax():
    """One lbm_step on the 128^2 deck: measured ceiling 3.7e-9."""
    p, mask = _deck()
    f_j, av_j = step_jnp.lbm_step(
        j_initial_state(_jparams(p)), jnp.asarray(mask), _jparams(p))
    f_t, av_t = step_torch.lbm_step(initial_state(p), torch.tensor(mask), p)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(float(av_t), float(av_j), rtol=1e-5)


def test_run_steps_matches_jax_200():
    """200 steps on the 128^2 deck: f atol 5e-7, av rtol 1e-4 (measured
    1.27e-7 and 3.5e-5)."""
    p, mask = _deck()
    f_j, av_j = step_jnp.run_steps(
        j_initial_state(_jparams(p)), jnp.asarray(mask), _jparams(p), 200)
    f_t, av_t = step_torch.run_steps(initial_state(p), torch.tensor(mask),
                                     p, 200)
    assert av_t.shape == (200,)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=0,
                               atol=5e-7)
    np.testing.assert_allclose(av_t.numpy(), np.asarray(av_j), rtol=1e-4)


def test_mass_conserved():
    """Acceleration moves mass between channels and BGK/bounce-back keep it:
    total density stays put to float32 summation error."""
    p, mask = _deck()
    f0 = initial_state(p)
    f, _ = step_torch.run_steps(f0, torch.tensor(mask), p, 50)
    m0 = float(observables.total_density(f0))
    assert abs(float(observables.total_density(f)) - m0) / m0 < 1e-5


def test_accelerate_guard_is_knife_edge():
    """A free accel-row cell whose f3 would go non-positive is skipped
    (d2q9-bgk.c:457-460); its neighbours are accelerated."""
    p = LBMParams(nx=8, ny=6, max_iters=1, reynolds_dim=1, density=0.1,
                  accel=0.005, omega=1.7).with_free_cells(48)
    f = initial_state(p)
    f[3, p.accel_row, 2] = p.accel_w1  # f3 - w1 == 0: not > 0
    out = step_torch.accelerate(f, torch.zeros(6, 8, dtype=torch.bool), p)
    assert out[1, p.accel_row, 2] == f[1, p.accel_row, 2]
    assert out[1, p.accel_row, 3] == f[1, p.accel_row, 3] + p.accel_w1
    assert torch.equal(out[:, :p.accel_row], f[:, :p.accel_row])
