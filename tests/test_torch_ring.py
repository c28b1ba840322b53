"""The 1-D ring of tpulbm_torch (``dist.mesh``, ``dist.sharding``, the ring
runners of ``dist.runner``, ``kstep_tile.ring_chunk``) against the JAX
package's ring on the 8-device virtual CPU mesh of conftest.py.

The port's shards lie on the CPU here, so ``ring_chunk`` takes its plain
version (K4 ring mode runs only on the card; ``chip_smoke.py`` holds it
against the same plain version there). The ``torch`` backend steps each
shard with the canonical equilibrium, as the JAX ``jnp`` backend does; the
kernel path and the Pallas kernels use the pair-symmetric form. Every input
comes from a deck, or from a numpy seed for a perturbed state, and goes to
both packages.

Tolerances, the tiers of test_torch_physics and test_torch_wide for the same
step counts: after 200 steps f atol 5e-7 and av rtol 1e-4 (XLA-CPU rounding
against strict float32); up to 19 steps f atol 1e-7 and av rtol 1e-4. The
ring's av series sums each shard's sums once after the loop, in another
order than the JAX package's psum of scaled shard sums, which stays inside
the same tiers. Against the port's own single-device plain route the ring's
state is bitwise equal (the same cell arithmetic per row).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm import cli as jcli
from tpulbm.core.params import LBMParams as JParams
from tpulbm.dist import sharding as jsharding
from tpulbm.dist.mesh import get_mesh as j_get_mesh
from tpulbm.dist.runner import _make_xpad_runner as j_make_xpad_runner
from tpulbm.dist.runner import make_runner as j_make_runner
from tpulbm_torch import cli
from tpulbm_torch.core import physics
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner, sharding
from tpulbm_torch.dist.mesh import get_mesh
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import kstep_tile, step_torch
from tpulbm_torch.sim.simulation import Simulation
from tpulbm_torch.validation import check

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "data"


def _deck(name="128x128"):
    p = read_params(DATA / f"input_{name}.params")
    mask, n_free = read_obstacles(DATA / f"obstacles_{name}.dat", p.nx, p.ny)
    return p.with_free_cells(n_free), mask


def _jp(p):
    return JParams(**dataclasses.asdict(p))


def _perturbed(p, seed):
    rng = np.random.RandomState(seed)
    return (initial_state(p).numpy()
            * (1 + 0.01 * rng.rand(9, p.ny, p.nx))).astype(np.float32)


def _ring(p, mask, f0, n_steps, n_shards, chunk_fn=None):
    """The port's ring on CPU shards: (gathered f, av series) as numpy.
    chunk_fn None: make_runner's torch backend; else make_ring_runner."""
    mesh = get_mesh(n_shards, device="cpu")
    if chunk_fn is None:
        run = runner.make_runner(p, n_steps, "auto", "cpu", mesh=mesh)
    else:
        run = runner.make_ring_runner(p, n_steps, mesh, chunk_fn)
    shards, obst = sharding.shard_rows(torch.tensor(f0), torch.tensor(mask),
                                       mesh)
    shards, av = run(shards, obst)
    assert [s.shape[1] for s in shards] == sharding.decompose_rows(
        p.ny, n_shards)[0]
    return sharding.gather_rows(shards, "cpu").numpy(), av.numpy()


def _jax_ring(p, mask, f0, n_steps, n_dev, backend):
    run = j_make_runner(_jp(p), n_steps, j_get_mesh(n_devices=n_dev),
                        backend=backend)
    f, av = run(jnp.asarray(f0), jnp.asarray(mask))
    return np.asarray(f), np.asarray(av)


def _close(got, want, f_atol):
    (f, av), (f_ref, av_ref) = got, want
    assert f.shape == f_ref.shape and av.shape == av_ref.shape
    np.testing.assert_allclose(f, f_ref, rtol=0, atol=f_atol)
    np.testing.assert_allclose(av, av_ref, rtol=1e-4)


@pytest.mark.parametrize("ny,n", [(ny, n) for ny in (1, 2, 5, 7, 16, 100,
                                                     128, 1000, 1024, 1025)
                                  for n in (1, 2, 3, 4, 7, 8)])
def test_split_policies_match_jax(ny, n):
    """decompose_rows is the JAX package's; ring_rows returns it, or refuses
    a split with an empty shard."""
    want = jsharding.decompose_rows(ny, n)
    assert sharding.decompose_rows(ny, n) == want
    if min(want[0]) >= 1:
        assert sharding.ring_rows(ny, n) == want
    else:
        with pytest.raises(ValueError):
            sharding.ring_rows(ny, n)


def test_shard_rows_round_trip_and_mesh():
    """shard_rows follows decompose_rows (1024 over 3: 342/341/341);
    gather_rows puts the rows back; get_mesh on the CPU defaults to one
    shard, and a ring refuses an empty shard."""
    assert get_mesh(device="cpu") == [torch.device("cpu")]
    mesh = get_mesh(3, device="cpu")
    assert mesh == [torch.device("cpu")] * 3
    f = torch.arange(9 * 1024 * 4, dtype=torch.float32).reshape(9, 1024, 4)
    obst = torch.rand(1024, 4) < 0.5
    fs, obs = sharding.shard_rows(f, obst, mesh)
    assert [s.shape[1] for s in fs] == [342, 341, 341]
    assert all(s.is_contiguous() for s in fs + obs)
    assert torch.equal(sharding.gather_rows(fs, "cpu"), f)
    assert torch.equal(sharding.gather_rows(obs, "cpu"), obst)
    with pytest.raises(ValueError):
        get_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        sharding.ring_rows(4, 8)


@pytest.mark.parametrize("k,off,h", [(8, 60, 40), (3, 0, 17), (8, 90, 10),
                                      (5, 33, 33)])
def test_ring_chunk_ref_matches_band_chunk_ref(k, off, h):
    """The plain ring chunk (a band that shrinks a row per side and step)
    against the plain band chunk (a band that wraps inside itself) on the
    same rows: state and sums bitwise. The bands at off 60 and 90 hold the
    accelerated row ny-2 = 94 and the seam. Both take each step's sum
    through kstep_tile.rows_sum, on a fresh contiguous copy of the same
    rows, so the compared sums are one reduction of the same values; the
    assertion names which of the two outputs differs."""
    p = LBMParams(nx=56, ny=96, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    rng = np.random.RandomState(k + off)
    mask = rng.rand(p.ny, p.nx) < 0.1
    p = p.with_free_cells(p.ny * p.nx - int(mask.sum()))
    f0 = torch.tensor(_perturbed(p, off))
    rows = torch.arange(off - k, off + h + k) % p.ny
    band = f0[:, rows].contiguous()
    ob = torch.tensor(mask, dtype=torch.float32)[rows].contiguous()
    base = (off - k) % p.ny
    f, s = kstep_tile.ring_chunk(band[:, :k], band[:, k:k + h],
                                 band[:, k + h:], ob, p, k, base)
    f_b, s_b = kstep_tile.band_chunk_ref(band, ob, p, k, base)
    assert f.shape == (9, h, p.nx) and s.shape == (k,)
    assert torch.equal(f, f_b), (
        f"state: {int((f != f_b).sum())} values differ, max "
        f"{(f - f_b).abs().max().item():.3e}")
    assert torch.equal(s, s_b), f"sums: {s.tolist()} vs {s_b.tolist()}"


def test_ring_chunk_one_step_is_a_step_with_halos():
    """k = 1 (the function of pallas_step._kernel: one step of a row block
    with 1-row halos) against one whole-grid plain step, on the shard that
    holds the accelerated row and on the one after it."""
    p, mask = _deck()
    f0 = torch.tensor(_perturbed(p, 5))
    obst = torch.tensor(mask)
    f1, s1 = step_torch.run_sums(f0, obst, p, 1, pair_symmetric=True)
    assert p.accel_row == 126
    for off, h in ((96, 31), (127, 1)):
        rows = torch.arange(off - 1, off + h + 1) % p.ny
        f, s = kstep_tile.ring_chunk_ref(
            f0[:, rows[:1]], f0[:, rows[1:-1]], f0[:, rows[-1:]],
            obst[rows].float(), p, 1, (off - 1) % p.ny)
        assert torch.equal(f, f1[:, off:off + h])
        _, speed = physics.collide(
            step_torch.pull(step_torch.accelerate(f0, obst, p)), obst,
            p.omega, True)
        assert torch.equal(s[0], kstep_tile.rows_sum(speed, off, h))


@pytest.mark.parametrize("n_shards,n_steps", [(2, 200), (4, 200), (8, 200),
                                              (4, 19), (8, 19)])
def test_ring_matches_jax_jnp_ring(n_shards, n_steps):
    """The torch backend's ring on the 128^2 deck against the JAX jnp ring
    (ppermute halos, deferred psum), from the rest state; 19 steps end in a
    3-step remainder chunk."""
    p, mask = _deck()
    f0 = initial_state(p).numpy()
    tol = 5e-7 if n_steps > 19 else 1e-7
    _close(_ring(p, mask, f0, n_steps, n_shards),
           _jax_ring(p, mask, f0, n_steps, n_shards, "jnp"), tol)


@pytest.mark.parametrize("n_shards", [3, 5, 6, 7])
def test_uneven_ring_matches_jax_padded_runner(n_shards):
    """128 rows over 3, 5, 6 and 7 shards (43/43/42 ... 19 x 2 and 18 x
    5), no padding, against the JAX package's padded runner
    (``_make_padded_runner``, tpulbm/dist/runner.py:1101: dead rows to 129,
    130, 132, 133), 50 steps of a perturbed state."""
    p, mask = _deck()
    f0 = _perturbed(p, 11)
    assert p.ny % n_shards != 0
    _close(_ring(p, mask, f0, 50, n_shards),
           _jax_ring(p, mask, f0, 50, n_shards, "jnp"), 1e-7)


def test_ring_at_unaligned_nx_matches_jax_xpad_runner():
    """nx = 130 over 2 shards, 13 steps (an 8-step chunk and a 5-step one)
    of a perturbed state: the kernel path's ring (ring_chunk, plain on the
    CPU) runs the columns as they are; the JAX package pads them to 256
    with mirror copies (``_make_xpad_runner``, tpulbm/dist/runner.py:1453,
    Pallas in interpret mode)."""
    p = LBMParams(nx=130, ny=128, max_iters=13, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    mask = np.random.RandomState(5).rand(128, 130) < 0.12
    p = p.with_free_cells(p.ny * p.nx - int(mask.sum()))
    f0 = _perturbed(p, 15)
    run = j_make_xpad_runner(_jp(p), 13, j_get_mesh(n_devices=2))
    assert run is not None
    f_j, av_j = run(jnp.asarray(f0), jnp.asarray(mask))
    _close(_ring(p, mask, f0, 13, 2, kstep_tile.ring_chunk),
           (np.asarray(f_j), np.asarray(av_j)), 1e-7)


@pytest.mark.parametrize("n_steps", [16, 13])
def test_kernel_ring_matches_jax_pallas_ring(n_steps):
    """The kernel path's ring (ring_chunk per shard, plain on the CPU)
    against the JAX pallas ring in interpret mode: 128^2, 4 shards, 16
    steps of a perturbed state, and 13 (an 8-step chunk and a 5-step
    remainder)."""
    p, mask = _deck()
    f0 = _perturbed(p, 12)
    _close(_ring(p, mask, f0, n_steps, 4, kstep_tile.ring_chunk),
           _jax_ring(p, mask, f0, n_steps, 4, "pallas"), 1e-7)


def test_p2p_ring_matches_jax_pallas_rdma():
    """The ring that cuda-p2p runs (make_p2p_runner: p2p_chunks, the plain
    version of K6 on CPU shards, the slabs handed through landing slots)
    against --backend pallas-rdma (in-kernel slab exchange, interior blocks
    first) in interpret mode: 2 shards, 16 steps."""
    p, mask = _deck()
    f0 = _perturbed(p, 13)
    mesh = get_mesh(2, device="cpu")
    run = runner.make_p2p_runner(p, 16, mesh)
    shards, obst = sharding.shard_rows(torch.tensor(f0), torch.tensor(mask),
                                       mesh)
    shards, av = run(shards, obst)
    _close((sharding.gather_rows(shards, "cpu").numpy(), av.numpy()),
           _jax_ring(p, mask, f0, 16, 2, "pallas-rdma"), 1e-7)


@pytest.mark.parametrize("n_shards", [3, 5])
def test_ring_state_equals_the_single_device_route(n_shards):
    """The ring's state is bitwise the single-device plan's (K4 chunks,
    plain on the CPU) over 21 steps (two 8-step chunks and a 5-step one),
    uneven splits included; the av series agrees to float32 rounding."""
    p, mask = _deck("128x256")
    f0 = _perturbed(p, 14)
    f, av = _ring(p, mask, f0, 21, n_shards, kstep_tile.ring_chunk)
    plan = runner._chunks(kstep_tile.tile_chunk, 8, 21)
    f1, av1 = runner.run_plan(plan, torch.tensor(f0),
                              torch.tensor(mask, dtype=torch.float32), p)
    assert np.array_equal(f, f1.numpy())
    np.testing.assert_allclose(av, av1.numpy(), rtol=1e-6)


def test_simulation_on_a_ring_matches_one_device():
    """Simulation with a mesh of 4 CPU shards, run in chunks of 24 steps
    (runners of 24 and 16 steps), against the single-device Simulation:
    state bitwise, av series and Reynolds number to float32 rounding."""
    pf, of = DATA / "input_128x128.params", DATA / "obstacles_128x128.dat"
    ring = Simulation.from_files(pf, of, device="cpu",
                                 mesh=get_mesh(4, device="cpu"))
    one = Simulation.from_files(pf, of, device="cpu")
    assert len(ring.shards) == 4 and ring.backend == "torch"
    res, res1 = ring.run(n_steps=64, chunk=24), one.run(n_steps=64, chunk=24)
    assert torch.equal(ring.f, one.f) and torch.equal(res.f, one.f)
    np.testing.assert_allclose(res.av_vels, res1.av_vels, rtol=1e-6)
    assert abs(res.reynolds - res1.reynolds) <= 1e-6 * abs(res1.reynolds)


def test_cli_ring_matches_jax_cli(tmp_path):
    """python -m tpulbm_torch --device cpu --device-count 4 against python
    -m tpulbm --backend jnp --device-count 4 (virtual CPU mesh), 200 steps:
    the port's outputs through validation.check against the JAX package's,
    and the av series at the 200-step tier."""
    pf, of = DATA / "input_128x128.params", DATA / "obstacles_128x128.dat"
    ours, theirs = tmp_path / "torch", tmp_path / "jax"
    assert cli.main([str(pf), str(of), "--device", "cpu", "--device-count",
                     "4", "--max-iters", "200", "--out-dir", str(ours)]) == 0
    assert jcli.main([str(pf), str(of), "--backend", "jnp", "--device-count",
                      "4", "--max-iters", "200", "--out-dir",
                      str(theirs)]) == 0
    assert check.main([
        "--ref-av-vels-file", str(theirs / "av_vels.dat"),
        "--ref-final-state-file", str(theirs / "final_state.dat"),
        "--av-vels-file", str(ours / "av_vels.dat"),
        "--final-state-file", str(ours / "final_state.dat")]) == 0
    av = np.loadtxt(ours / "av_vels.dat", usecols=[1])
    av_j = np.loadtxt(theirs / "av_vels.dat", usecols=[1])
    assert av.shape == (200,)
    np.testing.assert_allclose(av, av_j, rtol=1e-4)


def test_p2p_on_one_shard_warns_as_the_jax_package(capsys):
    """cuda-p2p on a one-device mesh prints the JAX package's fallback
    warning (runner.py:1709-1719) and takes the single-device cuda route,
    which on the CPU refuses as the cuda backend does."""
    p, _ = _deck()
    with pytest.raises(ValueError, match="needs a CUDA device"):
        runner.make_runner(p, 10, "cuda-p2p", "cpu",
                           mesh=get_mesh(1, device="cpu"))
    assert "falling back" in capsys.readouterr().err


def test_ring_runner_refuses_wrong_shards():
    p, mask = _deck()
    mesh = get_mesh(2, device="cpu")
    run = runner.make_runner(p, 8, "torch", "cpu", mesh=mesh)
    fs, obs = sharding.shard_rows(initial_state(p), torch.tensor(mask),
                                  get_mesh(4, device="cpu"))
    with pytest.raises(ValueError):
        run(fs[:2], obs[:2])
    with pytest.raises(ValueError):
        run(fs, obs)
