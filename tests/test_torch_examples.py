"""The port's Python API path on the CPU: the two examples
(``examples/torch_run_reference_deck.py``, ``examples/torch_custom_simulation.py``)
through their ``main`` against the JAX package's ``Simulation`` on the same
deck and steps, the custom example's resume, and the final-state golden gate
of the port's checker (the reference's text goldens and the f64-oracle
``.f64.npz`` goldens, and the function that picks between them).

Tolerances, the tiers of test_torch_sim: the port's plain path and the JAX
jnp path differ by XLA-CPU rounding, f atol 2e-7 and av rtol 1e-4. Within
the port a checkpoint resumes bitwise.
"""

import dataclasses
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import tpulbm
from tpulbm.dist.mesh import get_mesh as j_get_mesh
from tpulbm_torch import cli
from tpulbm_torch.sim import checkpoint as ckpt
from tpulbm_torch.tools.make_deck import box_obstacles
from tpulbm_torch.validation import check

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "goldens"
PF = ROOT / "data" / "input_128x128.params"
OF = ROOT / "data" / "obstacles_128x128.dat"
F_ATOL = 2e-7
AV_RTOL = 1e-4
EXAMPLES = ("torch_run_reference_deck", "torch_custom_simulation")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory as the examples expect one: data/ the
    repository's decks, out/ theirs."""
    (tmp_path / "data").symlink_to(ROOT / "data")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _jax_run(params, mask, n):
    """The JAX package's Simulation (jnp backend, one device), n steps."""
    jp = tpulbm.LBMParams(**dataclasses.asdict(params))
    jsim = tpulbm.Simulation(jp, mask, mesh=j_get_mesh(n_devices=1),
                             backend="jnp")
    return jsim, jsim.run(n_steps=n)


def test_reference_deck_example_matches_jax(workdir):
    """examples/torch_run_reference_deck.py --device cpu --max-iters 40 on
    the 128^2 deck against tpulbm.Simulation: state, av series, Reynolds
    number; its output files hold the run's av series."""
    n = 40
    result = _example("torch_run_reference_deck").main(
        ["--device", "cpu", "--max-iters", str(n)])
    sim = result.sim
    assert sim.backend == "torch" and sim.step_count == n
    assert result.params.max_iters == n
    assert result.params.total_updates == 128 * 128 * n
    jsim, jres = _jax_run(sim.params, sim.obstacles.numpy(), n)
    np.testing.assert_allclose(result.f.numpy(), np.asarray(jsim.f),
                               rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(result.av_vels, jres.av_vels, rtol=AV_RTOL)
    assert abs(result.reynolds - jres.reynolds) / abs(jres.reynolds) < AV_RTOL
    out = workdir / "out" / "128x128"
    written = np.loadtxt(out / "av_vels.dat", usecols=[1])
    np.testing.assert_allclose(written, result.av_vels, rtol=1e-11)
    assert len((out / "final_state.dat").read_text().splitlines()) == 128**2


def test_custom_example_matches_jax(workdir):
    """examples/torch_custom_simulation.py --device cpu --max-iters 40 (the
    256x512 box with its 32x32 block) against tpulbm.Simulation on the same
    mask and parameters: state, av series; the checkpoint and the metrics
    line of its one runner call."""
    n = 40
    result, _ = _example("torch_custom_simulation").main(
        ["--device", "cpu", "--max-iters", str(n)])
    sim = result.sim
    mask = box_obstacles(nx=512, ny=256, blocks=[(112, 128, 32, 32)])
    assert np.array_equal(sim.obstacles.numpy(), mask)
    assert (sim.params.nx, sim.params.ny, sim.params.omega,
            sim.params.accel) == (512, 256, 1.7, 0.005)
    jsim, jres = _jax_run(sim.params, mask, n)
    np.testing.assert_allclose(result.f.numpy(), np.asarray(jsim.f),
                               rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(result.av_vels, jres.av_vels, rtol=AV_RTOL)
    assert abs(result.reynolds - jres.reynolds) / abs(jres.reynolds) < AV_RTOL
    out = workdir / "out"
    assert os.listdir(out / "custom_ckpts") == [f"ckpt_{n:08d}.npz"]
    assert len((out / "custom_metrics.jsonl").read_text().splitlines()) == 1
    assert (out / "custom" / "final_state.dat").exists()


def test_custom_example_resume_is_the_same_bytes(workdir):
    """The custom example's resumed Simulation holds the uninterrupted
    run's state and av series, bitwise, as does its checkpoint file."""
    n = 24
    result, resumed = _example("torch_custom_simulation").main(
        ["--device", "cpu", "--max-iters", str(n)])
    sim = result.sim
    assert resumed.step_count == sim.step_count == n
    assert torch.equal(resumed.f, sim.f)
    assert resumed.av_vels[:n].tobytes() == sim.av_vels[:n].tobytes()
    step, f, av = ckpt.restore(workdir / "out" / "custom_ckpts", sim.params)
    assert step == n and av.tobytes() == sim.av_vels[:n].tobytes()
    assert np.array_equal(f, sim.f.numpy())


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_refuses_cuda_without_a_gpu(name, workdir, monkeypatch,
                                            capsys):
    """Without --device cpu an example needs a GPU: where none is visible it
    exits 1 with the CLI's message and runs nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        _example(name).main([])
    assert "no CUDA device is available" in str(exc.value.code)
    assert not (workdir / "out").exists()


@pytest.mark.parametrize("deck, golden", [
    ("128x128", "128x128.final_state.dat"),
    ("128x256", "128x256.final_state.dat"),
    ("256x256", "256x256.final_state.f64.npz"),
    ("1024x1024", "1024x1024.final_state.f64.npz"),
    ("2048x2048", None),
])
def test_final_state_golden_picks_as_make_check(deck, golden):
    """The reference's text golden where it exists, else the f64-oracle
    golden, else none (av_vels alone is gated)."""
    got = check.final_state_golden(GOLDEN, deck)
    assert got == (None if golden is None else os.path.join(GOLDEN, golden))


def test_final_state_golden_prefers_the_text_golden(tmp_path):
    """Where a deck has both goldens the text one is taken, as make check
    takes it; the npz alone is taken where it is the only one."""
    (tmp_path / "d.final_state.f64.npz").touch()
    assert check.final_state_golden(tmp_path, "d") == str(
        tmp_path / "d.final_state.f64.npz")
    (tmp_path / "d.final_state.dat").touch()
    assert check.final_state_golden(tmp_path, "d") == str(
        tmp_path / "d.final_state.dat")


def test_checker_npz_golden(tmp_path):
    """The port's checker gates a final state against an .f64.npz pressure
    golden as against the reference's text format: a 5-step run passes
    against its own pressure, a 5 % perturbation of one cell fails (the
    counterpart of test_sim.test_checker_npz_golden)."""
    out = tmp_path / "o"
    assert cli.main([str(PF), str(OF), "--max-iters", "5", "--device", "cpu",
                     "--out-dir", str(out)]) == 0
    fs, av = str(out / "final_state.dat"), str(out / "av_vels.dat")
    pressure = np.loadtxt(fs, usecols=[5]).reshape(128, 128)
    ref = tmp_path / "golden.f64.npz"
    np.savez_compressed(ref, pressure=pressure.astype(np.float32))
    assert check.main([
        "--ref-av-vels-file", av, "--ref-final-state-file", str(ref),
        "--av-vels-file", av, "--final-state-file", fs,
    ]) == 0
    bad = tmp_path / "bad.f64.npz"
    pressure[3, 7] *= 1.05
    np.savez_compressed(bad, pressure=pressure.astype(np.float32))
    assert check.main([
        "--ref-av-vels-file", av, "--ref-final-state-file", str(bad),
        "--av-vels-file", av, "--final-state-file", fs,
    ]) == 1
