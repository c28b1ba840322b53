"""The tpulbm_torch slice end to end on the CPU: Simulation, writers, CLI,
the golden prefix, state conversion and the no-jax rule.

Tolerances as test_torch_physics: the port's plain path and the JAX jnp path
differ by XLA-CPU rounding; after 64 steps on the 128^2 deck, measured: f
7.5e-8, av 3.5e-5 and Reynolds 1.6e-5 relative, output fields 6.3e-7
(gates: av and Reynolds rtol 1e-4, fields atol 2e-6). The golden gate is the
reference's 1 %.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpulbm
from tpulbm.diag.observables import output_fields as j_output_fields
from tpulbm.dist.mesh import get_mesh
from tpulbm.io import writers as j_writers
from tpulbm_torch import convert
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.diag.observables import output_fields
from tpulbm_torch.dist.runner import make_runner
from tpulbm_torch.io import native, writers
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.sim.simulation import Simulation
from tpulbm_torch.validation import check

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "data"
GOLDEN = ROOT / "tests" / "goldens"


def _files(deck):
    return DATA / f"input_{deck}.params", DATA / f"obstacles_{deck}.dat"


def test_simulation_matches_jax_simulation():
    """64 steps on the 128^2 deck against tpulbm.Simulation (jnp backend,
    one device): av series, Reynolds number and output fields."""
    n = 64
    pf, of = _files("128x128")
    sim = Simulation.from_files(pf, of, backend="auto", device="cpu")
    assert sim.backend == "torch"
    jsim = tpulbm.Simulation.from_files(
        pf, of, mesh=get_mesh(n_devices=1), backend="jnp")
    res = sim.run(n_steps=n, chunk=24)  # chunks 24 + 24 + 16
    jres = jsim.run(n_steps=n)
    assert res.av_vels.shape == (n,) and sim.step_count == n
    np.testing.assert_allclose(res.av_vels, jres.av_vels, rtol=1e-4)
    assert abs(res.reynolds - jres.reynolds) / abs(jres.reynolds) < 1e-4
    ours = output_fields(sim.f, sim.obstacles, sim.params.density)
    theirs = j_output_fields(jsim.f, jsim.obstacles, jsim.params.density)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6)


def test_writers_give_identical_bytes(tmp_path, monkeypatch):
    """The same numpy arrays through both packages' writers give the same
    bytes, on the port's native path and on its pure-Python path."""
    rng = np.random.RandomState(4)
    fields = [rng.rand(12, 10).astype(np.float32) - 0.5 for _ in range(4)]
    mask = rng.rand(12, 10) < 0.3
    av = (rng.rand(37) * 1e-3).astype(np.float32)
    p = read_params(_files("128x128")[0])
    jp = tpulbm.LBMParams(**dataclasses.asdict(p))
    j_writers.write_final_state(tmp_path / "j_fs", None, mask, jp,
                                fields=fields)
    j_writers.write_av_vels(tmp_path / "j_av", av)
    ref_fs = (tmp_path / "j_fs").read_bytes()
    ref_av = (tmp_path / "j_av").read_bytes()
    for native_on in (True, False):
        if not native_on:
            monkeypatch.setattr(native, "available", lambda: False)
        writers.write_final_state(tmp_path / "fs", None, mask, p,
                                  fields=fields)
        writers.write_av_vels(tmp_path / "av", av)
        assert (tmp_path / "fs").read_bytes() == ref_fs, native_on
        assert (tmp_path / "av").read_bytes() == ref_av, native_on


def test_cli_runs_on_cpu(tmp_path):
    pf, of = _files("128x128")
    res = subprocess.run(
        [sys.executable, "-m", "tpulbm_torch", str(pf), str(of),
         "--device", "cpu", "--max-iters", "16", "--out-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "==done=="
    assert lines[1].startswith("Reynolds number:\t\t")
    assert lines[2].startswith("Elapsed time:\t\t\t")
    assert lines[3].startswith("Elapsed user CPU time:\t\t")
    assert lines[4].startswith("Elapsed system CPU time:\t")
    av = np.loadtxt(tmp_path / "av_vels.dat", usecols=[1])
    assert av.shape == (16,) and np.all(av > 0)
    assert len((tmp_path / "final_state.dat").read_text().splitlines()) == (
        128 * 128)


def test_cli_errors_exit_1(tmp_path):
    """Bad input and a missing GPU end in one 'Error:' line and exit 1."""
    from tpulbm_torch import cli

    pf, of = _files("128x128")
    assert cli.main([str(tmp_path / "missing.params"), str(of),
                     "--device", "cpu"]) == 1
    if not torch.cuda.is_available():
        res = subprocess.run(
            [sys.executable, "-m", "tpulbm_torch", str(pf), str(of)],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert res.returncode == 1
        assert res.stderr.startswith("Error: --device cuda")
        assert res.stdout == ""


def test_convert_round_trip():
    pf, of = _files("128x256")
    p = read_params(pf)
    mask, n_free = read_obstacles(of, p.nx, p.ny)
    jp = tpulbm.LBMParams(**dataclasses.asdict(p.with_free_cells(n_free)))
    jf = np.asarray(tpulbm.initial_state(jp))
    p2, f, obst = convert.from_tpulbm(jp, jf, mask, device="cpu")
    assert dataclasses.asdict(p2) == dataclasses.asdict(jp)
    assert torch.equal(f, initial_state(p2)) and obst.dtype == torch.bool
    d, f_np, m_np = convert.to_numpy(p2, f, obst)
    assert tpulbm.LBMParams(**d) == jp
    assert np.array_equal(f_np, jf) and np.array_equal(m_np, mask)
    with pytest.raises(ValueError):
        convert.from_tpulbm(jp, jf[:, :-1], mask)


def test_golden_prefix_128x256():
    """128 steps of the 128x256 deck against the reference's golden series
    at the reference's 1 % gate (observed float-vs-double drift ~0.1 %)."""
    n = 128
    pf, of = _files("128x256")
    p = read_params(pf)
    mask, n_free = read_obstacles(of, p.nx, p.ny)
    p = p.with_free_cells(n_free)
    _, av = make_runner(p, n, backend="torch", device="cpu")(
        initial_state(p), torch.tensor(mask))
    golden = np.loadtxt(GOLDEN / "128x256.av_vels.dat", usecols=[1],
                        max_rows=n)
    rel = np.abs(av.numpy().astype(np.float64) - golden) / np.abs(golden)
    assert rel.max() < 0.01, f"max rel {rel.max():.2e} @ {rel.argmax()}"


def test_check_accepts_golden_and_rejects_drift(tmp_path):
    """The port's numpy-only checker: a golden passes against itself; a
    series 2 % off fails, through the same CLI as tpulbm.validation.check."""
    ref = GOLDEN / "128x128.av_vels.dat"
    fs = GOLDEN / "128x128.final_state.dat"
    assert check.main(["--ref-av-vels-file", str(ref),
                       "--ref-final-state-file", str(fs),
                       "--av-vels-file", str(ref),
                       "--final-state-file", str(fs)]) == 0
    av = np.loadtxt(ref, usecols=[1])
    writers.write_av_vels(tmp_path / "av", (av * 1.02).astype(np.float32))
    assert check.main(["--ref-av-vels-file", str(ref), "--av-vels-only",
                       "--av-vels-file", str(tmp_path / "av")]) == 1


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax_or_tpulbm():
    """An AST scan of every module of tpulbm_torch, of chip_smoke.py and of
    the port's examples: no jax and no tpulbm import (the GPU host has no
    jax)."""
    files = sorted((ROOT / "tpulbm_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.name for p in examples] == ["torch_custom_simulation.py",
                                          "torch_run_reference_deck.py"]
    files += examples
    assert len(files) > 20
    for name in ("dist/multihost.py", "dist/launch.py", "graft_entry.py",
                 "tools/make_deck.py", "tools/validate_f64.py",
                 "tools/make_f64_goldens.py", "viz.py"):
        assert ROOT / "tpulbm_torch" / name in files, name
    for path in files:
        for name in _imports(ast.parse(path.read_text(), str(path))):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpulbm"), (path, name)
