"""The port's float64 oracle (``tpulbm_torch.tools.validate_f64``) and its
golden tool (``tpulbm_torch.tools.make_f64_goldens``) on the CPU, against
the JAX package's oracles (``scripts/validate_f64.py``: ``run_f64``, NumPy,
and ``run_f64_jax``, XLA) and the upstream goldens.

Tolerances: the oracles do the same float64 arithmetic in another
summation order (rho, the av sum), so they differ in the last bits: 6.6e-15
in the state and 4.0e-15 in the av series after 100 steps of the 128^2
deck (measured), gated at 1e-12. Against the reference's double build the
NumPy oracle gives 6.9e-13 (docs/VALIDATION.md), gated at 1e-10.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpulbm.validation import check as jcheck
from tpulbm_torch.tools import make_f64_goldens as mk
from tpulbm_torch.tools import validate_f64 as v
from tpulbm_torch.validation import check

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "goldens"
ORACLE_RTOL = 1e-12
GOLDEN_RTOL = 1e-10

sys.path.insert(0, str(ROOT / "scripts"))
import validate_f64 as jv  # noqa: E402


def _deck(name):
    return v.load_deck(name, ROOT / "data")


def _rel(a, ref):
    return float(np.abs((a - ref) / np.where(ref != 0, ref, 1)).max())


def test_oracle_matches_numpy_oracle():
    """50 steps of the 128^2 deck on the CPU against
    scripts/validate_f64.run_f64: state and av series."""
    p, obst = _deck("128x128")
    f, av = v.run_f64(p, obst, 50, device="cpu")
    f_np, av_np = jv.run_f64(p, obst, 50)
    assert f.dtype == av.dtype == np.float64
    assert f.shape == (9, 128, 128) and av.shape == (50,)
    assert _rel(f, f_np) <= ORACLE_RTOL
    assert _rel(av, av_np) <= ORACLE_RTOL


def test_oracle_matches_xla_oracle():
    """A seeded 24x40 case (10 % random obstacles, free cells on the
    accelerated row, forcing strong enough that the positivity guard holds
    back 2,139 cell-steps of that row, measured) against
    scripts/validate_f64.run_f64_jax, 100 steps. In a subprocess:
    run_f64_jax turns on jax_enable_x64."""
    code = """
import sys
sys.path.insert(0, "scripts")
import numpy as np, torch
torch.set_num_threads(2)
from validate_f64 import run_f64_jax
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.tools import validate_f64 as v
rng = np.random.RandomState(12)
obst = rng.rand(24, 40) < 0.1
assert (~obst[22]).sum() > 20
p = LBMParams(nx=40, ny=24, max_iters=100, reynolds_dim=10, density=0.1,
              accel=0.3, omega=1.7).with_free_cells(int((~obst).sum()))
f, av = v.run_f64(p, obst, 100, device="cpu")
f_jx, av_jx = run_f64_jax(p, obst, 100)
state = np.abs((f - f_jx) / np.where(f_jx != 0, f_jx, 1)).max()
rel = np.abs((av - av_jx) / av_jx).max()
assert state <= 1e-12, state
assert rel <= 1e-12, rel
print("OK", state, rel)
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("OK")


@pytest.mark.parametrize("deck", ["128x128", "128x256"])
def test_oracle_av_matches_upstream_golden(deck):
    """The first 200 steps of the av series against the reference's
    double-build golden."""
    p, obst = _deck(deck)
    _, av = v.run_f64(p, obst, 200, device="cpu")
    golden = np.loadtxt(GOLDEN / f"{deck}.av_vels.dat", usecols=[1],
                        max_rows=200)
    assert _rel(av, golden) <= GOLDEN_RTOL


def test_golden_writer_round_trip(tmp_path):
    """A 100-step 128^2 golden written into tmp_path: the committed
    goldens' keys and dtypes, a (ny, nx) plane; both packages' checkers
    read it, equal to itself; a CPU run of the port's CLI passes the
    port's check against it at 1 %."""
    path, seconds, rel = mk.make_golden(
        "128x128", device="cpu", out_dir=tmp_path, data_dir=ROOT / "data",
        golden_dir=GOLDEN, n_steps=100)
    assert Path(path) == tmp_path / "128x128.final_state.f64.npz"
    assert seconds > 0 and rel <= GOLDEN_RTOL
    with np.load(path) as z, np.load(
            GOLDEN / "256x256.final_state.f64.npz") as ref:
        assert sorted(z.files) == sorted(ref.files)
        for key in ref.files:
            assert z[key].dtype.kind == ref[key].dtype.kind, key
            assert z[key].ndim == ref[key].ndim, key
        assert z["pressure"].dtype == np.float32
        assert z["pressure"].shape == (128, 128)
        assert int(z["steps"]) == 100
        assert z["generator"].tobytes().startswith(b"tpulbm_torch ")
        plane = z["pressure"]
    assert mk.compare(path, path) == (0.0, 0)
    for reader in (check._load_final_state, jcheck._load_final_state):
        cols = reader(path)
        assert cols.shape == (128 * 128, 3)
        np.testing.assert_array_equal(cols[:, 2], plane.ravel())

    out = tmp_path / "run"
    res = subprocess.run(
        [sys.executable, "-m", "tpulbm_torch", str(ROOT / "data" /
         "input_128x128.params"), str(ROOT / "data" / "obstacles_128x128.dat"),
         "--max-iters", "100", "--device", "cpu", "--out-dir", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert res.returncode == 0, res.stderr
    av_ref = tmp_path / "av_ref.dat"
    with open(GOLDEN / "128x128.av_vels.dat") as src:
        av_ref.write_text("".join(src.readline() for _ in range(100)))
    for checker in (check, jcheck):
        ok, av_d, fs_d = checker.check_results(
            str(av_ref), path, str(out / "av_vels.dat"),
            str(out / "final_state.dat"), 1.0, verbose=False)
        assert ok, (av_d, fs_d)
        assert 0 < abs(fs_d.max_diff_pcnt) < 0.1


def test_av_gate_is_live(tmp_path):
    """The 1e-4 av gate passes the oracle's own series against the
    upstream golden, and raises once one golden value moves by 1e-3."""
    p, obst = _deck("128x128")
    _, av = v.run_f64(p, obst, 30, device="cpu")
    lines = (GOLDEN / "128x128.av_vels.dat").read_text().splitlines()[:30]
    good = tmp_path / "good.dat"
    good.write_text("\n".join(lines) + "\n")
    assert mk.check_av(av, good) <= GOLDEN_RTOL
    step, val = lines[17].split()
    lines[17] = f"{step} {float(val) * (1 + 1e-3):.12E}"
    bad = tmp_path / "bad.dat"
    bad.write_text("\n".join(lines) + "\n")
    with pytest.raises(mk.GateError, match="diverged"):
        mk.check_av(av, bad)
    with pytest.raises(mk.GateError, match="30 steps, not 60"):
        mk.check_av(np.concatenate([av, av]), good)


def test_tools_refuse_a_missing_gpu_and_the_committed_goldens(
        tmp_path, monkeypatch, capsys):
    """--device cuda (the default) without a GPU exits non-zero in both
    tools, as does run_f64 on a CUDA device; the golden tool's default
    --out-dir lies outside tests/goldens, and tests/goldens (or the
    --compare directory) is refused as --out-dir."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(ROOT)
    assert v.main(["128x128", "10"]) == 1
    assert mk.main(["128x128", "--max-iters", "10"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    p, obst = _deck("128x128")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        v.run_f64(p, obst, 1)
    default = (ROOT / mk.DEFAULT_OUT).resolve()
    assert GOLDEN.resolve() not in (default, *default.parents)
    for out, extra in (("tests/goldens", []),
                       (str(tmp_path), ["--compare", str(tmp_path)])):
        assert mk.main(["128x128", "--device", "cpu", "--max-iters", "10",
                        "--out-dir", out, *extra]) == 1
    assert "holds the committed goldens" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def _imports(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Import):
            yield from (a.name for a in sub.names)
        elif isinstance(sub, ast.ImportFrom):
            assert sub.level == 0
            yield sub.module


def test_oracle_is_independent_of_the_f32_path():
    """The oracle module imports neither jax nor the JAX package, nor the
    port's f32 physics (core.physics, core.state, core.lattice, ops): of
    the port it imports the deck readers alone, and inside ``study`` the
    Simulation whose f32 route the study holds against the oracle."""
    path = ROOT / "tpulbm_torch" / "tools" / "validate_f64.py"
    tree = ast.parse(path.read_text(), str(path))
    names = set(_imports(tree))
    assert not {n.split(".")[0] for n in names} & {"jax", "jaxlib", "tpulbm"}
    port = {n for n in names if n.startswith("tpulbm_torch")}
    assert port == {"tpulbm_torch.io.obstacles", "tpulbm_torch.io.params_file",
                    "tpulbm_torch.sim.simulation"}
    study = next(n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == "study")
    assert set(_imports(study)) == {"tpulbm_torch.sim.simulation"}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name != "study":
            assert "tpulbm_torch.sim.simulation" not in set(_imports(node))
    top = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            top |= set(_imports(node))
    assert {n for n in top if n.startswith("tpulbm_torch")} == {
        "tpulbm_torch.io.obstacles", "tpulbm_torch.io.params_file"}
