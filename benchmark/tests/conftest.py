"""The benchmark's own CPU tests (``python -m pytest benchmark/tests``):
the harness's folder and the checkout's root on the import path, and the
tiny deck the harness runs here."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


@pytest.fixture
def tiny(tmp_path):
    """A BENCHMARK.json object whose cells run a 48x32 deck (a box
    obstacle and a wall row) on the CPU, with its config and traffic files
    under ``tmp_path``: (bench, traffic_dir)."""
    mask = np.zeros((32, 48), dtype=bool)
    mask[10:14, 8:12] = True
    mask[0] = True
    ys, xs = np.nonzero(mask)
    (tmp_path / "obst.dat").write_text(
        "".join(f"{x} {y} 1\n" for x, y in zip(xs, ys)))
    for name, layout in (("one", {}), ("ring", {"ring": 4})):
        (tmp_path / f"{name}.json").write_text(json.dumps(dict(
            nx=48, ny=32, maxIters=120, reynolds_dim=10, density=0.1,
            accel=0.005, omega=1.85, obstacles=str(tmp_path / "obst.dat"),
            layout=layout, backend="auto", max_mlups=50,
            draws={"omega": [1.8, 1.9], "accel_scale": [0.8, 1.2]})))
    (tmp_path / "long.json").write_text(json.dumps(dict(
        kind="long_solve", call_steps="deck", warmup_calls=2,
        trace_seconds=0.2)))
    (tmp_path / "sweep.json").write_text(json.dumps(dict(
        kind="sweep", warmup_solves=1, samples=2, trace_seconds=0.2)))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "one", "file": str(tmp_path / "one.json")},
                        {"name": "ring", "file": str(tmp_path / "ring.json")}]
    bench["workloads"] = [
        {"name": "solve-1024", "config": "one", "traffic": "long",
         "chips": 1},
        {"name": "sweep-128", "config": "one", "traffic": "sweep",
         "chips": 1},
        {"name": "solve-1024-rows4", "config": "ring", "traffic": "long",
         "chips": 4}]
    return bench, tmp_path
