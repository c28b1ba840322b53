"""What a cell is made of, found by name under the benchmark's folder.

- ``BENCHMARK.json`` at the checkout's root: the cells and the metrics;
- ``configs/<config>.json``: the deck (the upstream ``input_*.params``
  values under their own names), its obstacle file, the layout, the
  backend and the seeded ranges;
- ``traffic/<traffic>.json``: a traffic mix, parameters of one ``kind``;
- ``kinds/<kind>.py``: the driver of a kind of traffic, ``run(run)``;
- ``metrics/<metric>.py``: the reader of one per-layer metric,
  ``read(view)``, a float or None.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]     # the benchmark's folder
ROOT = HERE.parent                              # the checkout


def load_json(path) -> dict:
    with open(path) as fp:
        return json.load(fp)


def load_module(path: Path):
    """The Python file ``path`` as a module of its own (metric names hold
    dots, so the files are loaded by path, not imported by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(
        "lbmbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of ``BENCHMARK.json`` with its config, traffic, kind,
    end-to-end metrics and per-layer readers."""

    def __init__(self, bench: dict, name: str, traffic_dir: Path = None):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        config = [c for c in bench["configs"]
                  if c["name"] == self.workload["config"]][0]
        self.config = load_json(ROOT / config["file"])
        self.traffic = load_json(Path(traffic_dir or HERE / "traffic")
                                 / f"{self.workload['traffic']}.json")
        self.kind = load_module(HERE / "kinds" / f"{self.traffic['kind']}.py")

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if mine(m) and m["moves"] in reported]

    def reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py").read


def read_obstacles(path, nx: int, ny: int) -> np.ndarray:
    """The (ny, nx) boolean mask of an upstream obstacle file: one
    ``x y 1`` line per blocked cell (d2q9-bgk.c:912-957)."""
    values = np.array(Path(path).read_text().split(), dtype=np.int64)
    xs, ys, blocked = values.reshape(-1, 3).T
    if ((xs < 0) | (xs >= nx) | (ys < 0) | (ys >= ny) | (blocked != 1)).any():
        raise ValueError(f"{path}: a line outside the {nx}x{ny} grid")
    mask = np.zeros((ny, nx), dtype=bool)
    mask[ys, xs] = True
    return mask


def f32(x: float) -> float:
    return float(np.float32(x))


def draw(rng: np.random.Generator, config: dict) -> tuple:
    """One (omega, accel) from the config's ranges, as float32 values:
    omega uniform in ``draws.omega``, accel the deck's times a factor
    uniform in ``draws.accel_scale``."""
    lo, hi = config["draws"]["omega"]
    omega = f32(rng.uniform(lo, hi))
    lo, hi = config["draws"]["accel_scale"]
    accel = f32(config["accel"] * rng.uniform(lo, hi))
    return omega, accel


def rngs(seed: int):
    """(the draws' generator, the samples' generator) of a run's seed."""
    s = int(seed) % (1 << 64)
    return (np.random.default_rng([s, 0]), np.random.default_rng([s, 1]))
