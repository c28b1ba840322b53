"""The one-card cell ``solve-8192`` and its configuration ``wide-8192``:
the deck is the project's own 8192x8192 deck, byte for byte and value for
value; the cell loads with its traffic and readers; the reader of the
grid kind's row waits (``fill_wait_share.solve``) reads None where the
program keeps no such word and the shares of a planted count."""

import types

import pytest

from lbmbench import spec
from tpulbm_torch.ops import ring_p2p

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
KEYS = ("nx", "ny", "maxIters", "reynolds_dim", "density", "accel", "omega")


def run(cards=(0,)):
    return types.SimpleNamespace(cards=list(cards))


def reader():
    return spec.load_module(spec.HERE / "metrics"
                            / "fill_wait_share.solve.py").read


def test_the_deck_is_the_projects_8192_deck():
    config = spec.load_json(spec.HERE / "configs" / "wide-8192.json")
    data = spec.ROOT / "data"
    assert ((spec.ROOT / config["obstacles"]).read_bytes()
            == (data / "obstacles_8192x8192.dat").read_bytes())
    values = (data / "input_8192x8192.params").read_text().split()
    assert len(values) == len(KEYS)
    for key, value in zip(KEYS, values):
        assert config[key] == (int(value) if key in ("nx", "ny", "maxIters",
                                                     "reynolds_dim")
                               else float(value)), key
    assert (config["nx"], config["ny"], config["maxIters"]) == (8192, 8192,
                                                                1000)
    ref = spec.load_json(spec.HERE / "configs" / "ref-1024.json")
    for key in ("precision", "layout", "backend", "draws", "reduced"):
        assert config[key] == ref[key], key
    assert config["reference"].startswith("benchmark/lbmbench/reference.py")
    entry = [c for c in BENCH["configs"] if c["name"] == "wide-8192"][0]
    assert entry["file"] == "benchmark/configs/wide-8192.json"
    assert entry["reduced"] == config["reduced"]


def test_the_cell_loads_with_its_config_traffic_and_readers():
    cell = spec.Cell(BENCH, "solve-8192")
    assert cell.chips == 1
    assert cell.workload["config"] == "wide-8192"
    assert cell.traffic["kind"] == "long_solve"
    assert cell.traffic["call_steps"] == "deck"
    assert {m["name"] for m in cell.end_to_end} == {"mlups", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert names == {"idle_share.solve", "bound_share.solve",
                     "launches_per_kstep.solve", "idle_sim.solve",
                     "idle_issue.solve", "tile_wait_share.solve",
                     "fill_wait_share.solve"}
    for name in names:
        assert callable(cell.reader(name))
    assert "fill_wait_share.solve" in {
        m["name"] for m in spec.Cell(BENCH, "solve-1024").per_layer}


def test_fill_reader_none_without_the_word(monkeypatch):
    read = reader()
    monkeypatch.delattr(ring_p2p, "WAITS", raising=False)
    assert read(run()) is None                  # no counters at all
    monkeypatch.setattr(ring_p2p, "WAITS", {}, raising=False)
    assert read(run()) is None                  # no K6 launch (the CPU)
    monkeypatch.setattr(ring_p2p, "WAITS", {0: dict(
        cta_ns=1000, wait_ns=10, remote_ns=0, launches=2)}, raising=False)
    assert read(run()) is None                  # a tree before the word
    monkeypatch.setattr(ring_p2p, "WAITS", {0: dict(
        cta_ns=0, wait_ns=0, remote_ns=0, launches=0, fill_ns=0)},
        raising=False)
    assert read(run()) is None                  # no CTA counted


def test_fill_reader_a_planted_count(monkeypatch):
    monkeypatch.setattr(ring_p2p, "WAITS", {
        0: dict(cta_ns=4000, wait_ns=40, remote_ns=0, launches=3,
                fill_ns=500),
        1: dict(cta_ns=1000, wait_ns=0, remote_ns=0, launches=3,
                fill_ns=300)}, raising=False)
    read = reader()
    assert read(run()) == pytest.approx(12.5)
    assert read(run((0, 1))) == pytest.approx((12.5 + 30) / 2)
