"""BENCHMARK.json keeps to the benchmark's contract: names and units from
the allowed characters, every file a name leads to present, and every
per-layer metric reported in cells that report what it moves."""

import re

import pytest

from lbmbench import spec

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    assert {w["chips"] for w in BENCH["workloads"]} <= {1, 4}
    assert len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for path in BENCH["paths"]:
        assert (spec.ROOT / path).is_dir()


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files(entry):
    config = spec.load_json(spec.ROOT / entry["file"])
    assert entry["reduced"] == config["reduced"]
    for key in entry["reduced"]:
        assert NAME.match(key) and key in config["assumed"]
    mask = spec.read_obstacles(spec.ROOT / config["obstacles"],
                               config["nx"], config["ny"])
    assert 0 < mask.sum() < mask.size


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = spec.Cell(BENCH, cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    moved = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    assert moved
    for cell in metric["workloads"]:
        assert cell in CELLS
        assert cell in moved[0].get("workloads", CELLS)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
