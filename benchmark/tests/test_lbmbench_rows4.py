"""The four-card cell ``solve-1024-rows4`` and the readers of K6's wait
counters (``lbmbench/waits.py``): the cell loads with its config and
readers, and the readers read None where the program keeps no counter or
counted nothing, and the shares of a planted one."""

import types

import pytest

from lbmbench import spec
from tpulbm_torch.ops import ring_p2p

BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
READERS = ("p2p_wait_share.rows4", "p2p_remote_share.rows4")


def run(cards=(0, 1, 2, 3)):
    return types.SimpleNamespace(cards=list(cards))


def test_the_cell_loads_with_its_config_and_readers():
    cell = spec.Cell(BENCH, "solve-1024-rows4")
    assert cell.chips == 4
    assert cell.config["layout"] == {"ring": 4}
    assert cell.config["backend"] == "cuda-p2p"
    assert (cell.config["nx"], cell.config["ny"]) == (1024, 1024)
    ref = spec.load_json(spec.HERE / "configs" / "ref-1024.json")
    for key in ("nx", "ny", "maxIters", "reynolds_dim", "density", "accel",
                "omega", "obstacles", "precision", "draws"):
        assert cell.config[key] == ref[key], key
    assert cell.traffic["kind"] == "long_solve"
    names = {m["name"] for m in cell.per_layer}
    assert set(READERS) <= names
    assert {"idle_share.solve", "bound_share.solve",
            "launches_per_kstep.solve", "idle_sim.solve",
            "idle_issue.solve"} <= names
    assert {m["name"] for m in cell.end_to_end} == {"mlups", "setup_s"}
    for name in READERS:
        assert callable(cell.reader(name))


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_counter_or_a_count(name, monkeypatch):
    read = spec.load_module(spec.HERE / "metrics" / f"{name}.py").read
    monkeypatch.delattr(ring_p2p, "WAITS", raising=False)
    assert read(run()) is None                  # a tree before the counter
    monkeypatch.setattr(ring_p2p, "WAITS", {}, raising=False)
    assert read(run()) is None                  # no K6 launch (the CPU)
    assert read(run(())) is None                # no card at all
    monkeypatch.setattr(ring_p2p, "WAITS", {0: dict(
        cta_ns=0, wait_ns=0, remote_ns=0, launches=0)}, raising=False)
    assert read(run()) is None


def test_a_planted_count(monkeypatch):
    waits = {0: dict(cta_ns=1000, wait_ns=200, remote_ns=150, launches=4),
             1: dict(cta_ns=2000, wait_ns=600, remote_ns=100, launches=4),
             2: dict(cta_ns=4000, wait_ns=400, remote_ns=400, launches=4),
             3: dict(cta_ns=1000, wait_ns=0, remote_ns=0, launches=4),
             7: dict(cta_ns=10, wait_ns=10, remote_ns=10, launches=1)}
    monkeypatch.setattr(ring_p2p, "WAITS", waits, raising=False)
    wait, remote = (spec.load_module(spec.HERE / "metrics" / f"{n}.py").read
                    for n in READERS)
    # the mean over the cell's cards of each card's share; card 7 is not
    # the cell's
    assert wait(run()) == pytest.approx((20 + 30 + 10 + 0) / 4)
    assert remote(run()) == pytest.approx((15 + 5 + 10 + 0) / 4)
    assert wait(run((1,))) == pytest.approx(30)
