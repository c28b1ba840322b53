"""The benchmark's reader of the grid kind's waits for the rows it loads
(``benchmark/metrics/fill_wait_share.solve.py``), on the program's
``ring_p2p.WAITS`` as a run leaves it: None, not an error, where the
program keeps no ``fill_ns`` word (a tree before it) or counted nothing;
else the mean over the cell's cards of ``fill_ns / cta_ns``. Imports no
JAX."""

import importlib.util
import types
from pathlib import Path

import pytest

from tpulbm_torch.ops import ring_p2p

BENCH = Path(__file__).resolve().parent.parent / "benchmark"


@pytest.fixture
def read(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))    # the reader's lbmbench
    path = BENCH / "metrics" / "fill_wait_share.solve.py"
    spec = importlib.util.spec_from_file_location("fill_wait_share", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _run(*cards):
    return types.SimpleNamespace(cards=list(cards))


OLD = dict(cta_ns=1000, wait_ns=10, remote_ns=0, launches=2)


@pytest.mark.parametrize("waits", [{}, {0: OLD}, {0: OLD, 1: OLD}],
                         ids=["empty", "no_fill_ns", "no_fill_ns_2cards"])
def test_none_where_no_fill_ns_is_counted(read, monkeypatch, waits):
    monkeypatch.setattr(ring_p2p, "WAITS", waits)
    assert read(_run(0)) is None
    assert read(_run(0, 1)) is None


def test_none_where_the_program_has_no_counters(read, monkeypatch):
    monkeypatch.delattr(ring_p2p, "WAITS")
    assert read(_run(0)) is None


def test_the_share_of_a_count(read, monkeypatch):
    monkeypatch.setattr(ring_p2p, "WAITS", {
        0: dict(OLD, cta_ns=4000, fill_ns=500),
        1: dict(OLD, cta_ns=1000, fill_ns=0),
        5: dict(OLD, cta_ns=10, fill_ns=10)})
    assert read(_run(0)) == pytest.approx(12.5)
    assert read(_run(0, 1)) == pytest.approx(6.25)   # card 5 not the cell's
