"""The benchmark's reader of K6's look-ahead in ring mode
(``benchmark/metrics/ahead_share.rows4.py``), on the program's
``ring_p2p.WAITS`` as a run leaves it: None, not an error, where the
program keeps no ``next_n`` word (a tree before it) or counted no item
after a CTA's first; else the mean over the cell's cards of ``ahead_n /
next_n``. Imports no JAX."""

import importlib.util
import types
from pathlib import Path

import pytest

from tpulbm_torch.ops import ring_p2p

BENCH = Path(__file__).resolve().parent.parent / "benchmark"


@pytest.fixture
def read(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))    # the reader's lbmbench
    path = BENCH / "metrics" / "ahead_share.rows4.py"
    spec = importlib.util.spec_from_file_location("ahead_share", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _run(*cards):
    return types.SimpleNamespace(cards=list(cards))


OLD = dict(cta_ns=1000, wait_ns=10, remote_ns=0, launches=2, fill_ns=0)


@pytest.mark.parametrize("waits", [
    {}, {0: OLD}, {0: OLD, 1: OLD}, {0: dict(OLD, next_n=0, ahead_n=0)}],
    ids=["empty", "no_next_n", "no_next_n_2cards", "grid_kind"])
def test_none_where_no_item_is_counted(read, monkeypatch, waits):
    monkeypatch.setattr(ring_p2p, "WAITS", waits)
    assert read(_run(0)) is None
    assert read(_run(0, 1)) is None


def test_none_where_the_program_has_no_counters(read, monkeypatch):
    monkeypatch.delattr(ring_p2p, "WAITS")
    assert read(_run(0)) is None


def test_the_share_of_a_count(read, monkeypatch):
    monkeypatch.setattr(ring_p2p, "WAITS", {
        0: dict(OLD, next_n=400, ahead_n=300),
        1: dict(OLD, next_n=100, ahead_n=50),
        2: dict(OLD, next_n=0, ahead_n=0),
        5: dict(OLD, next_n=10, ahead_n=0)})
    assert read(_run(0)) == pytest.approx(75.0)
    assert read(_run(0, 1)) == pytest.approx(62.5)
    assert read(_run(0, 1, 2)) == pytest.approx(62.5)   # card 2 took none
    assert read(_run(5, 0)) == pytest.approx(37.5)
