"""The benchmark's readers of the checkpoint path
(``benchmark/metrics/idle_ckpt.ckpt.py``, ``stall_ckpt.ckpt.py``,
``ckpt_write_ms.ckpt.py``, ``resume_ms.ckpt.py``): None, not an error, on a tree or a run without
their span or counter; the right number from a planted
``checkpoint.STATS``, planted spans and harness spans. Then what the
program's spans and counter count over a small CPU run with checkpoints.
Imports no JAX."""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.sim import checkpoint as ckpt
from tpulbm_torch.sim.simulation import Simulation
from tpulbm_torch.utils import profiling

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
NAMES = ("idle_ckpt.ckpt", "stall_ckpt.ckpt", "ckpt_write_ms.ckpt",
         "resume_ms.ckpt")


@pytest.fixture
def readers(monkeypatch):
    monkeypatch.syspath_prepend(str(BENCH))    # the readers' lbmbench
    out = {}
    for name in NAMES:
        spec = importlib.util.spec_from_file_location(
            name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out[name] = module.read
    return out


def _session(host, device, window_s=1.0, cards=(0,)):
    intervals = {c: [(a, b) for card, _, a, b in device if card == c]
                 for c in cards}
    return types.SimpleNamespace(host=host, device=device,
                                 intervals=intervals, window_s=window_s)


def _run(session=None, spans=()):
    return types.SimpleNamespace(session=session, spans=list(spans),
                                 cards=[0])


# a runner call from 0 to 0.5 s, its checkpoint copy 0.5-0.6 (the card
# busy with the copy 0.5-0.52), the next call 0.6-1.0, the join at its end
# 0.98-1.0 while the card still steps
HOST = [("lbm.sim.run", 0.0, 1.0), ("lbm.dist.call", 0.0, 0.5),
        ("lbm.sim.record", 0.5, 0.6), ("lbm.ckpt.copy", 0.5, 0.6),
        ("lbm.ckpt.wait", 0.55, 0.58), ("lbm.dist.call", 0.6, 0.98),
        ("lbm.ckpt.wait", 0.98, 1.0)]
DEVICE = [(0, "grid_p2p_kernel", 0.0, 0.5), (0, "Memcpy DtoH", 0.5, 0.52),
          (0, "grid_p2p_kernel", 0.6, 1.0)]


def test_idle_ckpt_reads_the_idle_under_the_checkpoint_spans(readers):
    read = readers["idle_ckpt.ckpt"]
    assert read(_run(_session(HOST, DEVICE))) == pytest.approx(8.0)
    # the card busy all through: nothing idle
    busy = [(0, "grid_p2p_kernel", 0.0, 1.0)]
    assert read(_run(_session(HOST, busy))) == pytest.approx(0.0)


def test_stall_ckpt_reads_the_card_without_kernels_under_a_save(readers):
    """The copy's 0.1 s, the Memcpy in it included; the join at the run's
    end left out, the card idle there or not."""
    read = readers["stall_ckpt.ckpt"]
    assert read(_run(_session(HOST, DEVICE))) == pytest.approx(10.0)
    early = DEVICE[:2] + [(0, "grid_p2p_kernel", 0.6, 0.9)]
    assert read(_run(_session(HOST, early))) == pytest.approx(10.0)
    assert readers["idle_ckpt.ckpt"](_run(_session(HOST, early))) == (
        pytest.approx(10.0))
    busy = [(0, "grid_p2p_kernel", 0.0, 1.0)]
    assert read(_run(_session(HOST, busy))) == pytest.approx(0.0)
    # two cards, one stepping through the save: the mean
    two = DEVICE + [(1, "grid_p2p_kernel", 0.0, 1.0)]
    assert read(_run(_session(HOST, two, cards=(0, 1)))) == (
        pytest.approx(5.0))


@pytest.mark.parametrize("name", ["idle_ckpt.ckpt", "stall_ckpt.ckpt"])
@pytest.mark.parametrize("host", [
    [], [e for e in HOST if not e[0].startswith("lbm.ckpt.")]],
    ids=["no_spans", "no_ckpt_spans"])
def test_span_readers_none_without_their_spans(readers, host, name):
    assert readers[name](_run(_session(host, DEVICE))) is None
    assert readers[name](_run(None)) is None


@pytest.mark.parametrize("stats", [None, dict.fromkeys(ckpt.STATS, 0)],
                         ids=["no_counter", "no_saves"])
def test_ckpt_write_ms_none_without_saves(readers, monkeypatch, stats):
    if stats is None:
        monkeypatch.delattr(ckpt, "STATS")
    else:
        monkeypatch.setattr(ckpt, "STATS", stats)
    assert readers["ckpt_write_ms.ckpt"](_run()) is None


def test_ckpt_write_ms_reads_the_mean_write(readers, monkeypatch):
    monkeypatch.setattr(ckpt, "STATS", dict(
        saves=4, bytes=4 * 37_750_000, write_ns=180_000_000, removed=2,
        restores=1))
    assert readers["ckpt_write_ms.ckpt"](_run()) == pytest.approx(45.0)


def test_resume_ms_reads_the_harness_span(readers):
    read = readers["resume_ms.ckpt"]
    assert read(_run(spans=[("run", 20.0)])) is None
    assert read(_run(spans=[("resume", 0.125), ("run", 20.0)])) == (
        pytest.approx(125.0))


# -- what the program counts --------------------------------------------------

def _sim():
    mask = np.zeros((32, 32), dtype=bool)
    mask[10:14, 8:12] = True
    mask[0] = True
    return Simulation(LBMParams(nx=32, ny=32, max_iters=120,
                                reynolds_dim=10, density=0.1, accel=0.005,
                                omega=1.85), mask, backend="torch",
                      device="cpu")


def _ckpt_run(directory):
    """Two checkpointing runs (16 + 64 steps, cadence 16, keep 2) and a
    resume from the newest: 5 saves, 3 removed, 1 restore."""
    sim = _sim()
    for n in (16, 64):
        sim.run(n_steps=n, checkpoint_every=16, checkpoint_dir=directory,
                checkpoint_keep=2)
    _sim().restore_checkpoint(directory)


def test_stats_and_spans_count_a_checkpointing_run(tmp_path):
    ckpt.reset_stats()
    profiling.reset_totals()
    _ckpt_run(str(tmp_path))
    assert {k: ckpt.STATS[k] for k in ("saves", "removed", "restores")} == {
        "saves": 5, "removed": 3, "restores": 1}
    got = profiling.totals()
    assert got["lbm.ckpt.copy"][0] == ckpt.STATS["saves"]
    assert got["lbm.ckpt.restore"][0] == 1
    # a join in each hand-off after a run's first, one at each run's end
    assert got["lbm.ckpt.wait"][0] == 3 + 2
    ckpt.reset_stats()
    assert set(ckpt.STATS.values()) == {0}


def test_no_checkpoint_no_span_or_count(tmp_path):
    ckpt.reset_stats()
    profiling.reset_totals()
    _sim().run(n_steps=32)
    assert not any(name.startswith("lbm.ckpt.")
                   for name in profiling.totals())
    assert set(ckpt.STATS.values()) == {0}


def test_ckpt_spans_nest_on_the_main_thread(tmp_path):
    """``lbm.ckpt.copy`` in ``lbm.sim.record``, ``lbm.ckpt.wait`` in a copy
    or at the run's end in ``lbm.sim.run``, ``lbm.ckpt.restore`` alone; no
    ``lbm.`` span on the writer thread."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _ckpt_run(str(tmp_path))
    spans = [e for e in prof.events() if e.name.startswith("lbm.")]

    def parent(ev):
        p = ev.cpu_parent
        while p is not None and not p.name.startswith("lbm."):
            p = p.cpu_parent
        return p and p.name

    want = {"lbm.ckpt.copy": ("lbm.sim.record",),
            "lbm.ckpt.wait": ("lbm.ckpt.copy", "lbm.sim.run"),
            "lbm.ckpt.restore": (None,)}
    seen = {e.name for e in spans}
    assert set(want) <= seen
    for ev in spans:
        if ev.name in want:
            assert parent(ev) in want[ev.name], ev.name
    assert len({e.thread for e in spans}) == 1
