"""K2's counters on the CPU: the benchmark's readers of them
(``benchmark/metrics/*.k2.py`` and ``*.k2.sweep.py`` through
``lbmbench/k2.py``) on planted ``resident.counters()``, None where the
program keeps no counters or counted no launch; the wrapper choosing the
counting instance exactly while a ``torch.profiler`` session is open; the
C entry point's arguments and counter words against ``_SIGNATURES`` and
``COUNTERS``; and the CLI's line. The counting instance itself runs only
on the card (``tests/test_torch_cuda.py``). Imports no JAX."""

import contextlib
import ctypes
import importlib.util
import re
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpulbm_torch import cli
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.ops import _build, resident

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
SOLVE = ("step_ns.k2", "barrier_share.k2", "handoff_share.k2",
         "ends_share.k2")
NAMES = SOLVE + tuple(f"{name}.sweep" for name in SOLVE)


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


def _run(*cards):
    return types.SimpleNamespace(cards=list(cards))


def _words(warp_ns, cell, fill, spin, barrier, ends, warp_steps, steps=512,
           launches=1):
    return dict(warp_ns=warp_ns, cell_ns=cell, fill_ns=fill, spin_ns=spin,
                barrier_ns=barrier, ends_ns=ends, warp_steps=warp_steps,
                steps=steps, launches=launches)


# card 0: a step (1e6 - 2e4) / 700 = 1,400 ns; barrier 6 %, handoff 5 %,
# ends 2 %. Card 1: 1.9e6 / 1,300 ns; 10 %, 10 %, 5 %.
CARD0 = _words(1_000_000, 850_000, 50_000, 10_000, 60_000, 20_000, 700)
CARD1 = _words(2_000_000, 1_500_000, 200_000, 40_000, 200_000, 100_000,
               1300)
ONE = {"step_ns": 1400.0, "barrier_share": 6.0, "handoff_share": 5.0,
       "ends_share": 2.0}
TWO = {"step_ns": (1400.0 + 1.9e6 / 1300) / 2, "barrier_share": 8.0,
       "handoff_share": 7.5, "ends_share": 3.5}


def _plant(monkeypatch, counted):
    monkeypatch.setattr(resident, "counters", lambda: counted)


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_on_one_card_and_two(readers, monkeypatch, name):
    base = name.split(".")[0]
    _plant(monkeypatch, {0: CARD0, 1: CARD1})
    assert readers[name](_run(0)) == pytest.approx(ONE[base])
    assert readers[name](_run(0, 1)) == pytest.approx(TWO[base])
    # a card of the cell that counted nothing is left out of the mean
    _plant(monkeypatch, {0: CARD0, 1: _words(0, 0, 0, 0, 0, 0, 0, 0, 0)})
    assert readers[name](_run(0, 1)) == pytest.approx(ONE[base])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("counted", [
    {}, {0: _words(0, 0, 0, 0, 0, 0, 0, 0, 0)}, {3: CARD0}],
    ids=["no_words", "no_counting_launch", "another_card"])
def test_each_reader_none_without_a_counting_launch(readers, monkeypatch,
                                                     name, counted):
    _plant(monkeypatch, counted)
    assert readers[name](_run(0)) is None


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_none_where_the_program_has_no_counters(
        readers, monkeypatch, name):
    monkeypatch.delattr(resident, "counters")
    assert readers[name](_run(0)) is None


# -- the wrapper ---------------------------------------------------------------

def test_counter_words_are_made_on_first_use_and_read_and_reset(
        monkeypatch):
    monkeypatch.setattr(resident, "_counts", {})
    assert resident.counters() == {}
    words = resident._counter_words(torch.device("cpu"))
    assert words.dtype == torch.int64 and words.tolist() == [0] * 9
    assert resident._counter_words(torch.device("cpu")) is words
    words += torch.arange(1, 10)
    assert resident.counters() == {None: dict(zip(resident.COUNTERS,
                                                  range(1, 10)))}
    resident.reset_counters()
    assert set(resident.counters()[None].values()) == {0}


def test_counting_exactly_while_a_profiler_session_is_open(monkeypatch):
    monkeypatch.setattr(resident, "_counts", {})
    cpu = torch.device("cpu")
    assert resident._counting(cpu) is None
    assert resident._counts == {}           # nothing made outside a session
    with profile(activities=[ProfilerActivity.CPU]):
        words = resident._counting(cpu)
    assert words is resident._counts[None]
    assert resident._counting(cpu) is None  # the session is closed


@pytest.fixture
def fake_launch(monkeypatch):
    """_resident_launch on CPU tensors against a stand-in library: the
    arguments of each lbm_resident_chunk call."""
    calls = []

    def chunk(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(resident, "_counts", {})
    monkeypatch.setattr(resident, "_slots", {})
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(resident, "check_chunk", lambda *a: None)
    monkeypatch.setattr(resident, "launch_plan",
                        lambda *a: (2, 2, 1, 1, 512, 4096))
    monkeypatch.setattr(_build, "library", lambda: types.SimpleNamespace(
        lbm_resident_chunk=chunk))
    monkeypatch.setattr(_build, "on_device",
                        lambda t: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    p = LBMParams(nx=8, ny=8, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    f, o = torch.ones(9, 8, 8), torch.zeros(8, 8)
    return calls, lambda **kw: resident._resident_launch(f, o, p, 4, **kw)


def test_the_launch_passes_counter_words_only_inside_a_session(
        fake_launch):
    calls, launch = fake_launch
    launch()
    with profile(activities=[ProfilerActivity.CPU]):
        launch()
    launch()
    words = resident._counts[None]
    assert [c[-2] for c in calls] == [None, words.data_ptr(), None]
    # the tools' explicit choice holds either way
    launch(count=True)
    with profile(activities=[ProfilerActivity.CPU]):
        launch(count=False)
    assert [c[-2] for c in calls[3:]] == [words.data_ptr(), None]


def test_the_share_of_warp_steps_without_a_cell():
    """At 128^2 (8 x 16 CTAs of 16 warps, h = 5) the first step's region
    of 24 x 16 cells lies in warps 0-11; a phase's steps leave 4, 4, 6, 6
    and 8 warps without a cell; a 512-step launch is 102 phases and one of
    2 (6 and 8). At 256x512 two cells a thread cover every warp."""
    from tpulbm_torch.tools.resident_sweep import idle_warp_share

    plan = resident.resident_plan(128, 128)
    assert plan == (8, 16, 5, 1, 512)
    assert idle_warp_share(128, 128, 5, plan) == pytest.approx(28 / 80)
    assert idle_warp_share(128, 128, 512, plan) == pytest.approx(
        (102 * 28 + 6 + 8) / (512 * 16))
    assert idle_warp_share(256, 512, 512, resident.resident_plan(
        256, 512)) == 0


# -- the C entry point ---------------------------------------------------------

CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
          "unsigned long long": ctypes.c_ulonglong}


def _c_args(src: str, name: str) -> list:
    """The ctypes of the C function ``name``'s parameters: a pointer or a
    stream is c_void_p."""
    params = re.search(rf"\bint {name}\(([^)]*)\)", src).group(1)
    out = []
    for param in params.split(","):
        decl = " ".join(param.split()).rsplit(" ", 1)[0]
        pointer = "*" in param or decl == "cudaStream_t"
        out.append(ctypes.c_void_p if pointer else
                   CTYPES[decl.replace("const ", "")])
    return out


@pytest.mark.parametrize("name", ["lbm_resident_chunk",
                                  "lbm_resident_max_ctas"])
def test_the_entry_points_arguments_match_signatures(name):
    src = (_build.CSRC / "resident.cu").read_text()
    argtypes, restype = _build._SIGNATURES[name]
    assert argtypes == _c_args(src, name)
    assert restype is ctypes.c_int


def test_the_counter_words_match_the_cuda_source():
    src = (_build.CSRC / "resident.cu").read_text()
    body = re.search(r"namespace count \{\s*enum : int \{([^}]*)\}",
                     src).group(1)
    names = [re.sub(r"(?<!^)([A-Z])", r"_\1", n.strip()[1:]).lower()
             for n in body.split(",") if n.strip()]
    assert tuple(names) == resident.COUNTERS
    # the counting instance adds to the words it names, up to kLaunches
    assert "count::kLaunches" in src


# -- the CLI -------------------------------------------------------------------

def test_the_cli_line_on_planted_counters():
    assert cli.k2_line({}) is None
    assert cli.k2_line({0: _words(0, 0, 0, 0, 0, 0, 0, 0, 0)}) is None
    assert cli.k2_line({0: CARD0}) == (
        "K2: 1400 ns a step; its warps 85.0 % on cells, 6.0 % at the step "
        "barrier, 5.0 % on neighbours' edges (1.0 % spinning), 2.0 % "
        "loading and reducing")
    assert cli.k2_line({0: CARD0, 1: CARD1}) == (
        "K2: 1431 ns a step; its warps 80.0 % on cells, 8.0 % at the step "
        "barrier, 7.5 % on neighbours' edges (1.5 % spinning), 3.5 % "
        "loading and reducing")
