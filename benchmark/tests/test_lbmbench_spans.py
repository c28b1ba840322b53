"""The readers of the program's spans (``lbmbench/spans.py`` and the
metrics built on it) on synthetic sessions, and once on a CPU session
around a tiny solve of the program."""

import types

import numpy as np
import pytest

from lbmbench import devtrace, spans, spec

IDLE = ("idle_sim.solve", "idle_issue.solve")
SWEEP = ("runner_build_ms.sweep", "planes_ms.sweep", "text_ms.sweep")


def reader(name):
    return spec.load_module(spec.HERE / "metrics" / f"{name}.py").read


def session(device, host, window_s, cards=(0,), steps=0, units=0):
    """A stopped Session holding the given device and host events."""
    s = devtrace.Session(cards)
    s.device, s.host, s.window_s = device, host, window_s
    s.steps, s.units = steps, units
    s.intervals = {c: [(a, b) for d, _, a, b in device if d == c]
                   for c in cards}
    s.busy = {c: devtrace.union(v) for c, v in s.intervals.items()}
    return s


def run(s):
    return types.SimpleNamespace(session=s, cards=s.cards, spans=[])


# One call of a long solve, 0-10 ms: the card busy 1-4 and 5-8 ms. The
# host: the whole run (0-10), a runner call (0-5) with a build inside
# (0-0.5), the readback (5-6, an aten op inside), the record (6-9.5).
HOST = [("bench.run", 0.0, 10e-3),
        ("lbm.sim.run", 0.0, 10e-3),
        ("lbm.dist.call", 0.0, 5e-3),
        ("lbm.dist.make_runner", 0.0, 0.5e-3),
        ("lbm.sim.readback", 5e-3, 6e-3),
        ("aten::copy_", 5.2e-3, 5.9e-3),
        ("lbm.sim.record", 6e-3, 9.5e-3)]
DEVICE = [(0, "k", 1e-3, 4e-3), (0, "k", 5e-3, 8e-3)]


def test_idle_goes_to_the_innermost_span():
    idle = spans.idle_by_span(session(DEVICE, HOST, 10e-3))[0]
    # 0-1 ms idle: 0-0.5 in the build, 0.5-1 in the call; 4-5 in the call;
    # 8-9.5 in the record; 9.5-10 in the run itself; the aten op inside the
    # readback names nothing (the card is busy then anyway)
    assert idle == pytest.approx({"lbm.dist.make_runner": 0.5e-3,
                                  "lbm.dist.call": 1.5e-3,
                                  "lbm.sim.record": 1.5e-3,
                                  "lbm.sim.run": 0.5e-3})
    got = [reader(m)(run(session(DEVICE, HOST, 10e-3))) for m in IDLE]
    assert got == pytest.approx([100 * 2.0e-3 / 10e-3, 100 * 2.0e-3 / 10e-3])


def test_a_gap_across_two_spans_is_split_not_counted_twice():
    # one gap, 2-8 ms, across the end of a call (2-5) and a record (5-8)
    host = [("lbm.sim.run", 0.0, 10e-3), ("lbm.dist.call", 0.0, 5e-3),
            ("lbm.sim.record", 5e-3, 8e-3)]
    device = [(0, "k", 0.0, 2e-3), (0, "k", 8e-3, 10e-3)]
    idle = spans.idle_by_span(session(device, host, 10e-3))[0]
    assert idle == pytest.approx({"lbm.dist.call": 3e-3,
                                  "lbm.sim.record": 3e-3})
    assert sum(idle.values()) == pytest.approx(6e-3)


def test_the_two_idle_shares_stay_within_idle_share():
    # two cards, a host span that starts late and ends early, a gap outside
    # every program span (0-1 ms), and the window a little longer still
    host = [("bench.run", 0.0, 10e-3), ("lbm.sim.run", 1e-3, 9e-3),
            ("lbm.dist.call", 1e-3, 6e-3), ("lbm.sim.record", 6e-3, 9e-3)]
    device = [(0, "k", 2e-3, 5e-3), (1, "k", 1.5e-3, 7e-3),
              (0, "k", 4e-3, 8e-3)]
    s = session(device, host, 11e-3, cards=(0, 1))
    share = reader("idle_share.solve")(run(s))
    sim, issue = (reader(m)(run(s)) for m in IDLE)
    assert sim + issue <= share
    # card 0: 1-2 ms in the call, 8-9 in the record; card 1: 1-1.5 in the
    # call, 7-9 in the record
    assert issue == pytest.approx(100 * (1e-3 + 0.5e-3) / 2 / 11e-3)
    assert sim == pytest.approx(100 * (1e-3 + 2e-3) / 2 / 11e-3)


def test_the_sweep_readers_take_the_mean_over_the_solves():
    host = []
    for i, t in enumerate((0.0, 0.2)):       # two solves of 0.2 s
        host += [("lbm.dist.make_runner", t + 0.01, t + 0.013),
                 ("lbm.io.write", t + 0.1, t + 0.19),
                 ("lbm.diag.planes", t + 0.1, t + 0.11 + 0.01 * i),
                 ("lbm.io.final_state", t + 0.12, t + 0.16),
                 ("lbm.io.av_vels", t + 0.16, t + 0.18)]
    s = session([(0, "k", 0.0, 0.05)], host, 0.4, steps=80000, units=2)
    got = [reader(m)(run(s)) for m in SWEEP]
    assert got == pytest.approx([3.0, 15.0, 60.0])


@pytest.mark.parametrize("name", IDLE + SWEEP)
def test_every_reader_reads_none_without_program_spans(name):
    host = [("bench.run", 0.0, 10e-3), ("aten::copy_", 5e-3, 6e-3)]
    s = session(DEVICE, host, 10e-3, steps=40000, units=1)
    assert reader(name)(run(s)) is None


def test_innermost_merges_and_skips_uncovered_time():
    got = spans.innermost([("lbm.a", 0.0, 1.0), ("lbm.b", 0.2, 0.4),
                           ("lbm.c", 2.0, 3.0)])
    assert got == [(0.0, 0.2, "lbm.a"), (0.2, 0.4, "lbm.b"),
                   (0.4, 1.0, "lbm.a"), (2.0, 3.0, "lbm.c")]


def test_a_cpu_session_holds_the_programs_spans(tmp_path):
    """A tiny solve of the program under a CPU session: its spans are host
    events of the session, the sweep readers read them, and the idle
    readers, with no device events, read None."""
    import torch

    from tpulbm_torch.core.params import LBMParams
    from tpulbm_torch.sim.simulation import Simulation

    mask = np.zeros((16, 24), dtype=bool)
    mask[4:8, 4:8] = True
    p = LBMParams(nx=24, ny=16, max_iters=20, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    s = devtrace.Session([])
    s.start()
    sim = Simulation(p, mask, backend="torch", device="cpu")
    sim.settle()
    sim.run()
    sim.reynolds()
    sim.write_outputs(tmp_path)
    s.add(20)
    s.stop()
    names = {n for n, _, _ in spans.program_spans(s)}
    assert {"lbm.sim.init", "lbm.sim.run", "lbm.dist.make_runner",
            "lbm.dist.call", "lbm.diag.planes", "lbm.io.final_state",
            "lbm.io.av_vels"} <= names
    for m in SWEEP:
        assert reader(m)(run(s)) > 0
    for m in IDLE:
        assert reader(m)(run(s)) is None
    assert not torch.autograd.profiler._is_profiler_enabled
