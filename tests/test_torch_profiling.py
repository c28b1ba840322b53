"""tpulbm_torch's spans (``utils.profiling.span``): where each is taken,
how they nest, what ``totals()`` counts, and that tracing changes no
result.

Every test but the last runs on the CPU (the ``torch`` backend, a 32x32
deck). The last needs a CUDA device (marker ``cuda``) and skips without
one; the file imports no jax, so on a GPU host it runs as

    python -m pytest tests/test_torch_profiling.py -m cuda --noconftest -q
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.dist.mesh import get_mesh
from tpulbm_torch.sim.simulation import Simulation
from tpulbm_torch.utils import profiling

torch.set_num_threads(2)

# each span and the span around it (None: none of the program's; a tuple:
# either)
PARENT = {
    "lbm.sim.init": None,
    "lbm.sim.settle": None,
    "lbm.sim.run": None,
    "lbm.dist.make_runner": "lbm.sim.run",
    "lbm.dist.call": "lbm.sim.run",
    "lbm.sim.readback": "lbm.sim.run",
    "lbm.sim.record": "lbm.sim.run",
    "lbm.sim.result": "lbm.sim.run",
    "lbm.sim.reynolds": ("lbm.sim.result", None),
    "lbm.io.write": None,
    "lbm.diag.planes": "lbm.io.write",
    "lbm.io.final_state": "lbm.io.write",
    "lbm.io.av_vels": "lbm.io.write",
}


def _params(max_iters=120, n=32):
    return LBMParams(nx=n, ny=n, max_iters=max_iters, reynolds_dim=10,
                     density=0.1, accel=0.005, omega=1.85)


def _mask(n=32):
    mask = np.zeros((n, n), dtype=bool)
    mask[10:14, 8:12] = True
    mask[0] = True
    return mask


def _solve(out_dir, mesh=None):
    """A Simulation built, settled, run as 3 + 1 chunks of 10 steps (one
    runner) and 1 of 20 (a second), its Reynolds number read and its
    files written: (simulation, result of the last run)."""
    sim = Simulation(_params(), _mask(), backend="torch", device="cpu",
                     mesh=mesh)
    sim.settle()
    sim.run(n_steps=30, chunk=10)
    sim.run(n_steps=10, chunk=10)
    r = sim.run(n_steps=20, chunk=20)
    sim.reynolds()
    sim.write_outputs(out_dir)
    return sim, r


def _lbm_parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("lbm."):
        p = p.cpu_parent
    return p


def test_spans_nest_and_count_under_a_cpu_session(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _solve(tmp_path)
    spans = [e for e in prof.events() if e.name.startswith("lbm.")]
    names = [e.name for e in spans]
    assert set(PARENT) <= set(names)
    for ev in spans:
        parent = _lbm_parent(ev)
        if ev.name in PARENT:
            want = PARENT[ev.name]
            assert (parent and parent.name) in (
                want if isinstance(want, tuple) else (want,)), ev.name
        if parent is not None:
            assert parent.time_range.start <= ev.time_range.start
            assert ev.time_range.end <= parent.time_range.end
    # 3 + 1 + 1 runner calls, one readback and one record a call; a runner
    # built for 10 steps and one for 20 (the second run of 10 finds its
    # runner built); reynolds() once in each result and once alone
    for name, n in (("lbm.dist.call", 5), ("lbm.sim.readback", 5),
                    ("lbm.sim.record", 5), ("lbm.dist.make_runner", 2),
                    ("lbm.sim.run", 3), ("lbm.sim.result", 3),
                    ("lbm.sim.reynolds", 4), ("lbm.io.write", 1)):
        assert names.count(name) == n, name
    calls, builds = (
        sorted((e.time_range for e in spans if e.name == name),
               key=lambda t: t.start)
        for name in ("lbm.dist.call", "lbm.dist.make_runner"))
    # each build comes before the first call of its runner
    assert builds[0].end <= calls[0].start
    assert calls[3].end <= builds[1].start
    assert builds[1].end <= calls[4].start


def test_totals_count_without_a_session(tmp_path):
    assert not torch.autograd.profiler._is_profiler_enabled
    profiling.reset_totals()
    _solve(tmp_path)
    got = profiling.totals()
    assert {name: got[name][0] for name in PARENT} == {
        "lbm.sim.init": 1, "lbm.sim.settle": 1, "lbm.sim.run": 3,
        "lbm.dist.make_runner": 2, "lbm.dist.call": 5, "lbm.sim.readback": 5,
        "lbm.sim.record": 5, "lbm.sim.result": 3, "lbm.sim.reynolds": 4,
        "lbm.io.write": 1, "lbm.diag.planes": 1, "lbm.io.final_state": 1,
        "lbm.io.av_vels": 1}
    assert all(s > 0 for _, s in got.values())
    assert got["lbm.sim.run"][1] >= got["lbm.dist.call"][1]
    profiling.reset_totals()
    assert profiling.totals() == {}


def test_spans_add_up_over_threads():
    profiling.reset_totals()
    with profiling.span("lbm.test.outer"):
        with profiling.span("lbm.test.inner"):
            pass
    got = profiling.totals()
    assert got["lbm.test.outer"][1] >= got["lbm.test.inner"][1] > 0

    def work():
        for _ in range(1000):
            with profiling.span("lbm.test.threads"):
                pass

    threads = [threading.Thread(target=work) for _ in range(15)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        work()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert profiling.totals()["lbm.test.threads"][0] == 16000


def test_a_session_changes_no_result(tmp_path):
    (tmp_path / "plain").mkdir()
    (tmp_path / "traced").mkdir()
    sim_a, a = _solve(tmp_path / "plain")
    with profile(activities=[ProfilerActivity.CPU]):
        sim_b, b = _solve(tmp_path / "traced")
    assert np.array_equal(a.av_vels, b.av_vels)
    assert torch.equal(sim_a.f, sim_b.f)
    assert a.reynolds == b.reynolds
    for name in ("final_state.dat", "av_vels.dat"):
        assert ((tmp_path / "plain" / name).read_bytes()
                == (tmp_path / "traced" / name).read_bytes())


def test_ring_counts_one_exchange_a_chunk(tmp_path):
    """Two shards of 16 rows: chunks of 8 steps, so 10 steps are a chunk
    of 8 and one of 2, and 20 steps three; the slab exchange is one span
    a chunk, the deferred sums one a call."""
    profiling.reset_totals()
    _solve(tmp_path, mesh=get_mesh(2, device="cpu"))
    got = profiling.totals()
    assert got["lbm.dist.exchange"][0] == 4 * 2 + 3
    assert got["lbm.dist.sums"][0] == got["lbm.dist.call"][0] == 5


@pytest.mark.cuda
def test_k4_run_puts_no_span_on_the_card():
    """1024^2 on the cuda backend (K6's grid kind) under a CUDA session: the
    spans are host operations of the trace, and none of them is on the
    card's timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpulbm_torch.dist.runner import resident_route

    p = _params(max_iters=64, n=1024)
    assert not resident_route(p.ny, p.nx)
    sim = Simulation(p, _mask(1024), backend="cuda", device="cuda")
    sim.settle()
    sim.run(n_steps=16)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(n_steps=48)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    on_card = [e.name() for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA]
    on_host = [e.name() for e in events
               if e.device_type() == torch.autograd.DeviceType.CPU]
    assert any("grid_p2p" in n for n in on_card)
    assert not [n for n in on_card if n.startswith("lbm.")]
    assert {"lbm.sim.run", "lbm.dist.call", "lbm.sim.readback"} <= set(
        on_host)
