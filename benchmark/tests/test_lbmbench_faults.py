"""The whole run on the CPU at a tiny size, the look for a card skipped:
sound runs come out correct, and each fault a cell can have, planted in
the program underneath the timed path, makes ``correct`` false."""

import numpy as np
import pytest

from lbmbench import cell as cellrun
from lbmbench import compare, spec

SEED = 2**31 + 11


def run(tiny, name):
    bench, tmp = tiny
    c = spec.Cell(bench, name, traffic_dir=tmp)
    return cellrun.run_cell(c, SEED, 0.4, False, device="cpu")


def wrap_runner(monkeypatch, fault):
    """Plant ``fault(state or shards, av) -> (state or shards, av)`` in
    every runner the Simulation builds."""
    from tpulbm_torch.sim import simulation

    make = simulation.make_runner

    def make_faulty(*args, **kwargs):
        inner = make(*args, **kwargs)

        def runner(f, obstacles):
            out, av = inner(f if isinstance(f, list) else f.clone(),
                            obstacles)
            return fault(f, out, av)

        return runner

    monkeypatch.setattr(simulation, "make_runner", make_faulty)


@pytest.mark.parametrize("name", ["solve-1024", "sweep-128",
                                  "solve-1024-rows4"])
def test_sound_runs_are_correct(tiny, name):
    result = run(tiny, name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def unchanged(f_in, out, av):
    # the step hands back the state it was given
    return (f_in if not isinstance(f_in, list)
            else [s.clone() for s in f_in]), av


def altered_state(f_in, out, av):
    # one population of one cell altered where it is produced
    first = out[0] if isinstance(out, list) else out
    first[1, 5, 7] += 1e-3
    return out, av


def altered_av(f_in, out, av):
    av = av.clone()
    av[len(av) // 2] *= 1.5
    return out, av


@pytest.mark.parametrize("name", ["solve-1024", "sweep-128",
                                  "solve-1024-rows4"])
@pytest.mark.parametrize("fault", [unchanged, altered_state, altered_av])
def test_a_fault_in_the_runner_fails(tiny, monkeypatch, name, fault):
    if fault is unchanged and name == "solve-1024-rows4":
        snapshot = []   # the ring's shards are taken over: keep copies

        def fault(f_in, out, av, _s=snapshot):
            return [s.clone() for s in _s[-1]], av

        from tpulbm_torch.sim import simulation

        make = simulation.make_runner

        def make_faulty(*args, **kwargs):
            inner = make(*args, **kwargs)

            def runner(shards, obst):
                snapshot.append([s.clone() for s in shards])
                out, av = inner(shards, obst)
                return [s.clone() for s in snapshot[-1]], av

            return runner

        monkeypatch.setattr(simulation, "make_runner", make_faulty)
    else:
        wrap_runner(monkeypatch, fault)
    assert not run(tiny, name)["correct"]


def test_the_exchange_left_out_fails(tiny, monkeypatch):
    # each shard's halo rows cut from the shard itself, not its neighbours
    from tpulbm_torch.dist import multihost

    move = multihost.Transport.move

    def no_exchange(self, pieces, sources):
        return move(self, [(dst, dst, shape, cut)
                           for _, dst, shape, cut in pieces], sources)

    monkeypatch.setattr(multihost.Transport, "move", no_exchange)
    result = run(tiny, "solve-1024-rows4")
    assert not result["correct"]
    assert result["checks"]["state_rel"]["value"] > compare.LIMITS["state_rel"]


@pytest.mark.parametrize("writer", ["write_av_vels", "write_final_state"])
def test_a_written_file_altered_fails(tiny, monkeypatch, writer):
    from tpulbm_torch.sim import simulation

    write = getattr(simulation, writer)

    def altered(path, *args, **kwargs):
        if writer == "write_av_vels":
            av = np.array(args[0], copy=True)
            av[-1] *= 1.5
            return write(path, av)
        fields = [np.array(a, copy=True) for a in kwargs.pop("fields")]
        fields[0][3, 4] += 1e-2
        return write(path, *args, fields=fields, **kwargs)

    monkeypatch.setattr(simulation, writer, altered)
    assert not run(tiny, "sweep-128")["correct"]


def test_control_in_bfloat16_fails(tiny):
    bench, tmp = tiny
    control = spec.load_module(spec.HERE / "control.py")
    for name in ("solve-1024", "sweep-128"):
        got = control.readings(spec.Cell(bench, name, traffic_dir=tmp),
                               SEED, "cpu")
        assert any(got[k] > compare.LIMITS[k] for k in compare.LIMITS
                   if k in got), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["solve-1024", "solve-128", "sweep-128"])
def test_control_fails_at_the_cells_size(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    control = spec.load_module(spec.HERE / "control.py")
    cell = spec.Cell(spec.load_json(spec.ROOT / "BENCHMARK.json"), name)
    for seed in (1, 2, 3):
        got = control.readings(cell, seed, "cuda:0")
        assert any(got[k] > compare.LIMITS[k] for k in compare.LIMITS
                   if k in got), got
