"""The rest of tpulbm_torch's Simulation and CLI against the JAX package's:
chunk planning, npz checkpoints (in both directions and across meshes),
``--resume``, ``--metrics-file``, ``--debug`` and ``--profile-dir``, and a
runner call's ownership of its input.

Every Simulation here runs on the CPU (the ``torch`` backend: the plain
versions). Tolerances, the tiers of test_torch_ring: the port's plain path
and the JAX jnp path differ by XLA-CPU rounding, av rtol 1e-4 and f atol
2e-7 after 40 steps of the 128^2 deck. Within the port a checkpoint
resumes bitwise.
"""

import dataclasses
import itertools
import json
import os
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import tpulbm
from tpulbm import cli as jcli
from tpulbm.dist.mesh import get_mesh as j_get_mesh
from tpulbm_torch import cli
from tpulbm_torch.dist import runner, sharding
from tpulbm_torch.dist.mesh import get_mesh, get_mesh_2d
from tpulbm_torch.ops import kstep_tile
from tpulbm_torch.sim import checkpoint as ckpt
from tpulbm_torch.sim.simulation import Simulation

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PF = ROOT / "data" / "input_128x128.params"
OF = ROOT / "data" / "obstacles_128x128.dat"
F_ATOL = 2e-7
AV_RTOL = 1e-4

MESHES = {
    "one": lambda: None,
    "ring4": lambda: get_mesh(4, device="cpu"),
    "torus2x2": lambda: get_mesh_2d(2, 2, device="cpu"),
}


def _sim(layout="one"):
    return Simulation.from_files(PF, OF, device="cpu", mesh=MESHES[layout]())


def _jsim():
    return tpulbm.Simulation.from_files(PF, OF, mesh=j_get_mesh(n_devices=1),
                                        backend="jnp")


@pytest.mark.parametrize("cadence", [None, 1, 7, 30, 64, 5000])
def test_plan_chunks_equals_jax(cadence):
    """_plan_chunks returns the JAX package's lists over a grid of starts,
    totals and chunk sizes."""
    for start, total, chunk in itertools.product(
            (0, 3, 25, 30, 4999), (1, 7, 64, 100, 20000), (1, 8, 30, 1000)):
        assert (Simulation._plan_chunks(start, total, chunk, cadence)
                == tpulbm.Simulation._plan_chunks(start, total, chunk,
                                                  cadence)), (start, total,
                                                              chunk)


@pytest.mark.parametrize("writer", ["save_checkpoint", "run_keep2"])
def test_port_checkpoint_resumes_in_jax(tmp_path, writer):
    """25 steps in the port, saved (by ``save_checkpoint``, or by the
    writer thread of a run that checkpoints every 10 steps and keeps 2);
    the file holds the history of the 25 steps alone; the JAX Simulation
    resumes it and runs 15 more: its state and av series those of an
    uninterrupted JAX run, within the tolerance tier."""
    port = _sim()
    if writer == "save_checkpoint":
        port.run(n_steps=25)
        path = port.save_checkpoint(tmp_path)
    else:
        port.run(n_steps=25, checkpoint_every=10,
                 checkpoint_dir=str(tmp_path), checkpoint_keep=2)
        assert sorted(os.listdir(tmp_path)) == ["ckpt_00000020.npz",
                                                "ckpt_00000025.npz"]
        path = ckpt.latest(tmp_path)
    assert os.path.basename(path) == "ckpt_00000025.npz"
    with np.load(path) as z:
        assert z["av_vels"].tobytes() == port.av_vels[:25].tobytes()
    resumed = _jsim()
    resumed.restore_checkpoint(tmp_path)
    assert resumed.step_count == 25
    resumed.run(n_steps=15)
    full = _jsim()
    full.run(n_steps=40)
    np.testing.assert_allclose(np.asarray(resumed.f), np.asarray(full.f),
                               rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(resumed.av_vels[:40], full.av_vels[:40],
                               rtol=AV_RTOL)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """The other way round: a JAX npz checkpoint (written by its async
    checkpointer during the run) resumes in the port, on a torus, to the
    state and av series of the port's uninterrupted run."""
    saver = _jsim()
    saver.run(n_steps=25, checkpoint_every=25, checkpoint_dir=str(tmp_path))
    resumed = _sim("torus2x2")
    resumed.restore_checkpoint(tmp_path / "ckpt_00000025.npz")
    assert resumed.step_count == 25
    np.testing.assert_array_equal(resumed.av_vels[:25], saver.av_vels[:25])
    resumed.run(n_steps=15)
    full = _sim()
    full.run(n_steps=40)
    np.testing.assert_allclose(resumed.f.numpy(), full.f.numpy(), rtol=0,
                               atol=F_ATOL)
    np.testing.assert_allclose(resumed.av_vels[:40], full.av_vels[:40],
                               rtol=AV_RTOL)


@pytest.mark.parametrize("saver,layout",
                         list(itertools.product(MESHES, MESHES)))
def test_checkpoint_resumes_bitwise_on_any_mesh(tmp_path, saver, layout):
    """A checkpoint saved on one device, a ring of 4 or a 2x2 torus resumes
    on each of them: the av prefix is the saver's verbatim, and the
    continuation is bitwise the resuming mesh's own uninterrupted run."""
    a = _sim(saver)
    a.run(n_steps=25)
    a.save_checkpoint(tmp_path)
    resumed = _sim(layout)
    resumed.restore_checkpoint(tmp_path)
    assert resumed.step_count == 25
    assert len(resumed.shards) == (1 if layout == "one" else 4)
    resumed.run(n_steps=15)
    full = _sim(layout)
    full.run(n_steps=40)
    assert torch.equal(resumed.f, full.f)
    np.testing.assert_array_equal(resumed.av_vels[:25], a.av_vels[:25])
    np.testing.assert_array_equal(resumed.av_vels[25:40],
                                  full.av_vels[25:40])


def test_checkpoint_params_mismatch_raises_the_jax_message(tmp_path):
    """A deck that differs from the checkpoint's: the port's restore raises
    the JAX package's ValueError, word for word; a directory without
    checkpoints raises FileNotFoundError."""
    _sim().save_checkpoint(tmp_path)
    ours = _sim()
    ours.params = dataclasses.replace(ours.params, omega=1.4)
    theirs = _jsim()
    theirs.params = dataclasses.replace(theirs.params, omega=1.4)
    with pytest.raises(ValueError) as want:
        theirs.restore_checkpoint(tmp_path)
    with pytest.raises(ValueError) as got:
        ours.restore_checkpoint(tmp_path)
    assert "omega" in str(got.value) and str(got.value) == str(want.value)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints under"):
        ckpt.restore(tmp_path / "empty", ours.params)


def _cli_pair(capsys, args, jargs=()):
    """(rc, stdout, stderr) of the port's CLI on the CPU and of the JAX
    CLI (jnp, one device) on the same arguments."""
    rc = cli.main([str(PF), str(OF), "--device", "cpu", *args])
    ours = capsys.readouterr()
    jrc = jcli.main([str(PF), str(OF), "--backend", "jnp", "--device-count",
                     "1", *args, *jargs])
    theirs = capsys.readouterr()
    return (rc, ours.out, ours.err), (jrc, theirs.out, theirs.err)


def test_cli_resume_of_an_empty_directory(tmp_path, capsys):
    """--resume of a directory without checkpoints exits 1 with the JAX
    CLI's 'cannot resume' line."""
    (rc, _, err), (jrc, _, jerr) = _cli_pair(
        capsys, ["--max-iters", "4", "--resume", str(tmp_path),
                 "--out-dir", str(tmp_path / "o")])
    assert rc == jrc == 1
    assert err.startswith("Error: cannot resume: no checkpoints under")
    assert err == jerr


@pytest.mark.parametrize("mesh_args", [[], ["--mesh-shape", "2x2"]])
def test_cli_checkpoint_and_resume_give_the_same_bytes(tmp_path, capsys,
                                                       mesh_args):
    """--checkpoint-every 16 over 48 steps writes the 16, 32 and 48 files; a
    second run with --resume of the 16-step file writes both output files
    byte for byte as an uninterrupted run, on one device and on a 2x2
    torus."""
    base = [str(PF), str(OF), "--device", "cpu", "--max-iters", "48"]
    full, part, ck = tmp_path / "full", tmp_path / "part", tmp_path / "ck"
    assert cli.main([*base, *mesh_args, "--out-dir", str(full)]) == 0
    assert cli.main([*base, *mesh_args, "--checkpoint-every", "16",
                     "--checkpoint-dir", str(ck), "--ckpt-backend", "npz",
                     "--no-output"]) == 0
    assert sorted(os.listdir(ck)) == [f"ckpt_{s:08d}.npz"
                                      for s in (16, 32, 48)]
    assert cli.main([*base, *mesh_args, "--resume",
                     str(ck / "ckpt_00000016.npz"),
                     "--out-dir", str(part)]) == 0
    capsys.readouterr()
    for name in ("av_vels.dat", "final_state.dat"):
        assert (part / name).read_bytes() == (full / name).read_bytes(), name


def test_cli_metrics_file_and_debug_lines(tmp_path, capsys):
    """--metrics-file appends one JSON line a chunk with the JAX CLI's keys
    and steps; --debug prints the JAX CLI's lines (the reference's DEBUG
    block), with the same timesteps and values within the tolerance
    tier."""
    ours_m, theirs_m = tmp_path / "m" / "ours.jsonl", tmp_path / "theirs.jsonl"
    (rc, out, _), (jrc, jout, _) = _cli_pair(
        capsys, ["--max-iters", "12", "--chunk", "4", "--debug", "--no-output",
                 "--metrics-file", str(ours_m)],
        ["--metrics-file", str(theirs_m)])
    assert rc == jrc == 0
    ours = [json.loads(s) for s in ours_m.read_text().splitlines()]
    theirs = [json.loads(s) for s in theirs_m.read_text().splitlines()]
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    assert [r["step"] for r in ours] == [r["step"] for r in theirs] == [
        4, 8, 12]
    np.testing.assert_allclose([r["av_vel"] for r in ours],
                               [r["av_vel"] for r in theirs], rtol=AV_RTOL)

    def debug(text):
        lines = [s for s in text.splitlines()
                 if s.startswith(("==timestep", "av velocity", "tot density"))]
        return [s.split(":")[0] for s in lines], [
            float(s.split(":")[1].strip("= ")) for s in lines]

    (keys, vals), (jkeys, jvals) = debug(out), debug(jout)
    assert keys == jkeys and len(keys) == 9
    assert "==timestep: 3==" in out and "==timestep: 3==" in jout
    np.testing.assert_allclose(vals, jvals, rtol=AV_RTOL)


def test_cli_profile_dir_leaves_a_trace(tmp_path, capsys):
    """--profile-dir on the CPU records the main loop with torch.profiler
    and leaves a Chrome trace that names the region."""
    trace = tmp_path / "trace"
    assert cli.main([str(PF), str(OF), "--device", "cpu", "--max-iters", "4",
                     "--no-output", "--profile-dir", str(trace)]) == 0
    capsys.readouterr()
    files = os.listdir(trace)
    assert files == ["mainloop.pt.trace.json"]
    events = json.loads((trace / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "mainloop" for e in events)


def test_cli_k6_wait_line(capsys, monkeypatch):
    """The CLI's line of K6's wait counters (ring_p2p.WAITS): none on the
    CPU, where no K6 runs; with counts of two cards in WAITS (as a cuda-p2p
    or torus run leaves them, fill_ns 0, one card counting no CTA yet), one
    stderr line of the mean share over the cards that counted."""
    from tpulbm_torch.ops import ring_p2p

    args = [str(PF), str(OF), "--device", "cpu", "--max-iters", "4",
            "--no-output"]
    monkeypatch.setattr(ring_p2p, "WAITS", {})
    assert cli.main(args) == 0
    assert "K6" not in capsys.readouterr().err
    monkeypatch.setattr(ring_p2p, "WAITS", {
        0: dict(cta_ns=1000, wait_ns=200, remote_ns=150, launches=2,
                fill_ns=0),
        1: dict(cta_ns=3000, wait_ns=300, remote_ns=0, launches=2,
                fill_ns=0),
        2: dict(cta_ns=0, wait_ns=0, remote_ns=0, launches=0, fill_ns=0)})
    assert cli.main(args) == 0
    lines = [s for s in capsys.readouterr().err.splitlines() if "K6" in s]
    assert lines == ["K6 waited 15.0 % of its CTA time on neighbours' flags "
                     "(7.5 % on other cards')"]


def test_cli_k6_wait_line_of_the_grid_kind(capsys, monkeypatch):
    """The CLI's K6 line where the grid kind counted waits for the rows its
    copy group loads (fill_ns, as a one-card wide run leaves WAITS): the
    share of CTA time after the flags' share."""
    from tpulbm_torch.ops import ring_p2p

    args = [str(PF), str(OF), "--device", "cpu", "--max-iters", "4",
            "--no-output"]
    monkeypatch.setattr(ring_p2p, "WAITS", {0: dict(
        cta_ns=4000, wait_ns=40, remote_ns=0, launches=3, fill_ns=500)})
    assert cli.main(args) == 0
    lines = [s for s in capsys.readouterr().err.splitlines() if "K6" in s]
    assert lines == ["K6 waited 1.0 % of its CTA time on neighbours' flags "
                     "(0.0 % on other cards'), 12.5 % on the rows it loads"]


def test_cli_grid_item_line(capsys, monkeypatch):
    """The CLI's line of the grid kind's items: none where the run launched
    no grid kind (the CPU), one stderr line of the deck's item shape and
    its updates computed an owned one where it did (a count of grid-kind
    launches in LAUNCHES, as a card's run leaves it)."""
    from tpulbm_torch.ops import _build, ring_p2p

    args = [str(PF), str(OF), "--device", "cpu", "--max-iters", "4",
            "--no-output"]
    monkeypatch.setitem(_build.LAUNCHES, "grid_p2p", 0)
    assert cli.main(args) == 0
    assert "grid kind" not in capsys.readouterr().err
    monkeypatch.setitem(_build.LAUNCHES, "grid_p2p", 2)
    assert cli.main(args) == 0
    lines = [s for s in capsys.readouterr().err.splitlines()
             if "grid kind" in s]
    h, w, ratio = ring_p2p.grid_item(128, 128)
    assert (h, w) == (8, 16)
    assert lines == [f"grid kind: 128 x 128 in 8 x 16 items, {ratio:.3f} "
                     f"updates computed an owned one"]


@pytest.mark.parametrize("layout", list(MESHES))
def test_run_hands_its_shards_to_the_runner(layout):
    """Simulation.run keeps no reference to the shards it hands a runner
    call: none is held while the call runs, and a weakref to each shard the
    run started from is dead after a run of two chunks."""
    sim = _sim(layout)
    first = [weakref.ref(s) for s in sim.shards]
    held = []
    make = sim._runner

    def watched(n_steps):
        inner = make(n_steps)

        def call(*args):
            held.append(len(sim.shards))
            return inner(*args)

        return call

    sim._runner = watched
    sim.run(n_steps=16, chunk=8)
    assert held == [0, 0]
    assert all(r() is None for r in first)


@pytest.mark.parametrize("layout", ["ring4", "torus2x2"])
def test_a_mesh_run_reads_out_by_shard(tmp_path, layout):
    """A ring's or torus's Reynolds number and average velocity (per-shard
    sums added on the first device) agree with one device's to float32
    rounding; its final_state.dat is one device's bytes, its av_vels.dat
    one device's to float32 rounding; a result's f is the state until a
    later run or restore takes it over, and then raises."""
    sims = {m: _sim(m) for m in ("one", layout)}
    res = {m: sim.run(n_steps=16, chunk=8) for m, sim in sims.items()}
    one, mesh = sims["one"], sims[layout]
    assert torch.equal(res[layout].f, one.f)
    assert res[layout].reynolds == pytest.approx(res["one"].reynolds,
                                                 rel=1e-6)
    assert mesh.average_velocity() == pytest.approx(one.average_velocity(),
                                                    rel=1e-6)
    for m, sim in sims.items():
        sim.write_outputs(tmp_path / m)
    assert ((tmp_path / layout / "final_state.dat").read_bytes()
            == (tmp_path / "one" / "final_state.dat").read_bytes())
    np.testing.assert_allclose(
        np.loadtxt(tmp_path / layout / "av_vels.dat", usecols=[1]),
        np.loadtxt(tmp_path / "one" / "av_vels.dat", usecols=[1]), rtol=1e-6)
    path = mesh.save_checkpoint(tmp_path / "ck")
    mesh.run(n_steps=8)
    with pytest.raises(RuntimeError, match="taken over"):
        res[layout].f
    later = mesh.run(n_steps=8)
    assert later.f.shape == (9, 128, 128)
    mesh.restore_checkpoint(path)
    with pytest.raises(RuntimeError, match="taken over"):
        later.f


@pytest.mark.parametrize("layout", list(MESHES))
def test_a_runner_call_writes_into_its_input(layout):
    """Within one runner call a chunk writes into the storage that the chunk
    before it read: after two chunks the state lies in the input's storage
    (two states live, as the JAX runners that donate their input), on one
    device (the K4 plan), a ring and a torus."""
    sim = _sim(layout)
    p, f0 = sim.params, sim.f.clone()
    mask = sim.obstacles
    if layout == "one":
        f_in = f0.clone()
        ptr = f_in.data_ptr()
        plan = runner._chunks(kstep_tile.tile_chunk, kstep_tile.TILE_K, 16)
        f, _ = runner.run_plan(plan, f_in, mask.float(), p)
        assert f.data_ptr() == ptr
        return
    mesh = MESHES[layout]()
    if layout == "ring4":
        fs, obs = sharding.shard_rows(f0, mask, mesh)
    else:
        fs, obs = sharding.shard_blocks(f0, mask, mesh)
    ptrs = [s.data_ptr() for s in fs]
    out, _ = runner.make_runner(p, 16, "torch", "cpu", mesh=mesh)(fs, obs)
    assert [s.data_ptr() for s in out] == ptrs
