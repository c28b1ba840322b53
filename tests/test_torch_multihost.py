"""Multi-process runs of tpulbm_torch (``dist.multihost``, ``dist.launch``,
``--multihost``, ``--ckpt-backend dcp``), the driver hooks and the tools,
on the CPU.

The processes meet over gloo at a ``file://`` store (``python -m
tpulbm_torch.dist.launch --local-smoke PxL``, which stops them all when one
fails or its ``--timeout`` passes). Against one process driving the same
shards every output is the same bytes: the slabs cross processes unchanged
and every process adds the per-shard sums in shard order. Against the JAX
package's ring over 4 virtual CPU devices (``backend="jnp"``) the tiers of
test_torch_ring for 60 steps: state atol 5e-7, av rtol 5e-5. Every run is
128^2 for at most 60 steps, as each process imports torch anew.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpulbm
from tpulbm.core.params import LBMParams as JParams
from tpulbm.dist.mesh import get_mesh as j_get_mesh
from tpulbm.dist.runner import make_runner as j_make_runner
from tpulbm.tools import make_deck as j_make_deck
from tpulbm import viz as j_viz
from tpulbm_torch import cli, graft_entry, viz
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import multihost
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import _build, step_torch
from tpulbm_torch.sim import checkpoint as ckpt
from tpulbm_torch.sim.simulation import Simulation
from tpulbm_torch.tools import make_deck

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PF = str(ROOT / "data" / "input_128x128.params")
OF = str(ROOT / "data" / "obstacles_128x128.dat")
STEPS = ["--device", "cpu", "--max-iters", "60"]
ENV_KEYS = ("TPULBM_COORDINATOR", "TPULBM_NUM_PROCS", "TPULBM_PROC_ID",
            "TPULBM_LOCAL_SHARDS", "MASTER_ADDR", "MASTER_PORT", "RANK",
            "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def launch(shape, *args):
    """python -m tpulbm_torch.dist.launch --local-smoke shape <deck> args."""
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    proc = subprocess.run(
        [sys.executable, "-m", "tpulbm_torch.dist.launch", "--local-smoke",
         shape, "--timeout", "150", PF, OF, *STEPS, *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def one_process(*args):
    assert cli.main([PF, OF, *STEPS, *args]) == 0


def same_bytes(a, b):
    for name in ("final_state.dat", "av_vels.dat"):
        got, want = (Path(a) / name).read_bytes(), (Path(b) / name).read_bytes()
        assert got == want, f"{a} and {b}: {name} differs"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """2 processes x 2 shards and one process of 4 shards, 60 steps, each
    saving a dcp checkpoint every 30 steps."""
    d = tmp_path_factory.mktemp("runs")
    proc = launch("2x2", "--out-dir", str(d / "two"), "--ckpt-backend", "dcp",
                  "--checkpoint-every", "30", "--checkpoint-dir",
                  str(d / "ck_two"), "--launch-counts", str(d / "launches"))
    one_process("--device-count", "4", "--out-dir", str(d / "one"),
                "--ckpt-backend", "dcp", "--checkpoint-every", "30",
                "--checkpoint-dir", str(d / "ck_one"))
    return d, proc


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


# -- start-up and choices ----------------------------------------------------

@pytest.mark.parametrize("env", [{}, {"TPULBM_NUM_PROCS": "1"},
                                 {"WORLD_SIZE": "1", "RANK": "0"}])
def test_init_distributed_is_a_noop_for_one_process(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert multihost.init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert multihost.world() == (0, 1) and multihost.is_output_process()


@pytest.mark.parametrize("env,want", [
    ({"TPULBM_COORDINATOR": "host0:9876", "TPULBM_NUM_PROCS": "4",
      "TPULBM_PROC_ID": "2"}, ("tcp://host0:9876", 4, 2, 0, 1, None)),
    ({"TPULBM_COORDINATOR": "file:///tmp/s", "TPULBM_NUM_PROCS": "2",
      "TPULBM_PROC_ID": "1", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
      "TPULBM_LOCAL_SHARDS": "3"}, ("file:///tmp/s", 2, 1, 1, 2, 3)),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "29500", "RANK": "3",
      "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"},
     ("env://", 4, 3, 1, 2, None)),
    ({}, (None, 1, 0, 0, 1, None)),
])
def test_dist_env_reads_the_tpulbm_and_torchrun_variables(env, want):
    e = multihost.dist_env(env)
    assert (e.init_method, e.world, e.rank, e.local_rank, e.local_world,
            e.local_shards) == want


@pytest.mark.parametrize("device,shards,local_world,cards,want", [
    ("cpu", 2, 2, 0, "gloo"),
    ("cuda", 2, 2, 1, "gloo"),   # the one-card host: processes share it
    ("cuda", 1, 2, 1, "gloo"),
    ("cuda", 2, 2, 4, "nccl"),   # 2 processes x 2 cards
    ("cuda", 1, 4, 4, "nccl"),   # 4 x 1
    ("cuda", 3, 2, 4, "gloo"),   # cards 0-2 and 3, 0, 1: shared
    ("cuda", 4, 1, 1, "nccl"),   # one process per host, shards share
])
def test_transport_rule(device, shards, local_world, cards, want):
    assert multihost.choose_transport(device, shards, local_world,
                                      cards) == want


def test_global_mesh_is_host_contiguous(clean_env):
    """Process 1 of 2 owns shards 2-3 of 4 (blocks (1, 0), (1, 1) of a
    2x2 torus); the transport refuses a mesh that places them otherwise."""
    clean_env.setattr(multihost, "world", lambda: (1, 2))
    clean_env.setattr(torch.distributed, "get_backend", lambda: "gloo")
    assert multihost.global_ring_mesh(4, "cpu") == [
        None, None, torch.device("cpu"), torch.device("cpu")]
    assert multihost.global_torus_mesh(2, 2, "cpu") == [
        [None, None], [torch.device("cpu")] * 2]
    tr = multihost.Transport(multihost.global_ring_mesh(4, "cpu"))
    assert (tr.local, tr.per, tr.owner(1), tr.owner(3)) == ([2, 3], 2, 0, 1)
    with pytest.raises(ValueError, match="owns shards 2-3"):
        multihost.Transport([torch.device("cpu"), None, None, None])
    with pytest.raises(ValueError, match="split evenly"):
        multihost.global_ring_mesh(3, "cpu")


def test_cli_dies_when_the_group_cannot_start(clean_env, capsys):
    clean_env.setenv("TPULBM_NUM_PROCS", "2")
    assert cli.main([PF, OF, *STEPS, "--multihost"]) == 1
    err = capsys.readouterr().err
    assert "Error: torch.distributed initialization failed" in err
    assert "no coordinator" in err


# -- the ring and the torus over processes ----------------------------------

def test_two_processes_write_the_bytes_of_one(runs):
    """2 processes x 2 CPU shards against --device-count 4 in one process:
    the same final_state.dat and av_vels.dat; process 0 alone prints the
    result block, each process its transport, and each writes its launch
    counts (none on the CPU, where the wrappers run their plain
    versions)."""
    d, proc = runs
    same_bytes(d / "two", d / "one")
    assert proc.stdout.count("==done==") == 1
    assert proc.stderr.count("transport gloo") >= 2
    assert "host exchange" in proc.stderr
    for rank in (0, 1):   # --launch-counts: each process's counters
        counts = json.loads((d / f"launches.{rank}").read_text())
        assert counts == dict.fromkeys(_build.LAUNCHES, 0)   # no kernel


def test_two_processes_against_the_jax_ring(runs):
    """The state at step 60 (the two processes' dcp checkpoint) and the av
    series against the JAX package's jnp ring over 4 virtual devices."""
    d, _ = runs
    p = read_params(PF)
    mask, n_free = read_obstacles(OF, p.nx, p.ny)
    p = p.with_free_cells(n_free)
    step, f, av = ckpt.restore(d / "ck_two" / "ckpt_00000060.dcp", p)
    run = j_make_runner(JParams(**dataclasses.asdict(p)), 60,
                        j_get_mesh(n_devices=4), backend="jnp")
    f_j, av_j = run(jnp.asarray(initial_state(p).numpy()), jnp.asarray(mask))
    assert step == 60
    np.testing.assert_allclose(f, np.asarray(f_j), rtol=0, atol=5e-7)
    np.testing.assert_allclose(av[:60], np.asarray(av_j), rtol=5e-5)
    written = np.loadtxt(d / "two" / "av_vels.dat", usecols=[1])
    np.testing.assert_allclose(written, np.asarray(av_j), rtol=5e-5)


def test_torchrun_starts_the_group_too(runs, tmp_path):
    """torchrun --standalone --nproc-per-node 2 -m tpulbm_torch ...
    --multihost (MASTER_ADDR/RANK/WORLD_SIZE, env://): the bytes of one
    process."""
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "tpulbm_torch", PF, OF, *STEPS,
         "--device-count", "4", "--multihost", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    same_bytes(tmp_path, runs[0] / "one")


@pytest.mark.parametrize("shape,layout", [
    ("3x1", ["--device-count", "3"]),       # 43/43/42 rows, one a process
    ("2x2", ["--mesh-shape", "2x2"]),       # the torus, a block row each
    ("4x1", ["--mesh-shape", "2x2"]),       # a block each: x and y cross
])
def test_more_process_shapes(tmp_path, shape, layout):
    launch(shape, *layout, "--out-dir", str(tmp_path / "multi"))
    one_process(*layout, "--out-dir", str(tmp_path / "one"))
    same_bytes(tmp_path / "multi", tmp_path / "one")


# -- dcp checkpoints ---------------------------------------------------------

def test_dcp_checkpoints_are_complete(runs):
    d, _ = runs
    for ck in ("ck_two", "ck_one"):
        assert sorted(os.listdir(d / ck)) == ["ckpt_00000030.dcp",
                                              "ckpt_00000060.dcp"]
        assert ckpt.latest(d / ck).endswith("ckpt_00000060.dcp")
    assert len(list((d / "ck_two" / "ckpt_00000030.dcp").glob(
        "*.distcp"))) == 2


@pytest.mark.parametrize("layout", [["--device-count", "4"], []])
def test_dcp_of_two_processes_resumes_in_one(runs, tmp_path, layout):
    """Resumed at step 30 in one process without a process group: over the
    same 4 shards, the bytes of the uninterrupted run; on one device its
    final state (the single-device route's state is the ring's bitwise)."""
    d, _ = runs
    one_process(*layout, "--resume",
                str(d / "ck_two" / "ckpt_00000030.dcp"),
                "--out-dir", str(tmp_path))
    if layout:
        same_bytes(tmp_path, d / "one")
    else:
        assert ((tmp_path / "final_state.dat").read_bytes()
                == (d / "one" / "final_state.dat").read_bytes())


def test_dcp_of_one_process_resumes_in_two(runs, tmp_path):
    d, _ = runs
    launch("2x2", "--resume", str(d / "ck_one" / "ckpt_00000030.dcp"),
           "--out-dir", str(tmp_path))
    same_bytes(tmp_path, d / "one")


def test_jax_npz_checkpoint_resumes_under_multihost(tmp_path):
    """A checkpoint of the JAX package (compressed npz, one device, step
    30) resumed by 2 processes x 2 shards and by one process of 4: the
    same bytes."""
    jsim = tpulbm.Simulation.from_files(PF, OF, mesh=j_get_mesh(n_devices=1),
                                        backend="jnp")
    jsim.run(n_steps=30)
    path = jsim.save_checkpoint(tmp_path / "ck")
    launch("2x2", "--resume", str(path), "--out-dir", str(tmp_path / "two"))
    one_process("--device-count", "4", "--resume", str(path), "--out-dir",
                str(tmp_path / "one"))
    same_bytes(tmp_path / "two", tmp_path / "one")


@pytest.mark.parametrize("where", ["header", "data"])
def test_corrupt_dcp_checkpoint_raises(runs, tmp_path, capsys, where):
    """64 bytes flipped in the largest file of a dcp checkpoint, in its
    first item's header or in the middle of its data: the restore raises
    (not FileNotFoundError), and --resume dies with its message."""
    d, _ = runs
    ck = tmp_path / "ckpt_00000030.dcp"
    shutil.copytree(d / "ck_two" / "ckpt_00000030.dcp", ck)
    victim = max(ck.iterdir(), key=lambda p: p.stat().st_size)
    with open(victim, "r+b") as fh:
        fh.seek(10 if where == "header" else victim.stat().st_size // 2)
        fh.write(b"\xff" * 64)
    sim = Simulation.from_files(PF, OF, device="cpu")
    with pytest.raises(Exception) as info:
        sim.restore_checkpoint(ck)
    assert not isinstance(info.value, FileNotFoundError)
    assert cli.main([PF, OF, *STEPS, "--resume", str(ck)]) == 1
    err = capsys.readouterr().err
    assert "Error: cannot resume: corrupt checkpoint" in err


# -- hooks and tools ---------------------------------------------------------

def test_entry_runs_the_small_problem():
    fn, args = graft_entry.entry(device="cpu")
    f, av = fn(*args)
    params, f0, obst = graft_entry._small_problem(64, 128, "cpu")
    _, av_ref = step_torch.run_steps(f0, obst, params, 4)
    assert f.shape == (9, 64, 128) and av.shape == (4,)
    np.testing.assert_allclose(av.numpy(), av_ref.numpy(), rtol=5e-5)


def test_dryrun_multichip_on_the_cpu(capsys):
    graft_entry.dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    for path in ("ring", "ring --backend cuda-p2p", "uneven ring",
                 "torus 2x1", "dcp save/restore", "2 processes x 1 shards"):
        assert f"dryrun_multichip(2) {path}" in out, path
    assert out.count(" ok: av matches oracle") == 6


def test_make_deck_writes_the_jax_tools_bytes(tmp_path):
    blocks = [(10, 20, 5, 7), (30, 4, 2, 40)]
    ours = make_deck.make_deck(96, 48, 123, out_dir=tmp_path / "torch",
                               accel=0.005, blocks=blocks)
    theirs = j_make_deck.make_deck(96, 48, 123, out_dir=tmp_path / "jax",
                                   accel=0.005, blocks=blocks)
    for a, b in zip(ours, theirs):
        assert Path(a).name == Path(b).name
        assert Path(a).read_bytes() == Path(b).read_bytes()
    assert np.array_equal(make_deck.box_obstacles(96, 48, blocks),
                          j_make_deck.box_obstacles(96, 48, blocks))
    assert make_deck.main(["--nx", "16", "--ny", "8", "--iters", "5",
                           "--out-dir", str(tmp_path / "cli")]) == 0
    assert (tmp_path / "cli" / "input_16x8.params").exists()


def test_viz_reads_what_the_jax_viz_reads(runs):
    d, _ = runs
    path = str(d / "two" / "final_state.dat")
    for a, b in zip(viz.load_final_state(path), j_viz.load_final_state(path)):
        assert a.shape == (128, 128)
        assert np.array_equal(a, b)
