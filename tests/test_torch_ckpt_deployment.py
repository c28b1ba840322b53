"""The checkpointed long solve as a deployment of the port: retention
(``run(..., checkpoint_keep=N)``, ``--checkpoint-keep``), the history
prefix in each checkpoint, the files read back by the benchmark's plain
reader (``benchmark/lbmbench/ckpt_plain.py``, plain numpy), a resume from
each file, and the benchmark's ``ckpt_solve`` kind run whole at a tiny
size, sound and with a fault planted in the checkpoint path.

Every Simulation runs on the CPU (the ``torch`` backend), on a 32x32 deck
with a box obstacle and a wall row. Within the port a checkpoint resumes
bitwise.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tpulbm_torch import cli
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.sim import checkpoint as ckpt
from tpulbm_torch.sim.simulation import Simulation

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
EVERY, STEPS = 16, 80


def _params(max_iters=120, n=32):
    return LBMParams(nx=n, ny=n, max_iters=max_iters, reynolds_dim=10,
                     density=0.1, accel=0.005, omega=1.85)


def _mask(n=32):
    mask = np.zeros((n, n), dtype=bool)
    mask[10:14, 8:12] = True
    mask[0] = True
    return mask


def _sim(backend="npz"):
    return Simulation(_params(), _mask(), backend="torch", device="cpu",
                      ckpt_backend=backend)


@pytest.fixture
def plain(monkeypatch):
    monkeypatch.syspath_prepend(BENCH)        # the harness's lbmbench
    from lbmbench import ckpt_plain

    return ckpt_plain


@pytest.fixture(scope="module")
def uninterrupted():
    """{step: (state, av history)} of a run without checkpoints, read
    after every EVERY steps."""
    sim = _sim()
    out = {}
    for _ in range(STEPS // EVERY):
        sim.run(n_steps=EVERY)
        out[sim.step_count] = (sim.f.clone(),
                               sim.av_vels[:sim.step_count].copy())
    return out


def _names(directory):
    return sorted(os.listdir(directory))


@pytest.mark.parametrize("keep,left", [(2, (64, 80)), (1, (80,)),
                                       (None, (16, 32, 48, 64, 80))],
                         ids=["keep2", "keep1", "keep_all"])
def test_keep_leaves_the_newest_checkpoints(tmp_path, keep, left):
    """Cadence 16 over 80 steps writes five checkpoints; keep N leaves the
    newest N, None every one; ``STATS`` counts the writes and deletions."""
    ckpt.reset_stats()
    _sim().run(n_steps=STEPS, checkpoint_every=EVERY,
               checkpoint_dir=str(tmp_path), checkpoint_keep=keep)
    assert _names(tmp_path) == [f"ckpt_{s:08d}.npz" for s in left]
    assert ckpt.STATS["saves"] == 5
    assert ckpt.STATS["removed"] == 5 - len(left)
    assert ckpt.STATS["write_ns"] > 0
    assert ckpt.STATS["bytes"] >= 5 * 9 * 32 * 32 * 4


def test_keep_of_the_dcp_backend(tmp_path):
    """dcp directories are kept and deleted as npz files are."""
    _sim("dcp").run(n_steps=STEPS, checkpoint_every=EVERY,
                    checkpoint_dir=str(tmp_path), checkpoint_keep=2)
    assert _names(tmp_path) == ["ckpt_00000064.dcp", "ckpt_00000080.dcp"]
    step, f, av = ckpt.restore(tmp_path, _sim().params)
    assert step == 80 and av.shape == (80,)


@pytest.mark.parametrize("slow", [False, True], ids=["writer", "slow_writer"])
@pytest.mark.parametrize("step", range(EVERY, STEPS + 1, EVERY))
def test_each_file_reads_and_resumes_as_the_uninterrupted_run(
        tmp_path, plain, uninterrupted, step, slow, monkeypatch):
    """The plain reader reads each file's state bit for bit as the
    uninterrupted run's at its step and its history as that run's prefix,
    of length step; a Simulation resumed from the file continues bit for
    bit with the uninterrupted run. Every save hands the writer thread the
    one host buffer and a view of the history; a writer that starts late
    still writes its own step's state and history, not the next save's."""
    buffers, histories, write = [], [], ckpt.save

    def save(directory, at, f, av_vels, params):
        buffers.append(f.ctypes.data)
        histories.append(np.shares_memory(av_vels, sim.av_vels))
        if slow:
            time.sleep(0.05)
        return write(directory, at, f, av_vels, params)

    monkeypatch.setattr(ckpt, "save", save)
    sim = _sim()
    sim.run(n_steps=STEPS, checkpoint_every=EVERY,
            checkpoint_dir=str(tmp_path))
    assert len(buffers) == STEPS // EVERY and len(set(buffers)) == 1
    assert all(histories)
    found, other = plain.listing(tmp_path)
    assert sorted(found) == list(range(EVERY, STEPS + 1, EVERY))
    assert other == []
    got = plain.read(found[step])
    f, av = uninterrupted[step]
    assert got["step"] == step
    assert got["f"].tobytes() == f.numpy().tobytes()
    assert got["av_vels"].shape == (step,)
    assert got["av_vels"].tobytes() == av.tobytes()
    assert got["params"]["omega"] == _params().omega
    resumed = _sim()
    resumed.restore_checkpoint(found[step])
    assert not resumed.av_vels[step:].any()
    resumed.run(n_steps=STEPS - step)
    f, av = uninterrupted[STEPS]
    assert torch.equal(resumed.f, f)
    assert resumed.av_vels[:STEPS].tobytes() == av.tobytes()


@pytest.mark.parametrize("f", [
    np.arange(9 * 8 * 6, dtype=np.float32).reshape(9, 8, 6),
    np.arange(9 * 8 * 6, dtype=np.float32).reshape(9, 8, 6)[:, ::2],
    np.zeros((0,), np.float32)], ids=["contiguous", "strided", "empty"])
def test_the_writer_writes_np_savez_file_byte_for_byte(tmp_path, f,
                                                        monkeypatch):
    """``checkpoint._savez`` hands each array to its zip member whole, and
    its file is the one ``np.savez`` writes, byte for byte (the members'
    time stamps held still)."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    arrays = dict(step=np.int64(7), f=f,
                  av_vels=np.linspace(0, 1, 5, dtype=np.float32),
                  params=json.dumps({"omega": 1.85}))
    np.savez(tmp_path / "a.npz", **arrays)
    ckpt._savez(tmp_path / "b.npz", **arrays)
    assert ((tmp_path / "a.npz").read_bytes()
            == (tmp_path / "b.npz").read_bytes())
    with np.load(tmp_path / "b.npz") as got:
        assert got["step"].shape == () and int(got["step"]) == 7
        assert got["f"].tobytes() == np.ascontiguousarray(f).tobytes()


def test_one_writer_thread_serves_every_save(tmp_path, monkeypatch):
    """A Simulation's saves, over several runs, are written by one thread,
    started at the first save and kept, not one thread a save."""
    threads, write = [], ckpt.save

    def save(*args):
        threads.append(threading.get_ident())
        return write(*args)

    monkeypatch.setattr(ckpt, "save", save)
    sim = _sim()
    for _ in range(2):
        sim.run(n_steps=2 * EVERY, checkpoint_every=EVERY,
                checkpoint_dir=str(tmp_path), checkpoint_keep=2)
    assert len(threads) == 4
    assert len(set(threads)) == 1 and threads[0] != threading.get_ident()


def _slow_writes(monkeypatch, seconds, fail_at=None):
    """The writes, as (step, the state's first value read at write time),
    in the order written: each write first sleeps ``seconds``; the one at
    step ``fail_at`` then raises."""
    done, save, save_dcp = [], ckpt.save, ckpt.save_dcp

    def slow(write):
        def wrapped(directory, step, f, *args):
            time.sleep(seconds)
            if step == fail_at:
                raise OSError(f"disk full at {step}")
            first = (next(iter(f.values())) if isinstance(f, dict)
                     else f).reshape(-1)[0]
            done.append((step, float(first)))
            return write(directory, step, f, *args)
        return wrapped

    monkeypatch.setattr(ckpt, "save", slow(save))
    monkeypatch.setattr(ckpt, "save_dcp", slow(save_dcp))
    return done


@pytest.mark.parametrize("backend,ahead", [("npz", 0), ("dcp", 1)])
def test_npz_writes_queue_in_order_and_dcp_joins_before_each(
        tmp_path, monkeypatch, backend, ahead):
    """Two npz saves queue on the writer thread without a join and are
    written in the order submitted; dcp joins the last write before each
    submit (its writer runs collectives), so one is in flight at most.
    ``wait`` joins them all."""
    done = _slow_writes(monkeypatch, 0.3)
    writer = ckpt.AsyncCheckpointer(backend)
    av = np.ones(4, np.float32)
    for step in (1, 2):
        f = np.full((9, 4, 4), step, np.float32)
        writer.submit(tmp_path, step, f if backend == "npz"
                      else {(0, 0): torch.from_numpy(f)}, av, _params())
    assert len(done) == ahead
    writer.wait()
    assert done == [(1, 1.0), (2, 2.0)]
    assert _names(tmp_path) == [f"ckpt_{s:08d}.{backend}" for s in (1, 2)]


def test_a_save_joins_the_write_that_holds_its_buffer(tmp_path,
                                                      monkeypatch):
    """Saves that take two host buffers in turn (as ``HostStage`` does)
    before a slowed writer: the third and fourth each join the write still
    reading the buffer they refill, two saves back, and ``STATS['held']``
    counts them; every file holds its own save's state."""
    done = _slow_writes(monkeypatch, 0.2)
    ckpt.reset_stats()
    writer = ckpt.AsyncCheckpointer()
    buffers = [np.zeros((9, 4, 4), np.float32) for _ in range(2)]
    for step in range(1, 5):
        buf = buffers[step % 2]
        writer.release(buf)
        buf[...] = step
        writer.submit(tmp_path, step, buf, np.ones(step, np.float32),
                      _params())
    writer.wait()
    assert ckpt.STATS["held"] == 2
    assert done == [(s, float(s)) for s in range(1, 5)]
    for step in range(1, 5):
        with np.load(tmp_path / f"ckpt_{step:08d}.npz") as z:
            assert (z["f"] == step).all()


def test_the_end_joins_every_write_and_raises_its_error(tmp_path,
                                                        monkeypatch):
    """``wait`` joins every queued write, the ones after a failed write
    too, then raises the failure; a checkpointing ``run()`` raises its
    writer's error."""
    _slow_writes(monkeypatch, 0.1, fail_at=1)
    writer = ckpt.AsyncCheckpointer()
    for step in (1, 2):
        writer.submit(tmp_path, step, np.zeros((9, 4, 4), np.float32),
                      np.ones(4, np.float32), _params())
    with pytest.raises(OSError, match="disk full at 1"):
        writer.wait()
    assert _names(tmp_path) == ["ckpt_00000002.npz"]
    assert writer.wait() is None
    _slow_writes(monkeypatch, 0.0, fail_at=3 * EVERY)
    with pytest.raises(OSError, match=f"disk full at {3 * EVERY}"):
        _sim().run(n_steps=STEPS, checkpoint_every=EVERY,
                   checkpoint_dir=str(tmp_path / "run"))


class _Copied:
    """A stand-in for the CUDA event that ends a host copy."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


@pytest.mark.parametrize("ready", [None, _Copied()], ids=["cpu", "event"])
def test_a_queued_file_is_save_checkpoints_byte_for_byte(
        tmp_path, monkeypatch, ready):
    """A file the writer thread writes from a handed-over buffer, with or
    without a copy's event to wait on, is byte for byte the one
    ``save_checkpoint()`` writes of the same state; the writer waits on
    the event once, before the write."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    sim = _sim()
    sim.run(n_steps=EVERY + 3)
    path = sim.save_checkpoint(tmp_path / "sync")
    writer = ckpt.AsyncCheckpointer()
    writer.submit(tmp_path / "queued", sim.step_count, sim.f.numpy().copy(),
                  sim.av_vels[:sim.step_count], sim.params, ready=ready)
    writer.wait()
    name = os.path.basename(path)
    assert (tmp_path / "queued" / name).read_bytes() == (
        tmp_path / "sync" / name).read_bytes()
    if ready is not None:
        assert ready.waits == 1


def test_a_torn_tmp_is_neither_latest_nor_deleted(tmp_path):
    """A torn write left by a killed process (a ``….npz.tmp.npz`` file at a
    later step, a ``.dcp.tmp`` directory) is not the latest checkpoint
    and survives retention."""
    (tmp_path / "ckpt_00000099.npz.tmp.npz").write_bytes(b"torn")
    (tmp_path / "ckpt_00000098.dcp.tmp").mkdir()
    _sim().run(n_steps=STEPS, checkpoint_every=EVERY,
               checkpoint_dir=str(tmp_path), checkpoint_keep=1)
    assert _names(tmp_path) == ["ckpt_00000080.npz", "ckpt_00000098.dcp.tmp",
                                "ckpt_00000099.npz.tmp.npz"]
    assert ckpt.latest(tmp_path).endswith("ckpt_00000080.npz")


def test_retention_never_deletes_what_it_just_wrote(tmp_path):
    """A later checkpoint left by another run stays, and so does the one
    just written: retention deletes only checkpoints below it."""
    first = _sim()
    first.run(n_steps=STEPS)
    first.save_checkpoint(tmp_path)
    _sim().run(n_steps=2 * EVERY, checkpoint_every=EVERY,
               checkpoint_dir=str(tmp_path), checkpoint_keep=1)
    assert _names(tmp_path) == ["ckpt_00000032.npz", "ckpt_00000080.npz"]


def test_keep_below_one_raises(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_keep must be at least"):
        _sim().run(n_steps=EVERY, checkpoint_every=EVERY,
                   checkpoint_dir=str(tmp_path), checkpoint_keep=0)
    assert not tmp_path.joinpath("ckpt_00000016.npz").exists()


def test_cli_checkpoint_keep_and_its_closing_line(tmp_path, capsys):
    """--checkpoint-keep 2 leaves the newest two files and prints one line
    with the counts; a run that writes no checkpoint prints none."""
    deck = [os.path.join(ROOT, "data", "input_128x128.params"),
            os.path.join(ROOT, "data", "obstacles_128x128.dat"),
            "--device", "cpu", "--max-iters", "48", "--no-output"]
    ck = tmp_path / "ck"
    assert cli.main([*deck, "--checkpoint-every", "16", "--checkpoint-dir",
                     str(ck), "--checkpoint-keep", "2"]) == 0
    err = capsys.readouterr().err
    assert _names(ck) == ["ckpt_00000032.npz", "ckpt_00000048.npz"]
    line = [s for s in err.splitlines() if s.startswith("checkpoints:")]
    assert len(line) == 1
    # the bytes of the three files: the one removed holds 16 steps of
    # history fewer than the 32's, as the 32's holds fewer than the 48's
    s32, s48 = (os.path.getsize(ck / n) for n in _names(ck))
    mb = (s32 + s48 + 2 * s32 - s48) / 1e6
    assert line[0].startswith(f"checkpoints: 3 written ({mb:.1f} MB), "
                              f"1 removed, ")
    assert "ms in lbm.ckpt.copy" in line[0]
    assert "ms in lbm.ckpt.wait" in line[0]
    assert cli.main(deck) == 0
    assert "checkpoints:" not in capsys.readouterr().err


@pytest.mark.parametrize("keep", [2, None])
def test_expected_steps_is_what_the_program_leaves(tmp_path, plain, keep):
    """The plain rule of which checkpoints remain against the program, over
    runs that end off the cadence and a resume mid-cadence."""
    sim = _sim()
    runs = []
    for n in (20, 12, 30):
        at = sim.step_count
        sim.run(n_steps=n, checkpoint_every=EVERY,
                checkpoint_dir=str(tmp_path), checkpoint_keep=keep)
        runs.append((at, sim.step_count))
    found, other = plain.listing(tmp_path)
    assert sorted(found) == plain.expected_steps(runs, EVERY, keep)
    assert other == []
    assert plain.expected_steps(runs, EVERY) == [16, 20, 32, 48, 62]


# -- the benchmark's ckpt_solve kind, whole, at a tiny size -------------------

SEED = 2**33 + 19


def _cell(tmp_path):
    """The ``ckpt-1024`` cell of BENCHMARK.json on a 48x32 deck: 3 calls
    of 48 steps before the window, a checkpoint every 16 steps, keep 2."""
    from lbmbench import spec

    mask = np.zeros((32, 48), dtype=bool)
    mask[10:14, 8:12] = True
    mask[0] = True
    ys, xs = np.nonzero(mask)
    (tmp_path / "obst.dat").write_text(
        "".join(f"{x} {y} 1\n" for x, y in zip(xs, ys)))
    config = json.loads(open(os.path.join(
        BENCH, "configs", "ref-1024-ckpt.json")).read())
    config.update(nx=48, ny=32, maxIters=48, accel=0.005, max_mlups=50,
                  obstacles=str(tmp_path / "obst.dat"))
    config["checkpoint"] = dict(config["checkpoint"], every=16)
    (tmp_path / "tiny.json").write_text(json.dumps(config))
    traffic = json.loads(open(os.path.join(BENCH, "traffic",
                                           "ckpt.json")).read())
    (tmp_path / "ckpt.json").write_text(json.dumps(
        dict(traffic, trace_seconds=0.2)))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    bench["configs"] = [{"name": "ref-1024-ckpt",
                         "file": str(tmp_path / "tiny.json")}]
    return spec.Cell(bench, "ckpt-1024", traffic_dir=tmp_path)


def _run_cell(tmp_path):
    from lbmbench import cell as cellrun

    return cellrun.run_cell(_cell(tmp_path), SEED, 0.5, False, device="cpu")


def _altered_file(monkeypatch):
    save = ckpt.save

    def altered(directory, step, f, av_vels, params):
        f = np.array(f, copy=True)
        f[1, 5, 7] += 1e-3
        return save(directory, step, f, av_vels, params)

    monkeypatch.setattr(ckpt, "save", altered)


def _no_retention(monkeypatch):
    monkeypatch.setattr(ckpt, "prune", lambda directory, keep, step: 0)


def _whole_history(monkeypatch):
    # the history handed over as the whole preallocated array
    def whole(self, directory, save):
        return save(directory, self.step_count, self._host_state(),
                    self.av_vels, self.params)

    monkeypatch.setattr(Simulation, "_checkpoint", whole)


def _stale_restore(monkeypatch):
    # the resume takes the oldest checkpoint kept, not the newest
    restore = Simulation.restore_checkpoint

    def stale(self, path_or_dir):
        return restore(self, ckpt.complete(path_or_dir)[0][1])

    monkeypatch.setattr(Simulation, "restore_checkpoint", stale)


@pytest.mark.parametrize("fault", [None, _altered_file, _no_retention,
                                   _whole_history, _stale_restore],
                         ids=["sound", "altered_file", "no_retention",
                              "whole_history", "stale_restore"])
def test_the_kind_is_correct_and_each_fault_fails_it(tmp_path, plain,
                                                     monkeypatch, fault):
    """A sound run of the kind reads ``correct`` with no fault; each fault
    planted in the checkpoint path makes it false."""
    if fault is not None:
        fault(monkeypatch)
    result = _run_cell(tmp_path)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) >= {"faults", "state_rel", "av_rel",
                                     "re_rel", "av_head"}
    assert result["correct"] is (fault is None), result["checks"]
    if fault is None:
        assert result["checks"]["faults"]["value"] == 0
        assert result["metrics"]["mlups"]["value"] > 0
