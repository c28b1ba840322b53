"""The torus's in-kernel exchange across processes on the CPU:
``make_torus_p2p_runner`` over a global torus mesh (gloo at a ``file://``
store, as tests/test_torch_p2p_multihost.py starts its processes), its
plain path, whose pieces of another process's blocks go through the
transport (``ring_p2p.torus_p2p_chunks_ref``): the 128^2 deck over 2x2 as
2 processes x 2 blocks and 4 x 1, and over 2x4 as 4 x 2.

Against one process's ``make_torus_p2p_runner`` over the same blocks: the
state and the av series of every call bitwise, for 19 steps a call (two
chunks of 8 and a 3-step remainder), in launches of 64 chunks and of one,
over two calls in a row (the slot parity handed across calls) and a third
from a changed state (a resume). Against the JAX package's torus on the
virtual CPU mesh: the ``jnp`` torus on the deck, and
``_make_runner_2d_kstep`` (the Pallas x_halo kernel in interpret mode) on
a perturbed 32 x 256 grid over 2x2 (16 x 128 blocks, the narrowest its
tier takes), 19 steps from a given state, with the tiers of
test_torch_torus: f atol 1e-7 up to 25 steps, av rtol 1e-4.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import multihost, runner, sharding
from tpulbm_torch.dist.mesh import get_mesh_2d
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params

# The worker processes import this module: jax is imported only by the
# tests that run the JAX package.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DECK = "128x128"
N_STEPS = 19
MAX_OUTERS = (64, 1)
SEEDS = (61, 62)      # the first call's state, the resumed one
WIDE_SEED = 63        # the 32 x 256 grid's mask and state
ENV_KEYS = ("TPULBM_COORDINATOR", "TPULBM_NUM_PROCS", "TPULBM_PROC_ID",
            "TPULBM_LOCAL_SHARDS", "MASTER_ADDR", "MASTER_PORT", "RANK",
            "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
# (processes x blocks a process, the torus)
LAYOUTS = {"2x2": (2, 2), "4x1": (2, 2), "4x2": (2, 4)}


def _deck():
    p = read_params(ROOT / "data" / f"input_{DECK}.params")
    mask, n_free = read_obstacles(ROOT / "data" / f"obstacles_{DECK}.dat",
                                  p.nx, p.ny)
    return p.with_free_cells(n_free), mask


def _wide():
    """The 32 x 256 grid: a seeded 10 % random mask and a 1 % perturbation
    of the rest state (numpy)."""
    p = LBMParams(nx=256, ny=32, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    rng = np.random.RandomState(WIDE_SEED)
    mask = rng.rand(p.ny, p.nx) < 0.1
    p = p.with_free_cells(p.ny * p.nx - int(mask.sum()))
    f0 = (initial_state(p).numpy()
          * (1 + 0.01 * rng.rand(9, p.ny, p.nx))).astype(np.float32)
    return p, mask, f0


def _state(p, seed):
    rng = np.random.RandomState(seed)
    return (initial_state(p).numpy()
            * (1 + 0.01 * rng.rand(9, p.ny, p.nx))).astype(np.float32)


def _local(mesh, f, mask):
    """This process's blocks of the state and the mask."""
    return sharding.shard_blocks(torch.tensor(f), torch.tensor(mask), mesh)


def _calls(mesh, transport=None):
    """For each max_outer: three calls of a p2p torus runner of N_STEPS
    over ``mesh`` (its local blocks), the second on the first's output, the
    third from the resumed state: [(the local blocks, av)] per call, as
    numpy."""
    p, mask = _deck()
    out = {}
    for max_outer in MAX_OUTERS:
        run = runner.make_torus_p2p_runner(p, N_STEPS, mesh, transport,
                                           max_outer=max_outer)
        blocks, obst = _local(mesh, _state(p, SEEDS[0]), mask)
        got = []
        for state in (None, None, SEEDS[1]):
            if state is not None:
                blocks = _local(mesh, _state(p, state), mask)[0]
            blocks, av = run(blocks, obst)
            got.append(([b.numpy().copy() for b in blocks], av.numpy()))
        out[max_outer] = got
    return out


@functools.lru_cache(maxsize=None)
def _one_process(dy, dx):
    """``_calls`` of one process over the dy x dx torus (shared by the
    layouts of one torus)."""
    return _calls(get_mesh_2d(dy, dx, device="cpu"))


def _wide_call(mesh, transport=None):
    """One call of N_STEPS on the 32 x 256 grid over ``mesh`` (launches of
    one chunk): (the local blocks, av), as numpy."""
    p, mask, f0 = _wide()
    run = runner.make_torus_p2p_runner(p, N_STEPS, mesh, transport,
                                       max_outer=1)
    blocks, av = run(*_local(mesh, f0, mask))
    return [b.numpy() for b in blocks], av.numpy()


def _worker(out_dir, dy, dx):
    """One process of the group: its blocks' results into
    out_dir/rank<r>.npz."""
    multihost.init_distributed("gloo")
    try:
        mesh = multihost.global_torus_mesh(dy, dx, "cpu")
        tr = multihost.Transport([d for row in mesh for d in row])
        arrays = {}
        for max_outer, calls in _calls(mesh, tr).items():
            for c, (blocks, av) in enumerate(calls):
                arrays[f"av_{max_outer}_{c}"] = av
                for b, f in zip(tr.local, blocks):
                    arrays[f"f_{max_outer}_{c}_{b}"] = f
        if (dy, dx) == (2, 2):
            blocks, arrays["av_wide"] = _wide_call(mesh, tr)
            for b, f in zip(tr.local, blocks):
                arrays[f"f_wide_{b}"] = f
        np.savez(Path(out_dir) / f"rank{tr.rank}.npz", **arrays)
    finally:
        multihost.shutdown()


def _gather(parts, per, key, dy, dx):
    """The blocks ``key``_b of every process's npz as one grid."""
    blocks = [torch.from_numpy(parts[b // per][f"{key}_{b}"])
              for b in range(dy * dx)]
    return sharding.gather_blocks(blocks, dy, dx, "cpu").numpy()


@pytest.fixture(scope="module", params=list(LAYOUTS))
def processes(request, tmp_path_factory):
    """The worker in P processes of L blocks (``request.param`` PxL; gloo,
    a file:// store): the torus, and per max_outer and call (the gathered
    state, the av series), and on 2x2 the wide grid's."""
    procs, per = map(int, request.param.split("x"))
    dy, dx = LAYOUTS[request.param]
    d = tmp_path_factory.mktemp(f"torus_{request.param}")
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), str(ROOT / "tests"), env.get("PYTHONPATH"))
        if p),
        TPULBM_COORDINATOR=f"file://{d}/store", TPULBM_NUM_PROCS=str(procs),
        TPULBM_LOCAL_SHARDS=str(per), LOCAL_WORLD_SIZE=str(procs),
        GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    code = ("import sys; from test_torch_torus_p2p_multihost import _worker; "
            "_worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))")
    running = [subprocess.Popen([sys.executable, "-c", code, str(d), str(dy),
                                 str(dx)],
                                env=dict(env, TPULBM_PROC_ID=str(r),
                                         LOCAL_RANK=str(r)),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=ROOT)
               for r in range(procs)]
    try:
        outs = [p.communicate(timeout=240) for p in running]
    finally:
        for p in running:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(running, outs):
        assert p.returncode == 0, err[-3000:]
    parts = [np.load(d / f"rank{r}.npz") for r in range(procs)]
    got = {"mesh": (dy, dx)}
    for max_outer in MAX_OUTERS:
        for c in range(3):
            av = parts[0][f"av_{max_outer}_{c}"]
            for part in parts[1:]:
                assert np.array_equal(av, part[f"av_{max_outer}_{c}"])
            got[max_outer, c] = (_gather(parts, per, f"f_{max_outer}_{c}",
                                         dy, dx), av)
    if (dy, dx) == (2, 2):
        got["wide"] = (_gather(parts, per, "f_wide", dy, dx),
                       parts[0]["av_wide"])
    return got


@pytest.mark.parametrize("max_outer", MAX_OUTERS)
def test_processes_are_one_process_bitwise(processes, max_outer):
    """2 processes x 2 blocks and 4 x 1 of 2x2, and 4 x 2 of 2x4, against
    one process's p2p torus runner over the same blocks: every call's state
    and av series bitwise (every process holds the same series)."""
    dy, dx = processes["mesh"]
    one = _one_process(dy, dx)[max_outer]
    for c, (blocks, av) in enumerate(one):
        f, av_procs = processes[max_outer, c]
        want = sharding.gather_blocks([torch.from_numpy(b) for b in blocks],
                                      dy, dx, "cpu").numpy()
        assert np.array_equal(f, want), c
        assert np.array_equal(av_procs, av), c


def _jp(p):
    from tpulbm.core.params import LBMParams as JParams

    return JParams(**dataclasses.asdict(p))


@functools.lru_cache(maxsize=None)
def _jax_jnp(dy, dx, seed):
    """The JAX jnp torus over dy x dx (ppermute halos, the per-step
    two-phase exchange): N_STEPS of the deck from the seed's state."""
    import jax.numpy as jnp

    from tpulbm.dist.mesh import get_mesh_2d as j_get_mesh_2d
    from tpulbm.dist.runner import make_runner as j_make_runner

    p, mask = _deck()
    run = j_make_runner(_jp(p), N_STEPS, mesh=j_get_mesh_2d(dy, dx),
                        backend="jnp")
    f, av = run(jnp.asarray(_state(p, seed)), jnp.asarray(mask))
    return np.asarray(f), np.asarray(av)


@functools.lru_cache(maxsize=None)
def _jax_x_halo():
    """_make_runner_2d_kstep over 2x2, whose blocks run pallas_kstep._kernel
    with x_halo=True (interpret mode) in its production pair-symmetric
    form: N_STEPS of the wide grid."""
    import jax.numpy as jnp

    from tpulbm.dist import sharding as jsharding
    from tpulbm.dist.mesh import get_mesh_2d as j_get_mesh_2d
    from tpulbm.dist.runner import _make_runner_2d_kstep

    p, mask, f0 = _wide()
    mesh = j_get_mesh_2d(2, 2)
    run = _make_runner_2d_kstep(_jp(p), N_STEPS, mesh, k=8)
    f, av = run(*jsharding.shard_arrays(mesh, jnp.asarray(f0),
                                        jnp.asarray(mask)))
    return np.asarray(f), np.asarray(av)


def test_processes_match_jax_jnp_torus(processes):
    """The first and the resumed call (19 steps each from a given state)
    against the JAX jnp torus over the same mesh."""
    for c, seed in ((0, SEEDS[0]), (2, SEEDS[1])):
        f_j, av_j = _jax_jnp(*processes["mesh"], seed)
        for max_outer in MAX_OUTERS:
            f, av = processes[max_outer, c]
            np.testing.assert_allclose(f, f_j, rtol=0, atol=1e-7)
            np.testing.assert_allclose(av, av_j, rtol=1e-4)


@pytest.mark.parametrize("processes", ["2x2", "4x1"], indirect=True)
def test_processes_match_jax_x_halo_kernel(processes):
    """The wide grid's call over 2x2 (2 processes x 2 blocks, 4 x 1)
    against _make_runner_2d_kstep, and bitwise one process's run."""
    f, av = processes["wide"]
    blocks, av_one = _wide_call(get_mesh_2d(2, 2, device="cpu"))
    one = sharding.gather_blocks([torch.from_numpy(b) for b in blocks], 2, 2,
                                 "cpu").numpy()
    assert np.array_equal(f, one) and np.array_equal(av, av_one)
    f_j, av_j = _jax_x_halo()
    np.testing.assert_allclose(f, f_j, rtol=0, atol=1e-7)
    np.testing.assert_allclose(av, av_j, rtol=1e-4)
