"""The cuda-p2p ring across processes on the CPU: ``make_p2p_runner`` over
a global mesh of four shards, two processes of two shards each and four
of one (gloo at a ``file://`` store, as tests/test_torch_multihost.py
starts its processes), its plain path, whose slabs for another process's
shards go through the transport (``ring_p2p.p2p_chunks_ref``).

Against one process's ``make_p2p_runner`` over the same four shards: the
state and the av series of every call bitwise, for 19 steps a call (two
chunks of 8 and a 3-step remainder), in launches of 64 chunks and of one,
over two calls in a row (the slot parity handed across calls) and a third
from a changed state (a resume). Against the JAX package's
``--backend pallas-rdma`` over 4 virtual CPU devices (the resident-rdma
runner and its remainder, in interpret mode): the tiers of
test_torch_p2p, f atol 1e-7 up to 19 steps and 5e-7 at 38, av rtol 1e-4.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import multihost, runner, sharding
from tpulbm_torch.dist.mesh import get_mesh
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params

# The worker processes import this module: jax is imported only by the
# test that runs the JAX package.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
DECK = "128x128"
N_STEPS = 19
MAX_OUTERS = (64, 1)
SEEDS = (51, 52)      # the first call's state, the resumed one
ENV_KEYS = ("TPULBM_COORDINATOR", "TPULBM_NUM_PROCS", "TPULBM_PROC_ID",
            "TPULBM_LOCAL_SHARDS", "MASTER_ADDR", "MASTER_PORT", "RANK",
            "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _deck():
    p = read_params(ROOT / "data" / f"input_{DECK}.params")
    mask, n_free = read_obstacles(ROOT / "data" / f"obstacles_{DECK}.dat",
                                  p.nx, p.ny)
    return p.with_free_cells(n_free), mask


def _state(p, seed):
    rng = np.random.RandomState(seed)
    return (initial_state(p).numpy()
            * (1 + 0.01 * rng.rand(9, p.ny, p.nx))).astype(np.float32)


def _calls(mesh, transport=None):
    """For each max_outer: three calls of a p2p runner of N_STEPS over
    ``mesh`` (its local shards), the second on the first's output, the
    third from the resumed state: [(the local shards, av)] per call, as
    numpy."""
    p, mask = _deck()
    tr = transport or multihost.Transport(mesh)
    rows, offsets = sharding.ring_rows(p.ny, len(mesh))

    def local(f):
        return [torch.tensor(f[..., offsets[d]:offsets[d] + rows[d], :])
                for d in tr.local]

    out = {}
    for max_outer in MAX_OUTERS:
        run = runner.make_p2p_runner(p, N_STEPS, mesh, tr,
                                     max_outer=max_outer)
        obst = local(mask)
        got = []
        shards = local(_state(p, SEEDS[0]))
        for state in (None, None, SEEDS[1]):
            if state is not None:
                shards = local(_state(p, state))
            shards, av = run(shards, obst)
            got.append(([s.numpy().copy() for s in shards], av.numpy()))
        out[max_outer] = got
    return out


def _worker(out_dir):
    """One process of the group: its shards' results into
    out_dir/rank<r>.npz."""
    multihost.init_distributed("gloo")
    try:
        mesh = multihost.global_ring_mesh(4, "cpu")
        tr = multihost.Transport(mesh)
        arrays = {}
        for max_outer, calls in _calls(mesh, tr).items():
            for c, (shards, av) in enumerate(calls):
                arrays[f"av_{max_outer}_{c}"] = av
                for d, s in zip(tr.local, shards):
                    arrays[f"f_{max_outer}_{c}_{d}"] = s
        np.savez(Path(out_dir) / f"rank{tr.rank}.npz", **arrays)
    finally:
        multihost.shutdown()


@pytest.fixture(scope="module", params=["2x2", "4x1"])
def processes(request, tmp_path_factory):
    """The worker in P processes of L shards (``request.param`` PxL; gloo,
    a file:// store): per max_outer and call, (the gathered state, the av
    series)."""
    procs, per = map(int, request.param.split("x"))
    d = tmp_path_factory.mktemp(f"p2p_{request.param}")
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), str(ROOT / "tests"), env.get("PYTHONPATH"))
        if p),
        TPULBM_COORDINATOR=f"file://{d}/store", TPULBM_NUM_PROCS=str(procs),
        TPULBM_LOCAL_SHARDS=str(per), LOCAL_WORLD_SIZE=str(procs),
        GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    code = ("import sys; from test_torch_p2p_multihost import _worker; "
            "_worker(sys.argv[1])")
    running = [subprocess.Popen([sys.executable, "-c", code, str(d)],
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
    got = {}
    for max_outer in MAX_OUTERS:
        for c in range(3):
            f = np.concatenate([parts[d // per][f"f_{max_outer}_{c}_{d}"]
                                for d in range(4)], axis=1)
            av = parts[0][f"av_{max_outer}_{c}"]
            for part in parts[1:]:
                assert np.array_equal(av, part[f"av_{max_outer}_{c}"])
            got[max_outer, c] = (f, av)
    return got


@pytest.mark.parametrize("max_outer", MAX_OUTERS)
def test_processes_are_one_process_bitwise(processes, max_outer):
    """2 processes x 2 shards, and 4 x 1, against one process's p2p runner
    over the same 4 shards: every call's state and av series bitwise
    (every process holds the same series)."""
    one = _calls(get_mesh(4, device="cpu"))[max_outer]
    for c, (shards, av) in enumerate(one):
        f, av_procs = processes[max_outer, c]
        assert np.array_equal(f, np.concatenate(shards, axis=1)), c
        assert np.array_equal(av_procs, av), c


@pytest.fixture(scope="module")
def jax_calls():
    """The same calls on the JAX package's --backend pallas-rdma over 4
    devices (pallas_resident_rdma for the two 8-step chunks, the ppermute
    K-step kernel for the remainder): the first two calls chained, the
    third from the resumed state; [(f, av)] as numpy."""
    import jax.numpy as jnp

    from tpulbm.core.params import LBMParams as JParams
    from tpulbm.dist.mesh import get_mesh as j_get_mesh
    from tpulbm.dist.runner import make_runner as j_make_runner
    from tpulbm.ops import pallas_resident_rdma

    p, mask = _deck()
    assert pallas_resident_rdma.supported(p.ny // 4, p.nx, 8, 4)
    run = j_make_runner(JParams(**dataclasses.asdict(p)), N_STEPS,
                        j_get_mesh(n_devices=4), backend="pallas-rdma")
    f, out = jnp.asarray(_state(p, SEEDS[0])), []
    for start in (None, None, SEEDS[1]):
        if start is not None:
            f = jnp.asarray(_state(p, start))
        f, av = run(f, jnp.asarray(mask))
        out.append((np.asarray(f), np.asarray(av)))
    return out


def test_processes_match_jax_pallas_rdma(processes, jax_calls):
    """Every call of the processes against the JAX package's pallas-rdma
    (the tiers above: 19 steps, 38, then 19 from the resumed state)."""
    for c, atol in enumerate((1e-7, 5e-7, 1e-7)):
        f, av = jax_calls[c]
        for max_outer in MAX_OUTERS:
            got_f, got_av = processes[max_outer, c]
            np.testing.assert_allclose(got_f, f, rtol=0, atol=atol)
            np.testing.assert_allclose(got_av, av, rtol=1e-4)
