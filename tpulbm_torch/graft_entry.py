"""Driver hooks of the port: the counterpart of ``__graft_entry__.py``.

- ``entry(device="cuda")``: ``(fn, args)``, one runner call of the small
  problem of ``__graft_entry__.py:19-46`` (64 x 128, 4 steps) on the
  card's kernel route (``dist.runner.kernel_plan``).
- ``dryrun_multichip(n, device="cuda")``: every multi-device path of the
  port on n shards: the ring (K4 ring mode) and ``--backend cuda-p2p`` (K6,
  the slabs handed between shards inside the kernel), an uneven ring, the
  torus (K4 torus mode), a dcp save and restore, and a real two-process
  group through the CLI (``dist.launch --local-smoke``).
  Every av series is certified against the single-device plain PyTorch
  oracle (``ops.step_torch``) at rtol 5e-5, as ``_assert_av_matches`` of
  ``__graft_entry__.py:123-145`` does: the kernels use the pair-symmetric
  equilibrium, the oracle the canonical one. ``device="cpu"`` runs the
  same paths on CPU shards, where the kernel wrappers take their plain
  versions and the processes meet over gloo.

    python -m tpulbm_torch.graft_entry [N] [--device cpu]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner, sharding
from tpulbm_torch.dist.mesh import get_mesh, get_mesh_2d
from tpulbm_torch.ops import kstep_tile, step_torch

ROOT = Path(__file__).resolve().parents[1]
RTOL = 5e-5


def _small_problem(ny: int, nx: int, device, max_iters: int = 4):
    params = LBMParams(nx=nx, ny=ny, max_iters=max_iters, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    mask = np.random.RandomState(0).rand(ny, nx) < 0.05
    params = params.with_free_cells(ny * nx - int(mask.sum()))
    return (params, initial_state(params, device),
            torch.as_tensor(mask, device=device))


def entry(device="cuda"):
    """(fn, args): fn(*args) runs the 4 steps of the 64 x 128 problem on
    the kernel route, returning (f', av_vels)."""
    params, f, obst = _small_problem(64, 128, device)
    plan = runner.kernel_plan(params, params.max_iters)

    def fwd(f, obst_f):
        return runner.run_plan(plan, f, obst_f, params)

    return fwd, (f, obst.to(torch.float32))


def _assert_av_matches(tag, av, params, mask, n_steps, device):
    """Certify an av series against the single-device plain oracle."""
    oracle = step_torch.run_steps(initial_state(params, device),
                                  torch.as_tensor(mask, device=device),
                                  params, n_steps)[1].cpu().numpy()
    av = np.asarray(av)
    assert av.shape == oracle.shape, (tag, av.shape, oracle.shape)
    assert np.all(np.isfinite(av)), f"{tag}: non-finite av values"
    rel = float(np.max(np.abs(av - oracle)
                       / np.maximum(np.abs(oracle), 1e-30)))
    maxd = float(np.max(np.abs(av - oracle)))
    assert rel <= RTOL, (
        f"{tag}: av series diverges from the single-device oracle (max rel "
        f"diff {rel:.3e} > {RTOL:g}, max abs {maxd:.3e})")
    print(f"{tag} ok: av matches oracle (max|d|={maxd:.3e}, rel={rel:.2e})",
          flush=True)


def _ring(params, n_steps, mesh, backend="cuda"):
    """The kernel route's ring: make_runner on the card; on CPU shards the
    same runners (make_ring_runner over ring_chunk, make_p2p_runner), whose
    kernel wrappers take their plain versions there."""
    if mesh[0].type == "cuda" or len(mesh) == 1:
        return runner.make_runner(params, n_steps, backend, mesh[0],
                                  mesh=mesh)
    if backend == "cuda-p2p":
        return runner.make_p2p_runner(params, n_steps, mesh)
    return runner.make_ring_runner(params, n_steps, mesh,
                                   kstep_tile.ring_chunk)


def _run_mesh(params, f, obst, run, mesh):
    if isinstance(mesh[0], list):
        fs, obs = sharding.shard_blocks(f, obst, mesh)
    elif len(mesh) > 1:
        fs, obs = sharding.shard_rows(f, obst, mesh)
    else:
        return run(f, obst)
    return run(fs, obs)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run and certify every multi-device path of the port on
    ``n_devices`` shards (see the module docstring)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip(device='cuda') needs a CUDA "
                           "device (pass device='cpu' for the plain path)")
    n, tag = n_devices, f"dryrun_multichip({n_devices})"
    mesh = get_mesh(n, device=device)
    cpu = mesh[0].type == "cpu"
    params, f, obst = _small_problem(8 * n, 128, device, 12)
    for backend in ("cuda",) + (("cuda-p2p",) if n > 1 else ()):
        _, av = _run_mesh(params, f.clone(), obst,
                          _ring(params, 12, mesh, backend), mesh)
        name = "ring" if backend == "cuda" else "ring --backend cuda-p2p"
        _assert_av_matches(f"{tag} {name}", av.cpu(), params, obst.cpu(),
                           12, device)
    if n < 2:
        return

    # an uneven ring: ny = 8n + 3 rows, decompose_rows' remainder split
    params_u, f_u, obst_u = _small_problem(8 * n + 3, 128, device, 12)
    _, av = _run_mesh(params_u, f_u, obst_u, _ring(params_u, 12, mesh), mesh)
    rows = sharding.ring_rows(params_u.ny, n)[0]
    _assert_av_matches(f"{tag} uneven ring {'/'.join(map(str, rows))}",
                       av.cpu(), params_u, obst_u.cpu(), 12, device)

    # the torus: 2 x n/2 blocks of 8 x 64, or n x 1 for an odd n
    dy, dx = (2, n // 2) if n % 2 == 0 else (n, 1)
    mesh2d = get_mesh_2d(dy, dx, device=device)
    params_t, f_t, obst_t = _small_problem(8 * dy, 64 * dx, device, 12)
    run_t = (runner.make_torus_runner(params_t, 12, mesh2d,
                                      kstep_tile.torus_chunk) if cpu
             else runner.make_runner(params_t, 12, "cuda", mesh=mesh2d))
    _, av = _run_mesh(params_t, f_t, obst_t, run_t, mesh2d)
    _assert_av_matches(f"{tag} torus {dy}x{dx}", av.cpu(), params_t,
                       obst_t.cpu(), 12, device)

    # dcp: a ring saves at step 8; a new Simulation restores and finishes,
    # bitwise the uninterrupted run (both run 8-step chunks: on the card the
    # in-kernel sums of a chunk depend on its step count)
    from tpulbm_torch.sim.simulation import Simulation

    params_d, _, obst_d = _small_problem(8 * n, 128, device, 16)
    mask = obst_d.cpu().numpy()

    def sim():
        return Simulation(params_d, mask, device=device, mesh=mesh,
                          ckpt_backend="dcp")

    straight = sim()
    straight.run()
    with tempfile.TemporaryDirectory() as td:
        first = sim()
        first.run(n_steps=8)
        path = first.save_checkpoint(td)
        resumed = sim()
        resumed.restore_checkpoint(path)
        resumed.run()
    assert torch.equal(resumed.f, straight.f), f"{tag} dcp: state differs"
    assert np.array_equal(resumed.av_vels, straight.av_vels), (
        f"{tag} dcp: av series differs")
    _assert_av_matches(f"{tag} dcp save/restore at step 8", resumed.av_vels,
                       params_d, mask, 16, device)

    # a real two-process group through the CLI against one process driving
    # the same shards: the same bytes
    _two_processes(tag, max(1, n // 2), device)


def _two_processes(tag, per: int, device) -> None:
    from tpulbm_torch import cli
    from tpulbm_torch.io.obstacles import read_obstacles
    from tpulbm_torch.io.params_file import read_params

    pf, of = (str(ROOT / "data" / f"{k}_128x128.{e}")
              for k, e in (("input", "params"), ("obstacles", "dat")))
    steps = ["--device", str(torch.device(device).type), "--max-iters", "20"]
    with tempfile.TemporaryDirectory() as td:
        two, one = os.path.join(td, "two"), os.path.join(td, "one")
        proc = subprocess.run(
            [sys.executable, "-m", "tpulbm_torch.dist.launch",
             "--local-smoke", f"2x{per}", "--timeout", "300", pf, of, *steps,
             "--out-dir", two],
            capture_output=True, text=True, cwd=ROOT, timeout=360)
        if proc.returncode != 0:
            raise RuntimeError(f"{tag}: the 2-process run failed:\n"
                               + proc.stderr[-2000:])
        import contextlib
        import io

        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main([pf, of, *steps, "--device-count", str(2 * per),
                           "--out-dir", one])
        assert rc == 0, f"{tag}: the one-process run failed"
        for name in ("final_state.dat", "av_vels.dat"):
            with open(os.path.join(two, name), "rb") as a, \
                    open(os.path.join(one, name), "rb") as b:
                assert a.read() == b.read(), (
                    f"{tag}: 2 processes x {per} shards wrote another "
                    f"{name} than one process of {2 * per} shards")
        av = np.loadtxt(os.path.join(two, "av_vels.dat"), usecols=[1],
                        dtype=np.float32)
    params = read_params(pf)
    mask, n_free = read_obstacles(of, params.nx, params.ny)
    _assert_av_matches(
        f"{tag} 2 processes x {per} shards (the same bytes as one process)",
        av, params.with_free_cells(n_free), mask, 20, device)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args()
    fn, args = entry(a.device)
    fn(*args)
    print("entry ok", flush=True)
    dryrun_multichip(a.n, a.device)
