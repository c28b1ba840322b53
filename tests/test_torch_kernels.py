"""The kernel modules of tpulbm_torch (ops.kstep, ops.resident) against the
JAX package's kernels.

On the CPU each wrapper takes its plain PyTorch version (the CUDA kernels
run only on the card; ``chip_smoke.py`` holds them against the same plain
versions there). The JAX side runs its Pallas kernels in interpret mode, as
the JAX package's own CPU tests do, in the production pair-symmetric form
on both sides. Tolerances: over 11-12 steps the two differ by at most 4.1e-8
in f (XLA-CPU rounding, see test_torch_physics) and 1.6e-5 relative in the
per-step av (the summation order of the 16K-cell |u| sums), measured; the
gates are f atol 1e-7 and av rtol 1e-4.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm.core.params import LBMParams as JParams
from tpulbm.core.state import initial_state as j_initial_state
from tpulbm.dist.mesh import get_mesh
from tpulbm.dist.runner import _make_resident_runner, _make_skew_runner
from tpulbm.ops.pallas_resident import supported_hbm
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner as truntime
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import _build, kstep, kstep_tile, resident

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
F_ATOL = 1e-7
AV_RTOL = 1e-4


def _deck(name):
    p = read_params(os.path.join(DATA, f"input_{name}.params"))
    mask, n_free = read_obstacles(
        os.path.join(DATA, f"obstacles_{name}.dat"), p.nx, p.ny)
    return p.with_free_cells(n_free), mask


def _random_case(ny, nx, seed=3, p_block=0.1):
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    mask = np.random.RandomState(seed).rand(ny, nx) < p_block
    return p.with_free_cells(ny * nx - int(mask.sum())), mask


def _jax_run(jrunner, p, mask):
    jp = JParams(**dataclasses.asdict(p))
    f, av = jrunner(j_initial_state(jp), jnp.asarray(mask))
    return np.asarray(f), np.asarray(av)


def _scale(p, sums):
    return sums * torch.tensor(p.free_cells_inv, dtype=torch.float32)


def test_resident_chunk_matches_pallas_resident():
    """resident_chunk (plain on the CPU) vs the VMEM-resident Pallas kernel
    at 128^2, 12 steps in one chunk."""
    p, mask = _deck("128x128")
    n = 12
    f_j, av_j = _jax_run(
        _make_resident_runner(JParams(**dataclasses.asdict(p)), n), p, mask)
    obst_f = torch.tensor(mask, dtype=torch.float32)
    f_t, sums = resident.resident_chunk(initial_state(p), obst_f, p, n)
    assert sums.shape == (n,)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(_scale(p, sums).numpy(), av_j, rtol=AV_RTOL)


def test_resident_chunk_matches_pallas_resident_hbm():
    """resident_chunk vs the HBM-edge resident kernel (_kernel_hbm), which
    the JAX router takes for 100K-135K aligned cells: 256x512, 12 steps."""
    p, mask = _random_case(256, 512, seed=4)
    assert supported_hbm(256, 512)
    n = 12
    f_j, av_j = _jax_run(
        _make_resident_runner(JParams(**dataclasses.asdict(p)), n), p, mask)
    obst_f = torch.tensor(mask, dtype=torch.float32)
    f_t, sums = resident.resident_chunk(initial_state(p), obst_f, p, n)
    np.testing.assert_allclose(f_t.numpy(), f_j, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(_scale(p, sums).numpy(), av_j, rtol=AV_RTOL)


def test_skew_and_kstep_chunks_match_pallas_skew():
    """One skew_chunk (8 steps) plus a 3-step kstep_chunk vs the fused-fix
    skew runner, whose 3-step remainder runs the classic pallas_kstep
    kernel, on a 128x128 random mask."""
    p, mask = _random_case(128, 128)
    n = 11
    f_j, av_j = _jax_run(
        _make_skew_runner(JParams(**dataclasses.asdict(p)), n,
                          get_mesh(n_devices=1)), p, mask)
    obst_f = torch.tensor(mask, dtype=torch.float32)
    f, s8 = kstep.skew_chunk(initial_state(p), obst_f, p)
    f, s3 = kstep.kstep_chunk(f, obst_f, p, 3)
    assert s8.shape == (kstep.SKEW_K,) and s3.shape == (3,)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(_scale(p, torch.cat([s8, s3])).numpy(), av_j,
                               rtol=AV_RTOL)


@pytest.mark.parametrize("deck,n,expect", [
    ("128x128", 40000, [("resident", 512)] * 78 + [("resident", 64)]),
    ("256x256", 1030, [("resident", 512)] * 2 + [("resident", 6)]),
    ("1024x1024", 20000, [("skew", 8)] * 2500),
    ("1024x1024", 1003, [("skew", 8)] * 125 + [("kstep", 3)]),
    ("1024x1024", 5, [("kstep", 5)]),
    ("2048x2048", 4000, [("tile", 8)] * 500),
    ("4096x4096", 2000, [("tile", 8)] * 250),
    ("8192x8192", 1000, [("tile", 8)] * 125),
    ("4096x4096", 1003, [("tile", 8)] * 125 + [("tile", 3)]),
])
def test_kernel_plan_routes_like_the_jax_runner(deck, n, expect):
    """Aligned grids of <= 135K cells -> K2 in 512-step chunks plus a
    remainder (runner.py:1723-1730); the 1-D skew's grids -> K1 in 8-step
    chunks plus a kstep remainder (runner.py:1741-1746); the wide tiers'
    grids (fold, 2-D skew, runner.py:1749-1777) -> K4 in 8-step chunks plus
    a shorter one."""
    p = read_params(os.path.join(DATA, f"input_{deck}.params"))
    names = {resident.resident_chunk: "resident", truntime._skew: "skew",
             kstep.kstep_chunk: "kstep", kstep_tile.tile_chunk: "tile"}
    plan = truntime.kernel_plan(p, n)
    assert [(names[fn], k) for fn, k in plan] == expect
    assert sum(k for _, k in plan) == n


def test_run_plan_matches_plain_runner():
    """The cuda backend's chunk loop (run on the CPU through the wrappers'
    plain versions) reproduces the torch backend's run: same physics, only
    the equilibrium form differs (pair-symmetric vs canonical)."""
    p, mask = _random_case(96, 80, seed=5)
    n = 21
    obst = torch.tensor(mask)
    f_ref, av_ref = truntime.make_runner(p, n, "torch", "cpu")(
        initial_state(p), obst)
    plan = [(truntime._skew, 8), (truntime._skew, 8), (kstep.kstep_chunk, 5)]
    f, av = truntime.run_plan(plan, initial_state(p), obst.float(), p)
    assert av.shape == (n,)
    np.testing.assert_allclose(f.numpy(), f_ref.numpy(), rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(av.numpy(), av_ref.numpy(), rtol=AV_RTOL)


def test_cuda_backend_never_falls_back_to_cpu():
    """backend='cuda' refuses a CPU device and CPU tensors; the kernel
    launchers refuse CPU tensors before touching nvcc."""
    p, mask = _random_case(32, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        truntime.make_runner(p, 8, backend="cuda", device="cpu")
    run = truntime.make_runner(p, 8, backend="cuda", device="cuda")
    with pytest.raises(ValueError, match="got a tensor on cpu"):
        run(initial_state(p), torch.tensor(mask))
    obst_f = torch.tensor(mask, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        kstep._fused_steps(initial_state(p), obst_f, p, 8, "skew_chunk")
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert truntime.resolve_backend("auto", "cpu") == "torch"
    assert truntime.resolve_backend("auto", "cuda") == "cuda"


def test_reduce_partials_plain():
    parts = torch.tensor(np.random.RandomState(1).rand(5, 77),
                         dtype=torch.float32)
    np.testing.assert_allclose(kstep.reduce_partials(parts).numpy(),
                               parts.numpy().sum(axis=1), rtol=1e-6)


def test_nvcc_flags_and_sources():
    """The build covers every .cu of csrc for sm_90a, without fast math."""
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "fused_step.cu", "kstep_tile.cu", "resident.cu"}
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert len(_build.source_hash()) == 16
