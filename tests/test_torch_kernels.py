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
from tpulbm.dist.runner import (_make_resident_runner, _make_skew_runner,
                                make_runner as j_make_runner)
from tpulbm.ops.pallas_resident import supported_hbm
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner as truntime
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import _build, kstep, kstep_tile, resident, ring_p2p

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


def test_tile_chunks_match_pallas_skew():
    """The 1-D skew tier's function on K4: an 8-step tile_chunk plus a 3-step
    one vs the fused-fix skew runner, whose 3-step remainder runs
    pallas_kstep._kernel, on a 128x128 random mask."""
    p, mask = _random_case(128, 128)
    n = 11
    f_j, av_j = _jax_run(
        _make_skew_runner(JParams(**dataclasses.asdict(p)), n,
                          get_mesh(n_devices=1)), p, mask)
    obst_f = torch.tensor(mask, dtype=torch.float32)
    f, s8 = kstep_tile.tile_chunk(initial_state(p), obst_f, p, 8)
    f, s3 = kstep_tile.tile_chunk(f, obst_f, p, 3)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(_scale(p, torch.cat([s8, s3])).numpy(), av_j,
                               rtol=AV_RTOL)


@pytest.mark.parametrize("deck,n,expect", [
    ("128x128", 40000,
     [("resident", 512, 1)] * 78 + [("resident", 64, 1)]),
    ("256x256", 1030, [("resident", 512, 1)] * 2 + [("resident", 6, 1)]),
    ("1024x1024", 20000, [("grid", 8, 64)] * 39 + [("grid", 8, 4)]),
    ("1024x1024", 1003,
     [("grid", 8, 64), ("grid", 8, 61), ("grid", 3, 1)]),
    ("1024x1024", 5, [("grid", 5, 1)]),
    ("2048x2048", 4000, [("grid", 8, 64)] * 7 + [("grid", 8, 52)]),
    # the grid kind's partials a launch are its items' (512 at 8192^2),
    # far under grid_outer_per_launch's 16 MiB: 64 chunks at every deck
    ("4096x4096", 2000, [("grid", 8, 64)] * 3 + [("grid", 8, 58)]),
    ("8192x8192", 1000, [("grid", 8, 64), ("grid", 8, 61)]),
    ("4096x4096", 1003,
     [("grid", 8, 64), ("grid", 8, 61), ("grid", 3, 1)]),
    ((256, 512), 1030, [("resident", 512, 1)] * 2 + [("resident", 6, 1)]),
])
def test_kernel_plan_routes_like_the_jax_runner(deck, n, expect):
    """Aligned grids of <= 135K cells (runner.py:1723-1730) -> K2 (128^2,
    256^2; 256x512, the _kernel_hbm shape), in 512-step chunks plus a
    remainder; the 1-D skew's grids (runner.py:1741-1746) and the wide
    tiers' grids (fold, 2-D skew, runner.py:1749-1777) -> K6's grid kind in
    launches of up to 64 chunks of 8 steps (fewer only where its items'
    partials would pass 16 MiB) plus one launch of a shorter chunk."""
    if isinstance(deck, tuple):
        p = LBMParams(nx=deck[1], ny=deck[0], max_iters=n, reynolds_dim=10,
                      density=0.1, accel=0.005, omega=1.85)
    else:
        p = read_params(os.path.join(DATA, f"input_{deck}.params"))
    names = {resident.resident_chunk: "resident",
             ring_p2p.grid_p2p_chunks: "grid"}
    plan = truntime.kernel_plan(p, n)
    assert [(names[fn], k, c) for fn, k, c in plan] == expect
    assert sum(k * c for _, k, c in plan) == n


@pytest.mark.parametrize("ny,nx,n,fn", [
    (64, 128, 20, resident.resident_chunk),
    (100, 130, 11, ring_p2p.grid_p2p_chunks),
])
def test_plan_slice_matches_jax_runner(ny, nx, n, fn):
    """The slice end to end on the CPU: the cuda backend's plan for a grid
    inside the resident gate (64x128: K2) and for one outside it (100x130,
    off the 8/128 alignment: K6's grid kind), run through the wrappers'
    plain versions, against the JAX package's jnp runner from the same
    rest state."""
    p, mask = _random_case(ny, nx, seed=ny)
    plan = truntime.kernel_plan(p, n)
    assert {f for f, _, _ in plan} == {fn}
    assert sum(k * c for _, k, c in plan) == n
    f, av = truntime.run_plan(plan, initial_state(p),
                              torch.tensor(mask, dtype=torch.float32), p)
    f_j, av_j = _jax_run(j_make_runner(JParams(**dataclasses.asdict(p)), n,
                                       get_mesh(n_devices=1), backend="jnp"),
                         p, mask)
    np.testing.assert_allclose(f.numpy(), f_j, rtol=0, atol=F_ATOL)
    np.testing.assert_allclose(av.numpy(), av_j, rtol=AV_RTOL)


def test_run_plan_matches_plain_runner():
    """The cuda backend's chunk loop (run on the CPU through the wrappers'
    plain versions) reproduces the torch backend's run: same physics, only
    the equilibrium form differs (pair-symmetric vs canonical)."""
    p, mask = _random_case(96, 80, seed=5)
    n = 21
    obst = torch.tensor(mask)
    f_ref, av_ref = truntime.make_runner(p, n, "torch", "cpu")(
        initial_state(p), obst)
    plan = [(truntime._skew, 8, 1), (truntime._skew, 8, 1),
            (kstep.kstep_chunk, 5, 1)]
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


# The stepping kernels' epilogue (csrc/lbm_cell.cuh::reduce_row and
# reduce_rows, the former K3): its sums against the plain version within
# chip_smoke.py's K3_RTOL (float32 sums of up to 65,536 partials in another
# order; measured 1.2e-7 on the card).
K3_RTOL = 1e-6


def _shfl_tree(v):
    """Lane 0 of the __shfl_down_sync tree over the last axis (32 lanes); a
    lane whose source lane is past 31 reads its own value."""
    for off in (16, 8, 4, 2, 1):
        v = v + np.concatenate([v[..., off:], v[..., 32 - off:]], axis=-1)
    return v[..., 0]


def epilogue_model(partials: np.ndarray, block_threads: int) -> np.ndarray:
    """The epilogue's fixed order in numpy float32, per row: thread i < 256
    sums j = i, i + 256, ... in order (threads past 256 hold 0), warp trees,
    then one warp's tree over the warp sums (lanes past the block's warps
    hold 0). A block of any size gives the same bits."""
    k, n = partials.shape
    acc = np.zeros((k, block_threads), np.float32)
    for j in range(0, n, 256):
        cols = partials[:, j:j + 256]
        acc[:, :cols.shape[1]] += cols
    warps = _shfl_tree(acc.reshape(k, block_threads // 32, 32))
    lanes = np.zeros((k, 32), np.float32)
    lanes[:, :warps.shape[1]] = warps
    return _shfl_tree(lanes)


def test_reduce_partials_plain():
    """The epilogue's plain version: one float32 sum per row."""
    parts = torch.tensor(np.random.RandomState(1).rand(5, 77),
                         dtype=torch.float32)
    got = kstep.reduce_partials_ref(parts)
    assert got.dtype == torch.float32 and got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), parts.numpy().sum(axis=1),
                               rtol=1e-6)


@pytest.mark.parametrize("k,n", [(8, 4096), (8, 65536), (3, 1000), (1, 7)])
def test_epilogue_order_matches_the_plain_sum(k, n):
    """The epilogue's fixed order against reduce_partials_ref within
    K3_RTOL at the partials' shapes of the main path (K1 at 1024^2, K4 at
    8192^2, a ragged remainder); bitwise the same on a rerun and for blocks
    of 256 (K1, K2) and 768 threads (K4)."""
    parts = np.random.RandomState(k + n).rand(k, n).astype(np.float32)
    got = epilogue_model(parts, 256)
    want = kstep.reduce_partials_ref(torch.tensor(parts)).numpy()
    np.testing.assert_allclose(got, want, rtol=K3_RTOL)
    assert np.array_equal(got, epilogue_model(parts, 256))
    assert np.array_equal(got, epilogue_model(parts, 768))


def test_nvcc_flags_and_sources():
    """The build covers every .cu of csrc for sm_90a, without fast math."""
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "fused_step.cu", "kstep_tile.cu", "resident.cu", "ring_p2p.cu"}
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert len(_build.source_hash()) == 16


def test_kernel_ab_imports_another_tree_beside_this_one():
    """tools.kernel_ab imports another tree's ops modules beside this
    process's (here this tree again, from its root): distinct module
    objects with their own build module, this process's modules put back,
    and the other tree's chunk functions giving this tree's results on a
    CPU grid (their plain versions)."""
    import sys

    from tpulbm_torch.tools import kernel_ab

    def ours():
        return {n: m for n, m in sys.modules.items()
                if n.startswith("tpulbm_torch")}

    before = ours()
    other = kernel_ab.import_tree(kernel_ab.ROOT)
    assert ours() == before
    assert set(other) == set(kernel_ab.OPS)
    assert other["kstep_tile"] is not kstep_tile
    assert other["kstep_tile"]._build is other["_build"] is not _build
    p, mask = _random_case(40, 70, seed=5)
    f0 = initial_state(p) * (1 + 0.01 * torch.tensor(
        np.random.RandomState(6).rand(9, p.ny, p.nx), dtype=torch.float32))
    o = torch.tensor(mask, dtype=torch.float32)
    for mine, theirs in ((kstep_tile.tile_chunk(f0, o, p, 3),
                          other["kstep_tile"].tile_chunk(f0, o, p, 3)),
                         (kstep.skew_chunk(f0, o, p),
                          other["kstep"].skew_chunk(f0, o, p))):
        assert torch.equal(mine[0], theirs[0])
        assert torch.equal(mine[1], theirs[1])
