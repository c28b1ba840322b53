"""K5 (``ops.cluster``, ``csrc/cluster.cu``) against the plain version and
the JAX package's kernels, on the CPU.

K5 runs only on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold it against its plain version there); here its wrapper takes its plain
version, and an eager model of its schedule checks what the CUDA source
does that the plain version does not show: ranks stacked in y, each a
window of its band with halo rows that the neighbour ranks push their edge
rows into after every step (the DSMEM stores), every value a step reads
written by the step before (stamped), and the per-step partials in the
kernel's order. Plain float32 arithmetic in the kernel's per-cell order, so
the model's state is bitwise the plain chunk's; its sums differ only by the
summation order (1e-6, as the K4 model of test_torch_wide).

Against the JAX package (Pallas in interpret mode, pair-symmetric on both
sides, as test_torch_kernels): f atol 1e-7, per-step av rtol 1e-4 over 11-12
steps; against the JAX jnp runner (canonical equilibrium) end to end the same
tiers, as test_torch_wide's slice test.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpulbm.core.params import LBMParams as JParams
from tpulbm.core.state import initial_state as j_initial_state
from tpulbm.dist import runner as jrunner
from tpulbm.dist.mesh import get_mesh
from tpulbm_torch.core import physics
from tpulbm_torch.core.lattice import CX, CY
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.core.state import initial_state
from tpulbm_torch.dist import runner as truntime
from tpulbm_torch.io.obstacles import read_obstacles
from tpulbm_torch.io.params_file import read_params
from tpulbm_torch.ops import (_build, cluster, kstep, kstep_tile, resident,
                              ring_p2p, step_torch)

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
F_ATOL = 1e-7
AV_RTOL = 1e-4
SUMS_RTOL = 1e-6


def _case(ny, nx, seed=3, p_block=0.1):
    """A random mask and a 1 % perturbation of the rest state (numpy)."""
    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
                  density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < p_block
    p = p.with_free_cells(ny * nx - int(mask.sum()))
    f0 = (initial_state(p).numpy()
          * (1 + 0.01 * rng.rand(9, ny, nx))).astype(np.float32)
    return p, mask, f0


def _deck(name):
    p = read_params(os.path.join(DATA, f"input_{name}.params"))
    mask, n_free = read_obstacles(
        os.path.join(DATA, f"obstacles_{name}.dat"), p.nx, p.ny)
    return p.with_free_cells(n_free), mask


def _jp(p):
    return JParams(**dataclasses.asdict(p))


def _shfl_tree(v):
    """Lane 0 of the __shfl_down_sync tree over the last axis (32 lanes)."""
    for off in (16, 8, 4, 2, 1):
        v = v + torch.cat([v[..., off:], v[..., 32 - off:]], dim=-1)
    return v[..., 0]


def _partial(speed, threads, cells):
    """A CTA's partial of one step from the |u| of its cells in cell order
    (0 where a cell is not counted): thread t adds its cells t + threads j
    in turn, warp trees, then one warp's tree over the warp sums."""
    x = torch.zeros(cells * threads)
    x[:speed.numel()] = speed.flatten()
    acc = torch.zeros(threads)
    for j in range(cells):
        acc = acc + x[j * threads:(j + 1) * threads]
    warps = _shfl_tree(acc.reshape(threads // 32, 32))
    return _shfl_tree(torch.cat([warps, torch.zeros(32 - warps.numel())]))


def _step(g, blocked, stamp, s, rlo, rhi, xlo, xhi, accel_rows, p):
    """State s + 1 of window g on rows [rlo, rhi) x columns [xlo, xhi):
    (new values, |u|). Every value read must hold state s."""
    assert (stamp[rlo - 1:rhi + 1, xlo - 1:xhi + 1] == s).all(), \
        "a step read a value that the previous step did not write"
    for wy in accel_rows:
        g = step_torch.accelerate(g, blocked, p, row=wy)
    pulled = [g[q, rlo - CY[q]:rhi - CY[q], xlo - CX[q]:xhi - CX[q]]
              for q in range(9)]
    new, speed = physics.collide(pulled, blocked[rlo:rhi, xlo:xhi], p.omega,
                                 True)
    return torch.stack(new), speed


def _band_start(r, ny, c):
    q, m = divmod(ny, c)
    return r * q + min(r, m)


def _resident_model(p, f, o, k, nc=cluster.RESIDENT_CLUSTER):
    """K5: rank r's window is its band with a halo row and a
    halo column on each side; after each step a rank writes its rows and
    halo columns, and pushes its first row into rank r - 1's upper halo row
    and its last into rank r + 1's lower one (periodic over the ranks).
    Returns (state, (k, nc) partials)."""
    ny, nx = p.ny, p.nx
    starts = [_band_start(r, ny, nc) for r in range(nc + 1)]
    rows = [starts[r + 1] - starts[r] for r in range(nc)]
    assert min(rows) >= 2
    cells = cluster.resident_cells(ny, nx)
    threads = dict(cluster.RESIDENT_INSTANCES)[cells]
    assert max(rows) * nx <= cells * threads
    cols = torch.arange(-1, nx + 1) % nx
    win, blk, stamp, acc_rows = [], [], [], []
    for r in range(nc):
        grows = torch.arange(starts[r] - 1, starts[r] + rows[r] + 1) % ny
        win.append(f[:, grows][:, :, cols].clone())
        blk.append(o[grows][:, cols] != 0)
        stamp.append(torch.zeros((rows[r] + 2, nx + 2), dtype=torch.int64))
        acc_rows.append([i for i, g in enumerate(grows.tolist())
                         if g == p.accel_row])
    partials = torch.zeros((k, nc))
    out = torch.empty_like(f)
    for s in range(k):
        new = []
        for r in range(nc):   # every rank reads state s before any write
            vals, speed = _step(win[r], blk[r], stamp[r], s, 1, rows[r] + 1,
                                1, nx + 1, acc_rows[r], p)
            partials[s, r] = _partial(speed, threads, cells)
            new.append(vals)
        for r in range(nc):
            h, v = rows[r], new[r]
            if s == k - 1:
                out[:, starts[r]:starts[r] + h] = v
                continue
            wrapped = torch.cat([v[:, :, -1:], v, v[:, :, :1]], dim=2)
            win[r][:, 1:h + 1] = wrapped
            stamp[r][1:h + 1] = s + 1
            rs, rn = (r - 1) % nc, (r + 1) % nc
            win[rs][:, rows[rs] + 1] = wrapped[:, 0]
            stamp[rs][rows[rs] + 1] = s + 1
            win[rn][:, 0] = wrapped[:, -1]
            stamp[rn][0] = s + 1
    return out, partials


@pytest.mark.parametrize("shape", [(128, 128), (70, 90), (256, 256),
                                   (40, 130)])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_resident_schedule_model(shape, k):
    """The model of K5 on the 128^2 deck's shape (16 ranks of 8 rows, 2
    cells a thread), a ragged 70x90 grid (ranks of 5 and 4 rows), the 256^2
    deck's shape (16 rows a rank, the 8-cell instance) and 40x130, whose
    accelerated row 38 is the first row of rank 15 (a rank edge); against
    cluster_resident_chunk_ref: state bitwise; the partials reduced within
    1e-6 of the plain sums."""
    p, mask, f0 = _case(*shape, seed=30 + k)
    if shape == (40, 130):
        assert p.accel_row == _band_start(15, p.ny, cluster.RESIDENT_CLUSTER)
    f, o = torch.tensor(f0), torch.tensor(mask, dtype=torch.float32)
    out, partials = _resident_model(p, f, o, k)
    f_r, s_r = cluster.cluster_resident_chunk_ref(f, o, p, k)
    assert torch.equal(out, f_r)
    np.testing.assert_allclose(kstep.reduce_partials_ref(partials).numpy(),
                               s_r.numpy(), rtol=SUMS_RTOL)


def test_cluster_resident_chunk_matches_pallas_resident():
    """cluster_resident_chunk (plain on the CPU) vs the VMEM-resident Pallas
    kernel at 128^2, 12 steps in one chunk."""
    p, mask = _deck("128x128")
    n = 12
    f_j, av_j = jrunner._make_resident_runner(_jp(p), n)(
        j_initial_state(_jp(p)), jnp.asarray(mask))
    obst_f = torch.tensor(mask, dtype=torch.float32)
    f, sums = cluster.cluster_resident_chunk(initial_state(p), obst_f, p, n)
    av = sums * torch.tensor(p.free_cells_inv, dtype=torch.float32)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=0,
                               atol=F_ATOL)
    np.testing.assert_allclose(av.numpy(), np.asarray(av_j), rtol=AV_RTOL)


@pytest.mark.parametrize("ny,nx,cells", [
    (128, 128, 2),     # the 128^2 deck: 8 rows a CTA, 1,024 cells
    (128, 256, 2),     # 2,048 cells a CTA
    (256, 256, 8),     # 4,096 cells a CTA
    (256, 512, 0),     # _kernel_hbm's shape: beyond one cluster
])
def test_resident_fits(ny, nx, cells):
    """resident_fits and the instance at the deck shapes and at 256x512,
    none of them on K5's route (K2 takes every resident grid), and the
    edges of the window: 2 rows a CTA, 16 rows, 258 columns."""
    assert cluster.resident_cells(ny, nx) == cells
    assert cluster.resident_fits(ny, nx) is (cells > 0)
    p = LBMParams(nx=nx, ny=ny, max_iters=12, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    assert {fn for fn, _, _ in truntime.kernel_plan(p, 12)} == \
        {resident.resident_chunk}
    assert cluster.resident_fits(32, 128) and not cluster.resident_fits(31, 128)
    assert cluster.resident_fits(256, 16) and not cluster.resident_fits(257, 16)
    assert cluster.resident_fits(32, 258) and not cluster.resident_fits(32, 259)


def test_resident_rule_matches_the_cuda_source():
    """The Python rule (resident_cells) and the C entry point's guard use
    the same constants: cluster size, window, steps, the instances'
    threads."""
    import re

    src = (_build.CSRC / "cluster.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kCluster") == cluster.RESIDENT_CLUSTER
    assert const("kRows") == cluster.RESIDENT_ROWS
    assert const("kW") == cluster.RESIDENT_COLS
    assert const("kMaxK") == cluster.RESIDENT_MAX_K
    assert "cells <= 2 ? 1024 : 512" in src
    assert dict(cluster.RESIDENT_INSTANCES) == {2: 1024, 8: 512}


@pytest.mark.parametrize("ny,nx,n,fn", [
    (64, 128, 20, resident.resident_chunk),
    (100, 130, 11, ring_p2p.grid_p2p_chunks),
])
def test_cluster_slice_matches_jax_runner(ny, nx, n, fn):
    """The slice end to end on the CPU: the cuda backend's plan for a grid
    of the resident family (64x128, one that K5 holds, on K2's route) and
    of the fused family (100x130, off the 8/128 alignment: K6's grid kind),
    run through the wrappers' plain versions, against the JAX package's
    jnp runner from the same rest state."""
    p, mask, _ = _case(ny, nx, seed=ny)
    plan = truntime.kernel_plan(p, n)
    assert {f for f, _, _ in plan} == {fn}
    assert sum(k * c for _, k, c in plan) == n
    f, av = truntime.run_plan(plan, initial_state(p),
                              torch.tensor(mask, dtype=torch.float32), p)
    f_j, av_j = jrunner.make_runner(_jp(p), n, get_mesh(n_devices=1),
                                    backend="jnp")(
        j_initial_state(_jp(p)), jnp.asarray(mask))
    np.testing.assert_allclose(f.numpy(), np.asarray(f_j), rtol=0,
                               atol=F_ATOL)
    np.testing.assert_allclose(av.numpy(), np.asarray(av_j), rtol=AV_RTOL)


def test_cluster_launchers_refuse_cpu_tensors():
    """On a CPU tensor the launcher raises before touching nvcc; the
    wrapper takes its plain version only there."""
    p, mask, f0 = _case(40, 48)
    f, o = torch.tensor(f0), torch.tensor(mask, dtype=torch.float32)
    _build.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        cluster._resident_launch(f, o, p, 3)
    assert _build.LAUNCHES["cluster_resident"] == 0
