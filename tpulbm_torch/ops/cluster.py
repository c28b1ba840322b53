"""Resident chunks held in a thread block cluster's shared memory: kernel K5.

K5 (``csrc/cluster.cu``) steps a small grid in the shared memory of one
cluster of ``RESIDENT_CLUSTER`` CTAs that read each other's edge rows
through distributed shared memory and step in lockstep behind cluster
barriers, for up to ``resident.RESIDENT_K`` steps:
``cluster_resident_chunk``, a counterpart of
``tpulbm.ops.pallas_resident._kernel`` for the grids one cluster holds.
It is on no route: K2 (``ops.resident``), which spreads the grid over
every SM, measured faster at every shape K5 holds (``PERF.md``), and
``chip_smoke.py`` holds K5's state bitwise K2's.

It returns (f', the (k,) per-step sums of |u| over free cells), reduced in
the kernel from fixed-order partials (``ops.kstep.reduce_partials_ref`` is
the plain version of that epilogue). The wrapper takes its plain PyTorch
version (``cluster_resident_chunk_ref``, ``ops.step_torch.run_sums``) only
when the state lies on the CPU. On a CUDA tensor it launches K5 or raises,
also where the device runs no such cluster; it never falls back to K2 or
the plain version.

``resident_cells`` is the one statement of which grids the cluster holds;
the C entry point refuses what would overrun its window, with the same
constants (``tests/test_torch_cluster.py`` holds the two to each other).
"""

from __future__ import annotations

import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.ops import _build, step_torch
from tpulbm_torch.ops.kstep import check_chunk, into, output

RESIDENT_CLUSTER = 16     # CTAs of the cluster (non-portable size)
RESIDENT_MAX_K = 512      # steps of a launch
# A CTA's window: its band with a halo row and column on each side, in ten
# planes of at most 18 x 260 padded cells (187,200 B of shared memory)
RESIDENT_ROWS, RESIDENT_COLS = 18, 260
# (cells a thread, threads a CTA) of the kernel's two instances
RESIDENT_INSTANCES = ((2, 1024), (8, 512))


def _band_rows(ny: int) -> int:
    """Rows of the widest CTA band."""
    return -(-ny // RESIDENT_CLUSTER)


def resident_cells(ny: int, nx: int) -> int:
    """Cells a thread of the K5 instance that holds the (ny, nx) grid in
    one cluster, or 0 where none does: every CTA has at least 2 rows, its
    band plus halo fits the fixed window, and the band's cells its
    threads' registers."""
    rows = _band_rows(ny)
    if not (ny >= 2 * RESIDENT_CLUSTER and rows + 2 <= RESIDENT_ROWS
            and 1 <= nx and nx + 2 <= RESIDENT_COLS):
        return 0
    for cells, threads in RESIDENT_INSTANCES:
        if rows * nx <= cells * threads:
            return cells
    return 0


def resident_fits(ny: int, nx: int) -> bool:
    """K5 holds the (ny, nx) grid in one cluster."""
    return resident_cells(ny, nx) > 0


def cluster_resident_chunk_ref(f, obst_f, params: LBMParams, k: int,
                               pair_symmetric=True):
    """Plain version of ``cluster_resident_chunk``: k steps, raw sums."""
    return step_torch.run_sums(f, obst_f != 0, params, k, pair_symmetric)


def cluster_resident_chunk(f, obst_f, params: LBMParams, k: int, out=None):
    """k (at most 512) fused steps of the (9, ny, nx) state ``f`` over the
    (ny, nx) float32 mask ``obst_f`` (nonzero = blocked), the grid held in
    one cluster. Returns (f', sums[k]); f' is ``out`` where given
    (``ops.kstep.output``)."""
    if f.device.type == "cpu":
        f, sums = cluster_resident_chunk_ref(f, obst_f, params, k)
        return into(out, f), sums
    return _resident_launch(f, obst_f, params, k, out)[:2]


def _resident_launch(f, obst_f, params: LBMParams, k: int, out=None):
    """K5 on a CUDA state: (f', sums[k], the (k, RESIDENT_CLUSTER) partials
    that its epilogue reduced into sums)."""
    check_chunk(f, obst_f, params, k)
    ny, nx = params.ny, params.nx
    cells = resident_cells(ny, nx)
    if not (cells and k <= RESIDENT_MAX_K):
        raise ValueError(f"K5 holds no ({ny}, {nx}) grid in one cluster for "
                         f"{k} steps")
    lib = _build.library()
    with _build.on_device(f):
        n = lib.lbm_cluster_resident_clusters(cells)
        if n < 1:
            _build.check(-n, f"K5: no cluster of {RESIDENT_CLUSTER} CTAs "
                             f"runs on {f.device}")
        out = output(out, f, f.shape)
        partials = torch.empty((k, RESIDENT_CLUSTER), dtype=torch.float32,
                               device=f.device)
        sums = torch.empty(k, dtype=torch.float32, device=f.device)
        _build.LAUNCHES["cluster_resident"] += 1
        _build.LAUNCHES["reduce_partials"] += 1
        _build.check(
            lib.lbm_cluster_resident(
                f.data_ptr(), obst_f.data_ptr(), out.data_ptr(),
                partials.data_ptr(), sums.data_ptr(), ny, nx, k, cells,
                params.accel_row, params.omega, params.accel_w1,
                params.accel_w2,
                torch.cuda.current_stream(f.device).cuda_stream),
            f"lbm_cluster_resident ({RESIDENT_CLUSTER} CTAs, {cells} cells "
            f"a thread, {lib.lbm_cluster_resident_smem()} B of shared "
            f"memory a CTA)")
    return out, sums, partials
