"""K-step chunks temporally blocked in shared memory: kernels K4 + K3.

K4 (``csrc/kstep_tile.cu::lbm_kstep_tile``) advances up to ``TILE_K`` steps
in one launch: each CTA loads its tile's window once, steps it in shared
memory and writes the owned tile once. K3 (``ops.kstep.reduce_partials``)
turns its (k, nblocks) per-CTA partials into the (k,) per-step sums of |u|
over the owned free cells. The sums stay on the device; the caller scales
them by ``free_cells_inv``.

- ``tile_chunk`` runs the whole periodic grid: the counterpart of the wide
  tiers of the JAX package, ``pallas_kstep_skew_fold._kernel`` with its
  ``_fix_kernel`` (2048^2, 4096^2), ``pallas_kstep_skew2d._kernel`` with
  ``pallas_kstep_skew._fix_tiled_kernel`` (8192^2) and
  ``pallas_kstep2d._kernel`` (their sub-8-step remainder).
- ``band_chunk`` runs a band of rows that does not wrap: the function of
  the seam fixes (``pallas_kstep_skew_fold._fix_kernel``,
  ``pallas_kstep_skew._fix_kernel`` and ``_fix_tiled_kernel``), and the
  per-shard body of a multi-device ring.

Each wrapper takes its plain PyTorch version (``*_ref``, built on
``ops.step_torch``) only when the state lies on the CPU. On a CUDA tensor it
launches K4 or raises; any other device raises.
"""

from __future__ import annotations

import torch

from tpulbm_torch.core import physics
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.ops import _build, step_torch
from tpulbm_torch.ops.kstep import check_chunk, reduce_partials

TILE_K = 8   # most steps per launch


def tile_chunk_ref(f, obst_f, params: LBMParams, k: int, pair_symmetric=True):
    """Plain version of ``tile_chunk``: k steps, raw per-step sums."""
    return step_torch.run_sums(f, obst_f != 0, params, k, pair_symmetric)


def band_chunk_ref(band, obst_band, params: LBMParams, k: int, row_base: int,
                   pair_symmetric=True):
    """Plain version of ``band_chunk``. The band's rows wrap inside the band
    here, which spoils at most s rows at each end by step s: the kept rows
    [k, rows - k) never see it."""
    rows = band.shape[1]
    h = rows - 2 * k
    blocked = obst_band != 0
    accel = [j for j in range(rows)
             if (row_base + j) % params.ny == params.accel_row]
    f, sums = band, []
    for _ in range(k):
        for j in accel:
            f = step_torch.accelerate(f, blocked, params, row=j)
        out, speed = physics.collide(
            step_torch.pull(f), blocked, params.omega, pair_symmetric)
        f = torch.stack(out)
        sums.append(speed[k:k + h].sum(dtype=torch.float32))
    return f[:, k:k + h].contiguous(), torch.stack(sums)


def tile_chunk(f, obst_f, params: LBMParams, k: int):
    """k <= TILE_K fused steps of the (9, ny, nx) state ``f`` over the
    (ny, nx) float32 mask ``obst_f`` (nonzero = blocked). Returns
    (f', sums[k])."""
    if f.device.type == "cpu":
        return tile_chunk_ref(f, obst_f, params, k)
    check_chunk(f, obst_f, params, k)
    return _launch(f, obst_f, params, k, params.ny, 0, 0, "tile_chunk")


def band_chunk(band, obst_band, params: LBMParams, k: int, row_base: int):
    """k <= TILE_K steps of the (9, h + 2k, nx) ``band`` whose row 0 is
    global row ``row_base`` of the (ny, nx) grid, over its float32 mask
    ``obst_band``. Rows do not wrap, columns do. Returns (the (9, h, nx)
    band rows [k, k + h) after k steps, sums[k] of |u| over those rows)."""
    if band.device.type == "cpu":
        return band_chunk_ref(band, obst_band, params, k, row_base)
    _build.require_cuda(band, obst_band)
    rows = band.shape[1]
    if (band.shape != (9, rows, params.nx)
            or obst_band.shape != (rows, params.nx)):
        raise ValueError(
            f"band {tuple(band.shape)} / mask {tuple(obst_band.shape)} do "
            f"not match a band of the ({params.ny}, {params.nx}) grid")
    if rows <= 2 * k or not 0 <= row_base < params.ny:
        raise ValueError(
            f"band of {rows} rows from row {row_base} cannot keep rows "
            f"after {k} steps")
    return _launch(band, obst_band, params, k, rows - 2 * k, rows, row_base,
                   "band_chunk")


def _launch(src, obst_f, params: LBMParams, k: int, out_rows: int,
            band_rows: int, row_base: int, counter: str):
    if not 1 <= k <= TILE_K:
        raise ValueError(f"K4 takes 1 to {TILE_K} steps, got {k}")
    lib = _build.library()
    nblocks = lib.lbm_kstep_tile_blocks(out_rows, params.nx)
    partials = torch.empty((k, nblocks), dtype=torch.float32,
                           device=src.device)
    out = torch.empty((9, out_rows, params.nx), dtype=torch.float32,
                      device=src.device)
    _build.LAUNCHES[counter] += 1
    _build.check(
        lib.lbm_kstep_tile(
            src.data_ptr(), obst_f.data_ptr(), out.data_ptr(),
            partials.data_ptr(), params.ny, params.nx, params.accel_row,
            params.omega, params.accel_w1, params.accel_w2, k, band_rows,
            row_base, torch.cuda.current_stream(src.device).cuda_stream),
        f"lbm_kstep_tile ({k} steps, {lib.lbm_kstep_tile_smem(k)} B of "
        f"dynamic shared memory)")
    return out, reduce_partials(partials)
