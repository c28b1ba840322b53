"""K-step chunks temporally blocked in shared memory: kernel K4.

K4 (``csrc/kstep_tile.cu::lbm_kstep_tile``) advances up to ``TILE_K`` steps
in one launch: persistent CTAs walk the 32 x 32 tiles, each loading a tile's
window once (the next one's while it steps this one), stepping it in shared
memory and writing the owned tile once. The last CTA to finish turns the
(k, ntiles) per-tile partials into the (k,) per-step sums of |u| over the
owned free cells (``ops.kstep.reduce_partials_ref`` is the plain version of
that epilogue). The sums stay on the device; the caller scales them by
``free_cells_inv``.

- ``tile_chunk`` runs the whole periodic grid: the counterpart of the wide
  tiers of the JAX package, ``pallas_kstep_skew_fold._kernel`` with its
  ``_fix_kernel`` (2048^2, 4096^2), ``pallas_kstep_skew2d._kernel`` with
  ``pallas_kstep_skew._fix_tiled_kernel`` (8192^2) and
  ``pallas_kstep2d._kernel`` (their sub-8-step remainder). Off the route:
  K6's grid kind (``ops.ring_p2p.grid_p2p_chunks``) runs these grids many
  chunks a launch, and ``tile_chunk`` chunk by chunk is the bitwise
  reference of its state.
- ``ring_chunk`` runs one shard of the 1-D ring (``dist.runner``): the band
  of its rows and the k-row slabs of its two neighbours, passed as three
  tensors. It computes what every ring tier of the JAX package computes on
  a device between two slab exchanges (the skew, fold, 2-D skew, K-step
  and bands kernels, and ``pallas_step._kernel`` at k = 1; the
  in-kernel-exchange kernels' chunks too, whose exchange K6 runs,
  ``ops.ring_p2p``). A band of rows around a seam, cut into lo, shard and
  hi, gives the function of the seam fixes
  (``pallas_kstep_skew_fold._fix_kernel``, ``pallas_kstep_skew._fix_kernel``
  and ``_fix_tiled_kernel``).
- ``torus_chunk`` runs one (h, w) block of the 2-D torus (``dist.runner``):
  the block, its column neighbours' k columns (``xlo``, ``xhi``, padded to
  ``col_margin(k)`` columns) and its row neighbours' corner-carrying k-row
  slabs of their x-extended bands (``ylo``, ``yhi``), five tensors. It
  computes what ``pallas_kstep._kernel`` computes with ``x_halo=True`` on a
  device of the JAX package's torus between two exchanges.

Each wrapper takes its plain PyTorch version (``*_ref``, built on
``ops.step_torch``) only when the state lies on the CPU. On a CUDA tensor it
launches K4 or raises; any other device raises. Given ``out``, a wrapper
writes the new state there (``ops.kstep.output``): the runners pass the
storage that the chunk before released.
"""

from __future__ import annotations

import torch

from tpulbm_torch.core import physics
from tpulbm_torch.core.lattice import CX, CY, NSPEEDS
from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.ops import _build, step_torch
from tpulbm_torch.ops.kstep import check_chunk, into, output

TILE_K = 8   # most steps per launch


def col_margin(k: int) -> int:
    """Columns of a torus chunk's x slabs: k rounded up to a multiple of 4
    (``csrc/kstep_tile.cu::col_margin``), so that every piece of a band row
    starts 16-byte aligned."""
    return (k + 3) // 4 * 4


def tile_chunk_ref(f, obst_f, params: LBMParams, k: int, pair_symmetric=True):
    """Plain version of ``tile_chunk``: k steps, raw per-step sums."""
    return step_torch.run_sums(f, obst_f != 0, params, k, pair_symmetric)


def rows_sum(speed, first: int, h: int):
    """The float32 sum of |u| over rows [first, first + h) of ``speed``: a
    step's sum in the plain band and ring chunks, taken on a fresh
    contiguous (h, nx) copy, so that both reduce the same values in the same
    layout."""
    return speed[first:first + h].clone().sum(dtype=torch.float32)


def band_chunk_ref(band, obst_band, params: LBMParams, k: int, row_base: int,
                   pair_symmetric=True):
    """k steps of the (9, h + 2k, nx) ``band`` whose row 0 is global row
    ``row_base``: its rows [k, k + h) after k steps and their per-step sums,
    a plain reference for ``ring_chunk`` on the band cut into lo, shard and
    hi. The band's rows wrap inside the band here, which spoils at most s
    rows at each end by step s: the kept rows never see it."""
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
        sums.append(rows_sum(speed, k, h))
    return f[:, k:k + h].contiguous(), torch.stack(sums)


def ring_chunk_ref(lo, shard, hi, obst_band, params: LBMParams, k: int,
                   row_base: int, pair_symmetric=True):
    """Plain version of ``ring_chunk``. The band lo + shard + hi shrinks by
    one row at each end per step: the rows whose pull would reach past the
    band are dropped, so no row wraps and the last step leaves the shard's
    rows."""
    h = shard.shape[1]
    blocked = obst_band != 0
    f, sums = torch.cat([lo, shard, hi], dim=1), []
    for s in range(k):
        rows = f.shape[1]                  # h + 2(k - s); row 0 is band row s
        b = blocked[s:s + rows]
        for j in range(rows):
            if (row_base + s + j) % params.ny == params.accel_row:
                f = step_torch.accelerate(f, b, params, row=j)
        pulled = [torch.roll(f[q, 1 - CY[q]:rows - 1 - CY[q]], CX[q], dims=1)
                  for q in range(NSPEEDS)]
        out, speed = physics.collide(pulled, b[1:rows - 1], params.omega,
                                     pair_symmetric)
        f = torch.stack(out)
        own = k - s - 1                    # the shard's first row in f
        sums.append(rows_sum(speed, own, h))
    return f, torch.stack(sums)


def torus_band(xlo, block, xhi, ylo, yhi, k: int):
    """The (..., h + 2k, w + 2k) band of a torus chunk from its five
    pieces: ylo over xlo | block | xhi over yhi, without the x slabs'
    padding. The leading axes are free: a state's nine planes, or none
    for a mask."""
    kx, w = col_margin(k), block.shape[-1]
    cols = slice(kx - k, kx + w + k)
    mid = torch.cat([xlo[..., kx - k:], block, xhi[..., :k]], dim=-1)
    return torch.cat([ylo[..., cols], mid, yhi[..., cols]], dim=-2)


def torus_chunk_ref(xlo, block, xhi, ylo, yhi, obst_band, params: LBMParams,
                    k: int, row_base: int, pair_symmetric=True):
    """Plain version of ``torus_chunk``. The band (``torus_band``) shrinks
    by one row and one column at each side per step: the cells whose pull
    would reach past the band are dropped, so nothing wraps and the last
    step leaves the block's cells."""
    h, w = block.shape[1:]
    kx = col_margin(k)
    blocked = obst_band[:, kx - k:kx + w + k] != 0
    f, sums = torus_band(xlo, block, xhi, ylo, yhi, k), []
    for s in range(k):
        rows, cols = f.shape[1:]     # row 0, column 0: band row, column s
        b = blocked[s:s + rows, s:s + cols]
        for j in range(rows):
            if (row_base + s + j) % params.ny == params.accel_row:
                f = step_torch.accelerate(f, b, params, row=j)
        pulled = [f[q, 1 - CY[q]:rows - 1 - CY[q], 1 - CX[q]:cols - 1 - CX[q]]
                  for q in range(NSPEEDS)]
        out, speed = physics.collide(pulled, b[1:rows - 1, 1:cols - 1],
                                     params.omega, pair_symmetric)
        f = torch.stack(out)
        own = k - s - 1              # the block's first row and column in f
        sums.append(speed[own:own + h, own:own + w].clone().sum(
            dtype=torch.float32))
    return f, torch.stack(sums)


def torus_pieces(f, obst_f, i0: int, j0: int, h: int, w: int, k: int):
    """``torus_chunk``'s arguments for the (h, w) block at row i0, column j0
    of the whole periodic (9, ny, nx) state ``f`` and its (ny, nx) float
    mask, cut from the grid (both axes wrap) as the torus's exchange leaves
    them, zeros in the x slabs' padding: (xlo, block, xhi, ylo, yhi,
    obst_band, row_base). For checks of one block against its plain
    version or the whole grid."""
    ny, nx = obst_f.shape
    kx = col_margin(k)
    rows = torch.arange(i0 - k, i0 + h + k, device=f.device) % ny
    cols = torch.arange(j0 - kx, j0 + w + kx, device=f.device) % nx
    band = f[:, rows][:, :, cols].contiguous()
    ob = obst_f[rows][:, cols].contiguous()
    for t in (band, ob):
        t[..., :kx - k] = 0
        t[..., kx + w + k:] = 0
    mid = band[:, k:k + h]
    return (mid[:, :, :kx].contiguous(), mid[:, :, kx:kx + w].contiguous(),
            mid[:, :, kx + w:].contiguous(), band[:, :k].contiguous(),
            band[:, k + h:].contiguous(), ob, (i0 - k) % ny)


def tile_chunk(f, obst_f, params: LBMParams, k: int, out=None):
    """k <= TILE_K fused steps of the (9, ny, nx) state ``f`` over the
    (ny, nx) float32 mask ``obst_f`` (nonzero = blocked). Returns
    (f', sums[k])."""
    if f.device.type == "cpu":
        f, sums = tile_chunk_ref(f, obst_f, params, k)
        return into(out, f), sums
    return _tile_launch(f, obst_f, params, k, out)[:2]


def _tile_launch(f, obst_f, params: LBMParams, k: int, out=None):
    """K4 whole grid on a CUDA state: (f', sums[k], the (k, ntiles)
    partials that its epilogue reduced into sums)."""
    check_chunk(f, obst_f, params, k)
    if not 1 <= k <= TILE_K:
        raise ValueError(f"K4 takes 1 to {TILE_K} steps, got {k}")
    lib = _build.library()
    with _build.on_device(f):
        out, partials, sums = _outputs(lib, f, k, params.ny, params.nx, out)
        _build.LAUNCHES["tile_chunk"] += 1
        _build.LAUNCHES["reduce_partials"] += 1
        _build.check(
            lib.lbm_kstep_tile(
                f.data_ptr(), obst_f.data_ptr(), out.data_ptr(),
                partials.data_ptr(), sums.data_ptr(),
                _build.ticket_counter(f.device).data_ptr(), params.ny,
                params.nx, params.accel_row, params.omega, params.accel_w1,
                params.accel_w2, k,
                torch.cuda.current_stream(f.device).cuda_stream),
            _what(lib, k))
    return out, sums, partials


def ring_chunk(lo, shard, hi, obst_band, params: LBMParams, k: int,
               row_base: int, out=None):
    """k <= TILE_K steps of the (9, h, nx) ``shard`` of the ring, whose band
    of h + 2k rows is ``lo`` (9, k, nx: the previous shard's last rows),
    the shard and ``hi`` (9, k, nx: the next shard's first rows); band row
    0 is global row ``row_base`` of the (ny, nx) grid and ``obst_band`` the
    band's (h + 2k, nx) float32 mask. Columns wrap, rows do not. Returns
    (the (9, h, nx) shard after k steps, sums[k] of |u| over its rows)."""
    if shard.device.type == "cpu":
        f, sums = ring_chunk_ref(lo, shard, hi, obst_band, params, k,
                                 row_base)
        return into(out, f), sums
    return _ring_launch(lo, shard, hi, obst_band, params, k, row_base,
                        out)[:2]


def _ring_launch(lo, shard, hi, obst_band, params: LBMParams, k: int,
                 row_base: int, out=None):
    """K4 ring mode on CUDA tensors: (the shard after k steps, sums[k], the
    (k, ntiles) partials that its epilogue reduced into sums)."""
    _build.require_cuda(lo, shard, hi, obst_band)
    h, nx = shard.shape[1], params.nx
    if (not 1 <= k <= TILE_K or shard.shape != (9, h, nx)
            or lo.shape != (9, k, nx) or hi.shape != (9, k, nx)
            or obst_band.shape != (h + 2 * k, nx)
            or not 0 <= row_base < params.ny):
        raise ValueError(
            f"ring chunk of {k} steps: slabs {tuple(lo.shape)}, "
            f"{tuple(hi.shape)}, shard {tuple(shard.shape)}, mask "
            f"{tuple(obst_band.shape)}, row {row_base} do not fit the "
            f"({params.ny}, {nx}) grid")
    lib = _build.library()
    with _build.on_device(shard):
        out, partials, sums = _outputs(lib, shard, k, h, nx, out)
        _build.LAUNCHES["ring_chunk"] += 1
        _build.LAUNCHES["reduce_partials"] += 1
        _build.check(
            lib.lbm_kstep_tile_ring(
                lo.data_ptr(), shard.data_ptr(), hi.data_ptr(),
                obst_band.data_ptr(), out.data_ptr(), partials.data_ptr(),
                sums.data_ptr(),
                _build.ticket_counter(shard.device).data_ptr(), params.ny,
                nx, params.accel_row, params.omega, params.accel_w1,
                params.accel_w2, k, h, row_base,
                torch.cuda.current_stream(shard.device).cuda_stream),
            _what(lib, k))
    return out, sums, partials


def torus_chunk(xlo, block, xhi, ylo, yhi, obst_band, params: LBMParams,
                k: int, row_base: int, out=None):
    """k <= TILE_K steps of the (9, h, w) ``block`` of the torus. With kx =
    ``col_margin(k)``: ``xlo`` and ``xhi`` (9, h, kx) hold the left
    neighbour's last k columns in their last k columns and the right
    neighbour's first k columns in their first k; ``ylo`` and ``yhi``
    (9, k, w + 2kx) are the last and first k rows of the row neighbours'
    x-extended bands (xlo | block | xhi), corners included; ``obst_band``
    is the (h + 2k, w + 2kx) float32 mask of the band they make; band row 0
    is global row ``row_base``. Nothing wraps. Returns (the (9, h, w) block
    after k steps, sums[k] of |u| over its cells)."""
    if block.device.type == "cpu":
        f, sums = torus_chunk_ref(xlo, block, xhi, ylo, yhi, obst_band,
                                  params, k, row_base)
        return into(out, f), sums
    return _torus_launch(xlo, block, xhi, ylo, yhi, obst_band, params, k,
                         row_base, out)[:2]


def _torus_launch(xlo, block, xhi, ylo, yhi, obst_band, params: LBMParams,
                  k: int, row_base: int, out=None):
    """K4 torus mode on CUDA tensors: (the block after k steps, sums[k], the
    (k, ntiles) partials that its epilogue reduced into sums)."""
    _build.require_cuda(xlo, block, xhi, ylo, yhi, obst_band)
    h, w = block.shape[1:]
    kx = col_margin(k)
    if (not 1 <= k <= TILE_K or block.shape != (9, h, w)
            or xlo.shape != (9, h, kx) or xhi.shape != (9, h, kx)
            or ylo.shape != (9, k, w + 2 * kx)
            or yhi.shape != (9, k, w + 2 * kx)
            or obst_band.shape != (h + 2 * k, w + 2 * kx)
            or not 0 <= row_base < params.ny):
        raise ValueError(
            f"torus chunk of {k} steps: x slabs {tuple(xlo.shape)}, "
            f"{tuple(xhi.shape)}, y slabs {tuple(ylo.shape)}, "
            f"{tuple(yhi.shape)}, block {tuple(block.shape)}, mask "
            f"{tuple(obst_band.shape)}, row {row_base} do not fit the "
            f"({params.ny}, {params.nx}) grid")
    lib = _build.library()
    with _build.on_device(block):
        out, partials, sums = _outputs(lib, block, k, h, w, out)
        _build.LAUNCHES["torus_chunk"] += 1
        _build.LAUNCHES["reduce_partials"] += 1
        _build.check(
            lib.lbm_kstep_tile_torus(
                ylo.data_ptr(), xlo.data_ptr(), block.data_ptr(),
                xhi.data_ptr(), yhi.data_ptr(), obst_band.data_ptr(),
                out.data_ptr(), partials.data_ptr(), sums.data_ptr(),
                _build.ticket_counter(block.device).data_ptr(), params.ny,
                params.nx, params.accel_row, params.omega, params.accel_w1,
                params.accel_w2, k, h, w, row_base,
                torch.cuda.current_stream(block.device).cuda_stream),
            _what(lib, k))
    return out, sums, partials


def _outputs(lib, src, k: int, out_rows: int, out_cols: int, out=None):
    """(out (9, out_rows, out_cols), partials (k, ntiles), sums (k,)) on
    src's device; out is the given one where there is one."""
    ntiles = lib.lbm_kstep_tile_blocks(out_rows, out_cols)
    return (output(out, src, (9, out_rows, out_cols)),
            torch.empty((k, ntiles), dtype=torch.float32, device=src.device),
            torch.empty(k, dtype=torch.float32, device=src.device))


def _what(lib, k: int) -> str:
    return (f"lbm_kstep_tile ({k} steps, {lib.lbm_kstep_tile_smem(k)} B of "
            f"dynamic shared memory)")

