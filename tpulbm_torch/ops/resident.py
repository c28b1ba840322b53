"""K-step chunk for small grids in one persistent launch: kernel K2.

``resident_chunk`` is the counterpart of
``tpulbm.ops.pallas_resident._kernel`` (``make_resident_step``) and of its
HBM-edge variant ``_kernel_hbm`` (``make_resident_step_hbm``): up to
``RESIDENT_K`` steps per call of a grid that
``dist.runner.resident_route`` sends here (8/128-aligned, at most 135K
cells; K2 itself takes any grid of at least h rows and columns a CTA). K2 (``csrc/resident.cu::lbm_resident_chunk``)
is one cooperative launch of about one CTA per SM, the CTAs a cy x cx grid
of blocks of the lattice: each CTA holds its block and ``h`` halo cells a
side in its shared memory for the whole chunk, runs ``h`` steps on a
window that shrinks a cell a side a step, and then trades its edges with
its eight neighbours only, through slots in global memory whose every
word carries its value and its epoch; no grid-wide barrier between steps.
After the last step one grid barrier precedes the epilogue, where its
blocks reduce the per-CTA partials to the (K,) per-step sums of |u| over
free cells (``ops.kstep.reduce_partials_ref`` is the plain version of
that epilogue).

``resident_plan`` is the one statement of how a grid is cut: the CTAs
(at most ``RESIDENT_CTAS``, or the card's co-resident limit), their grid
(the smallest windows), ``h`` (``RESIDENT_H``, less where no grid holds
the deeper window) and the kernel's instance (cells a thread); the C entry
point refuses a plan that would overrun its window, with the same
constants (``tests/test_torch_resident.py`` holds the two to each other,
and models the schedule).

Its role: ``dist.runner.kernel_plan`` sends every resident grid here:
the 128^2, 128x256 and 256^2 decks and the 100K-135K-cell shapes of
``_kernel_hbm`` (256x512). Its plain version is ``resident_chunk_ref``;
on the card its state is held bitwise against K4's whole-grid chunks
(``kstep_tile.tile_chunk``), which run the same cell code.

The slots (zeroed when made, never cleared) and the next launch's base
epoch live as long as the process, one set per device: launches that
share them must be ordered, which holds because every wrapper launches on
the device's current stream.

The wrapper takes the plain version (``resident_chunk_ref``) only when the
state lies on the CPU. On a CUDA tensor it launches K2 or raises — also
when no plan holds the grid or the device refuses the cooperative launch;
it never falls back to another kernel.
"""

from __future__ import annotations

import functools
import threading

import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.ops import _build, step_torch
from tpulbm_torch.ops.kstep import check_chunk, into, output

# Steps per call, as tpulbm.dist.runner._make_resident_runner's k_chunk.
RESIDENT_K = 512
# The C source's limits (csrc/resident.cu): floats a cell in the window
# (nine populations, the mask, a pad), dynamic shared memory a CTA, and
# the kernel's instances, (cells a thread, threads a CTA), smallest first.
RESIDENT_STRIDE = 11
RESIDENT_MAX_SMEM = 231424
RESIDENT_INSTANCES = ((1, 512), (1, 768), (1, 1024), (2, 1024))
# The plan's CTAs and halo depth where the grid allows them (PERF.md:
# tools/resident_sweep.py on the H100).
RESIDENT_CTAS = 128
RESIDENT_H = 5

_lock = threading.Lock()
_slots: dict = {}   # device index -> [slot words, next base epoch]
_most: dict = {}    # (device index, cells, threads, smem) -> CTAs


def band_start(i: int, n: int, c: int) -> int:
    """First row (column) of block row i of n rows cut into c: n // c
    each, the first n % c one more."""
    q, m = divmod(n, c)
    return i * q + min(i, m)


def window_smem(ny: int, nx: int, cy: int, cx: int, h: int) -> int:
    """Bytes of dynamic shared memory a CTA: two copies of the largest
    block's window (h halo cells a side), and a word a window row."""
    rows = -(-ny // cy) + 2 * h
    cols = -(-nx // cx) + 2 * h
    return 2 * rows * cols * RESIDENT_STRIDE * 4 + rows * 4


def slot_words(ny: int, nx: int, cy: int, cx: int, h: int) -> int:
    """Words of the exchange: 4 strips x 2 parities x 9 planes a CTA, a
    plane of h x the largest block side."""
    return cy * cx * 4 * 2 * 9 * h * max(-(-ny // cy), -(-nx // cx))


def resident_instance(ny: int, nx: int, cy: int, cx: int, h: int):
    """(cells a thread, threads a CTA) of the smallest K2 instance that runs
    the (ny, nx) grid over cy x cx CTAs with h halo cells a side, or None
    where none does: every block has at least h rows and h columns (a halo
    comes from the eight neighbours alone), the window fits, and the first
    step of a phase, the block and h - 1 cells a side, fits the threads."""
    if not (cy >= 1 and cx >= 1 and h >= 1 and ny // cy >= h
            and nx // cx >= h
            and window_smem(ny, nx, cy, cx, h) <= RESIDENT_MAX_SMEM):
        return None
    cells_a_step = (-(-ny // cy) + 2 * (h - 1)) * (-(-nx // cx) + 2 * (h - 1))
    for cells, threads in RESIDENT_INSTANCES:
        if cells_a_step <= cells * threads:
            return cells, threads
    return None


@functools.lru_cache(maxsize=None)
def resident_plan(ny: int, nx: int, ctas: int = RESIDENT_CTAS,
                  h: int = RESIDENT_H, cy: int = 0):
    """(cy, cx, h, cells a thread, threads a CTA) of a K2 launch over the
    (ny, nx) grid: the deepest h from ``h`` down at which some grid of at
    most ``ctas`` CTAs holds it; of those, the most CTAs, then the CTA grid
    (cy rows of cx, cy x cx a divisor pair of the count; ``cy``, where
    given, fixes it) whose windows are the smallest. None where no plan
    holds the grid."""
    for hh in range(h, 0, -1):
        for c in range(ctas, 0, -1):
            best = None
            for gy in ([cy] if cy else range(1, c + 1)):
                if c % gy:
                    continue
                inst = resident_instance(ny, nx, gy, c // gy, hh)
                size = ((-(-ny // gy) + 2 * hh)
                        * (-(-nx // (c // gy)) + 2 * hh))
                if inst and (best is None or size < best[0]):
                    best = (size, (gy, c // gy, hh, *inst))
            if best:
                return best[1]
    return None


def resident_chunk_ref(f, obst_f, params: LBMParams, k: int,
                       pair_symmetric=True):
    """Plain version of ``resident_chunk``: k steps, raw per-step sums."""
    return step_torch.run_sums(f, obst_f != 0, params, k, pair_symmetric)


def resident_chunk(f, obst_f, params: LBMParams, k: int, out=None):
    """k fused steps of the (9, ny, nx) state ``f`` over the (ny, nx)
    float32 mask ``obst_f`` (nonzero = blocked). Returns (f', sums[k]); f' is
    ``out`` where given (``ops.kstep.output``)."""
    if f.device.type == "cpu":
        f, sums = resident_chunk_ref(f, obst_f, params, k)
        return into(out, f), sums
    return _resident_launch(f, obst_f, params, k, out)[:2]


def _exchange(device, words: int, phases: int):
    """The device's slot words (at least ``words``, zeroed where new) and
    the base epoch of a launch of ``phases`` phases; advances the base past
    every epoch that launch can write."""
    with _lock:
        entry = _slots.get(device.index)
        if entry is None or entry[0].numel() < words:
            base = entry[1] if entry else 0
            entry = _slots[device.index] = [
                torch.zeros(words, dtype=torch.int64, device=device), base]
        base = entry[1]
        entry[1] = base + phases
        return entry[0], base


def launch_plan(ny: int, nx: int, device, ctas: int = RESIDENT_CTAS,
                h: int = RESIDENT_H, cy: int = 0):
    """(cy, cx, h, cells a thread, threads a CTA, shared-memory bytes a
    CTA) of a K2 launch over the (ny, nx) grid on a CUDA ``device``:
    ``resident_plan`` within ``ctas``, ``h`` (and ``cy``) and the device's
    co-resident limit. Raises where no plan holds the grid."""
    lib = _build.library()
    plan = resident_plan(ny, nx, ctas, h, cy)
    if plan is not None:
        key = (device.index, *plan[3:], window_smem(ny, nx, *plan[:3]))
        if key not in _most:
            with torch.cuda.device(device):
                _most[key] = lib.lbm_resident_max_ctas(*key[1:])
        most = _most[key]
        if most < 1:
            _build.check(-most, f"K2: no CTA of the plan {plan} is "
                                f"resident on {device}")
        if plan[0] * plan[1] > most:
            plan = resident_plan(ny, nx, most, h, cy)
    if plan is None:
        raise ValueError(f"K2 holds no ({ny}, {nx}) grid")
    return (*plan, window_smem(ny, nx, *plan[:3]))


def _resident_launch(f, obst_f, params: LBMParams, k: int, out=None,
                     ctas: int = RESIDENT_CTAS, h: int = RESIDENT_H,
                     cy: int = 0):
    """K2 on a CUDA state, its plan ``launch_plan(..., ctas, h, cy)``: (f',
    sums[k], the (k, CTAs) partials that its epilogue reduced into
    sums)."""
    check_chunk(f, obst_f, params, k)
    if k > RESIDENT_K:
        raise ValueError(f"K2 runs at most {RESIDENT_K} steps a launch")
    ny, nx = params.ny, params.nx
    lib = _build.library()
    with _build.on_device(f):
        gy, gx, hh, cells, threads, smem = launch_plan(ny, nx, f.device,
                                                       ctas, h, cy)
        slots, base = _exchange(f.device, slot_words(ny, nx, gy, gx, hh),
                                -(-k // hh))
        partials = torch.empty((k, gy * gx), dtype=torch.float32,
                               device=f.device)
        sums = torch.empty(k, dtype=torch.float32, device=f.device)
        out = output(out, f, f.shape)
        _build.LAUNCHES["resident_chunk"] += 1
        _build.LAUNCHES["reduce_partials"] += 1
        _build.check(
            lib.lbm_resident_chunk(
                f.data_ptr(), obst_f.data_ptr(), out.data_ptr(),
                slots.data_ptr(), partials.data_ptr(), sums.data_ptr(), gy,
                gx, hh, cells, threads, base, ny, nx, k, params.accel_row,
                params.omega, params.accel_w1, params.accel_w2,
                torch.cuda.current_stream(f.device).cuda_stream),
            f"lbm_resident_chunk ({gy} x {gx} CTAs of {threads} threads, h = "
            f"{hh}, {cells} cell(s) a thread, {smem} B of shared memory a "
            f"CTA)")
    return out, sums, partials
