"""K-step chunk for small grids in one persistent launch: kernel K2.

``resident_chunk`` is the counterpart of
``tpulbm.ops.pallas_resident._kernel`` (``make_resident_step``) and of its
HBM-edge variant ``_kernel_hbm`` (``make_resident_step_hbm``): up to
``RESIDENT_K`` steps per call of a grid that ``dist.tiers`` routes here
(8/128-aligned, at most 135K cells; K2 itself takes any shape). K2
(``csrc/resident.cu::lbm_resident_chunk``) is one cooperative launch with a
grid-wide barrier between steps, its ping-pong pair held in L2; after the
last barrier its blocks reduce the per-block partials to the (K,) per-step
sums of |u| over free cells (``ops.kstep.reduce_partials_ref`` is the plain
version of that epilogue).

Its role since K5: ``dist.runner.kernel_plan`` sends a resident grid to
K5 (``ops.cluster``) where ``cluster.resident_route`` holds
(128^2), and here otherwise: 128x256 and 256^2, where K5 measured no
faster on the H100, and the 100K-135K-cell shapes of ``_kernel_hbm``
(256x512), beyond one cluster.

The wrapper takes the plain version (``resident_chunk_ref``) only when the
state lies on the CPU. On a CUDA tensor it launches K2 or raises — also when
the device refuses the cooperative launch; it never falls back to K1.
"""

from __future__ import annotations

import ctypes

import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.ops import _build, step_torch
from tpulbm_torch.ops.kstep import check_chunk, into, output

# Steps per call, as tpulbm.dist.runner._make_resident_runner's k_chunk.
RESIDENT_K = 512


def resident_chunk_ref(f, obst_f, params: LBMParams, k: int,
                       pair_symmetric=True):
    """Plain version of ``resident_chunk``: k steps, raw per-step sums."""
    return step_torch.run_sums(f, obst_f != 0, params, k, pair_symmetric)


def resident_chunk(f, obst_f, params: LBMParams, k: int, out=None):
    """k fused steps of the (9, ny, nx) state ``f`` over the (ny, nx) float32
    mask ``obst_f`` (nonzero = blocked). Returns (f', sums[k]); f' is
    ``out`` where given (``ops.kstep.output``)."""
    if f.device.type == "cpu":
        f, sums = resident_chunk_ref(f, obst_f, params, k)
        return into(out, f), sums
    return _resident_launch(f, obst_f, params, k, out)[:2]


def _resident_launch(f, obst_f, params: LBMParams, k: int, out=None):
    """K2 on a CUDA state: (f', sums[k], the (k, grid) partials that its
    epilogue reduced into sums)."""
    check_chunk(f, obst_f, params, k)
    ny, nx = params.ny, params.nx
    lib = _build.library()
    with _build.on_device(f):
        grid = ctypes.c_int(0)
        _build.check(lib.lbm_resident_grid(ny * nx, ctypes.byref(grid)),
                     "lbm_resident_grid (cooperative launch)")
        partials = torch.empty((k, grid.value), dtype=torch.float32,
                               device=f.device)
        sums = torch.empty(k, dtype=torch.float32, device=f.device)
        out = output(out, f, f.shape)
        scratch = torch.empty_like(f)
        _build.LAUNCHES["resident_chunk"] += 1
        _build.LAUNCHES["reduce_partials"] += 1
        _build.check(
            lib.lbm_resident_chunk(
                f.data_ptr(), obst_f.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), partials.data_ptr(), sums.data_ptr(),
                grid.value, ny, nx, k, params.accel_row, params.omega,
                params.accel_w1, params.accel_w2,
                torch.cuda.current_stream(f.device).cuda_stream),
            "lbm_resident_chunk")
    return out, sums, partials
