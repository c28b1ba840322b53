"""K-step chunks for grids in device memory: kernel K1.

``skew_chunk`` (K = ``SKEW_K`` = 8) is the counterpart of
``tpulbm.ops.pallas_kstep_skew._kernel``, the 1024^2 deck's tier;
``kstep_chunk`` (K < 8) of ``tpulbm.ops.pallas_kstep._kernel``, which takes
the remainder when the step count is not a multiple of 8. Both run K1
(``csrc/fused_step.cu::lbm_fused_step``) K times, ping-ponging two buffers
allocated once per chunk; the last launch also turns the chunk's (K,
nblocks) per-block partials into its (K,) per-step sums of |u| over free
cells (the fused epilogue, ``reduce_partials_ref`` its plain version). The
sums stay on the device; the caller scales them by ``free_cells_inv``.

Its role: no route takes K1; ``dist.runner.kernel_plan`` sends these
grids to K6's grid kind (``ops.ring_p2p.grid_p2p_chunks``), which computes
K4's state bits (``ops.kstep_tile.tile_chunk``). K1 is the one-pass-per-step
kernel, the simplest of the port, that ``chip_smoke.py`` holds the
temporally blocked K4 against, state bitwise.

Each wrapper takes its plain PyTorch version (``*_ref``, built on
``ops.step_torch``) only when the state lies on the CPU. On a CUDA tensor it
launches the kernel or raises; any other device raises.
"""

from __future__ import annotations

import torch

from tpulbm_torch.core.params import LBMParams
from tpulbm_torch.ops import _build, step_torch

SKEW_K = 8


def skew_chunk_ref(f, obst_f, params: LBMParams, pair_symmetric=True):
    """Plain version of ``skew_chunk``: SKEW_K steps, raw per-step sums."""
    return step_torch.run_sums(f, obst_f != 0, params, SKEW_K, pair_symmetric)


def kstep_chunk_ref(f, obst_f, params: LBMParams, k: int, pair_symmetric=True):
    """Plain version of ``kstep_chunk``: k steps, raw per-step sums."""
    return step_torch.run_sums(f, obst_f != 0, params, k, pair_symmetric)


def reduce_partials_ref(partials: torch.Tensor) -> torch.Tensor:
    """Plain version of the stepping kernels' epilogue: a chunk's (K,
    nblocks) per-block partials to its (K,) per-step sums."""
    return partials.sum(dim=1, dtype=torch.float32)


def skew_chunk(f, obst_f, params: LBMParams):
    """SKEW_K fused steps of the (9, ny, nx) state ``f`` over the (ny, nx)
    float32 mask ``obst_f`` (nonzero = blocked). Returns (f', sums[SKEW_K])."""
    if f.device.type == "cpu":
        return skew_chunk_ref(f, obst_f, params)
    return _fused_steps(f, obst_f, params, SKEW_K, "skew_chunk")[:2]


def kstep_chunk(f, obst_f, params: LBMParams, k: int):
    """k fused steps (the sub-SKEW_K remainder); as ``skew_chunk``."""
    if f.device.type == "cpu":
        return kstep_chunk_ref(f, obst_f, params, k)
    return _fused_steps(f, obst_f, params, k, "kstep_chunk")[:2]


def output(out, src: torch.Tensor, shape) -> torch.Tensor:
    """Where a chunk writes its state: ``out``, checked to be a contiguous
    float32 tensor of ``shape`` on ``src``'s device apart from ``src``, or
    a new tensor. The runners pass the storage that the chunk before
    released, so that a run holds two states (the JAX runners donate their
    input alike)."""
    shape = tuple(shape)
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=src.device)
    if (tuple(out.shape) != shape or out.dtype != torch.float32
            or out.device != src.device or not out.is_contiguous()
            or out.data_ptr() == src.data_ptr()):
        raise ValueError(
            f"out {tuple(out.shape)} {out.dtype} on {out.device} cannot take "
            f"a chunk's {shape} state from {src.device} (contiguous float32, "
            f"apart from the source)")
    return out


def into(out, f: torch.Tensor) -> torch.Tensor:
    """A plain version's result ``f``, copied into ``out`` where given, as
    the kernels write theirs."""
    if out is None:
        return f
    out.copy_(f)
    return out


def check_chunk(f, obst_f, params: LBMParams, k: int) -> None:
    """What the chunk kernels take: contiguous float32 CUDA tensors of the
    grid's shapes on one device, and at least one step."""
    _build.require_cuda(f, obst_f)
    ny, nx = params.ny, params.nx
    if f.shape != (9, ny, nx) or obst_f.shape != (ny, nx):
        raise ValueError(
            f"state {tuple(f.shape)} / mask {tuple(obst_f.shape)} do not "
            f"match the ({ny}, {nx}) grid")
    if k < 1:
        raise ValueError(f"chunk of {k} steps")


def _fused_steps(f, obst_f, params: LBMParams, k: int, counter: str):
    """K1 k times on a CUDA state: (f', sums[k], the (k, nblocks) partials
    that the last launch reduced into sums). The chunk wrappers drop the
    partials; ``chip_smoke.py`` holds the sums against
    ``reduce_partials_ref`` of them."""
    check_chunk(f, obst_f, params, k)
    ny, nx = params.ny, params.nx
    lib = _build.library()
    with _build.on_device(f):
        nblocks = lib.lbm_fused_step_blocks(ny * nx)
        partials = torch.empty((k, nblocks), dtype=torch.float32,
                               device=f.device)
        sums = torch.empty(k, dtype=torch.float32, device=f.device)
        out = torch.empty_like(f)
        scratch = torch.empty_like(f) if k > 1 else out
        stream = torch.cuda.current_stream(f.device).cuda_stream
        ticket = _build.ticket_counter(f.device).data_ptr()
        bufs = (out.data_ptr(), scratch.data_ptr())
        src, obst = f.data_ptr(), obst_f.data_ptr()
        for s in range(k):
            dst = bufs[(k - 1 - s) % 2]  # the last step lands in out
            _build.LAUNCHES[counter] += 1
            _build.check(
                lib.lbm_fused_step(
                    src, obst, dst, partials.data_ptr(), s, k,
                    sums.data_ptr(), ticket, ny, nx, params.accel_row,
                    params.omega, params.accel_w1, params.accel_w2, stream),
                "lbm_fused_step")
            src = dst
        _build.LAUNCHES["reduce_partials"] += 1
    return out, sums, partials
