"""K-step chunks for grids in device memory: kernels K1 + K3.

``skew_chunk`` (K = ``SKEW_K`` = 8) is the counterpart of
``tpulbm.ops.pallas_kstep_skew._kernel``, the 1024^2 deck's tier;
``kstep_chunk`` (K < 8) of ``tpulbm.ops.pallas_kstep._kernel``, which takes
the remainder when the step count is not a multiple of 8. Both run K1
(``csrc/fused_step.cu::lbm_fused_step``) K times, ping-ponging two buffers
allocated once per chunk, then K3 (``lbm_reduce_partials``) once to turn the
(K, nblocks) per-block partials into the (K,) per-step sums of |u| over
free cells. The sums stay on the device; the caller scales them by
``free_cells_inv``.

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
    """Plain version of ``reduce_partials``."""
    return partials.sum(dim=1, dtype=torch.float32)


def skew_chunk(f, obst_f, params: LBMParams):
    """SKEW_K fused steps of the (9, ny, nx) state ``f`` over the (ny, nx)
    float32 mask ``obst_f`` (nonzero = blocked). Returns (f', sums[SKEW_K])."""
    if f.device.type == "cpu":
        return skew_chunk_ref(f, obst_f, params)
    return _fused_steps(f, obst_f, params, SKEW_K, "skew_chunk")


def kstep_chunk(f, obst_f, params: LBMParams, k: int):
    """k fused steps (the sub-SKEW_K remainder); as ``skew_chunk``."""
    if f.device.type == "cpu":
        return kstep_chunk_ref(f, obst_f, params, k)
    return _fused_steps(f, obst_f, params, k, "kstep_chunk")


def reduce_partials(partials: torch.Tensor) -> torch.Tensor:
    """(K, nblocks) float32 partials -> (K,) sums, fixed order (K3)."""
    if partials.device.type == "cpu":
        return reduce_partials_ref(partials)
    _build.require_cuda(partials)
    lib = _build.library()
    k, nblocks = partials.shape
    with _build.on_device(partials):
        out = torch.empty(k, dtype=torch.float32, device=partials.device)
        _build.LAUNCHES["reduce_partials"] += 1
        _build.check(
            lib.lbm_reduce_partials(
                partials.data_ptr(), out.data_ptr(), k, nblocks,
                torch.cuda.current_stream(partials.device).cuda_stream),
            "lbm_reduce_partials")
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
    check_chunk(f, obst_f, params, k)
    ny, nx = params.ny, params.nx
    lib = _build.library()
    nblocks = lib.lbm_fused_step_blocks(ny * nx)
    partials = torch.empty((k, nblocks), dtype=torch.float32, device=f.device)
    out = torch.empty_like(f)
    scratch = torch.empty_like(f) if k > 1 else out
    stream = torch.cuda.current_stream(f.device).cuda_stream
    bufs = (out.data_ptr(), scratch.data_ptr())
    src, obst, row0 = f.data_ptr(), obst_f.data_ptr(), partials.data_ptr()
    for s in range(k):
        dst = bufs[(k - 1 - s) % 2]  # the last step lands in out
        _build.LAUNCHES[counter] += 1
        _build.check(
            lib.lbm_fused_step(
                src, obst, dst, row0 + 4 * nblocks * s, ny, nx,
                params.accel_row, params.omega, params.accel_w1,
                params.accel_w2, stream),
            "lbm_fused_step")
        src = dst
    return out, reduce_partials(partials)
