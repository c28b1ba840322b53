#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpulbm_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one CUDA device
    python3 chip_smoke.py --cards  # only the ring over 2-4 cards (phase 7)

Phases; any failure raises and exits non-zero before the result lines:

1. the device: ``torch.cuda.is_available()``, its name, and nvidia-smi's
   name and power limit;
2. build: nvcc compiles ``tpulbm_torch/csrc/*.cu``, one process a source
   (``ops._build``; K4's shared memory and CTAs per SM, K5's cluster
   size, shared memory a CTA and most active clusters are logged);
3. each kernel against its plain PyTorch version on the card, on the same
   inputs (made from a seed with numpy), at the shapes the main path gives
   it, with CUDA-event times of both, a bitwise rerun and the bound (the
   least time the H100 could take for the same work): K5
   (``cluster_resident_chunk``) and K2 ``resident_chunk`` on the same
   inputs, one 512-step chunk of each small deck's shape, K5's state
   bitwise K2's; K2 also on a 256x512 grid, the HBM-edge resident tier's;
   K4 ``tile_chunk`` and K1 (``skew_chunk``, 8 steps, and
   ``kstep_chunk``, 3 steps) on the same 1024^2 inputs, K4's state bitwise
   K1's; K4
   (``tile_chunk``, 8 steps at 2048^2 and 8192^2 and 3 steps at 2048^2;
   ``ring_chunk``, ring mode, on a 2048-row shard of the 8192^2 deck and a
   256-row shard of the 1024^2 deck at 8 steps and at 1 step, and on the
   8192^2 seam-fix band and the 4096^2 fold-fix band, cut into lo, shard
   and hi) and K4 against K1 on one 2048^2 chunk (state bitwise). Every
   chunk kernel's in-kernel sums (the former K3, now each stepping
   kernel's epilogue) are held against ``reduce_partials_ref`` of the same
   launch's partials, and the ticket counter is read back at 0 after every
   launch; the epilogue is timed as K1's last launch less its first,
   beside ``torch.sum``. ``tile_chunk`` also runs at the shapes of the
   TPU kernels that no main path reaches (272x8192, where the JAX router
   takes ``_kernel_row_inner``; the bands, strips and merge kernels' test
   shapes); plus the host cost of a launch and of a ring chunk; with two
   or more cards, the 1024^2 ring with its shards on distinct cards;
4. the main path, launch counts set to 0 just before each run and read
   just after (every chunk's sums reduced in-kernel, no second-pass entry
   point): ``tpulbm_torch.cli.main`` on the four reference decks at their
   full step counts, outputs gated at 1 % against ``tests/goldens/`` by the
   port's ``validation.check``, each through the kernel its route names
   (K5 at 128^2, K2 at 128x256 and 256^2, K4 at 1024^2; no K1 launch); one
   more 1024^2 run of 1003 steps takes the sub-8-step remainder through
   K4. The wide decks (2048^2,
   4096^2, 8192^2) through ``cli.main`` with ``--no-output`` (8192^2's
   final_state.dat would be 67M lines) at their full step counts, on K4:
   launches, MLUPS, peak device memory; their av series, from a
   ``Simulation`` rerun that gives the same Reynolds bits, within 1 % of
   the same deck run through K1; 2048^2 for 1003 steps takes the remainder
   through ``tile_chunk``, its Reynolds number within 1 % of the K1
   route's;
5. the ring, through ``cli.main`` with ``--device-count``: the three
   small reference decks over 2 shards, 1024^2 over 4, over 3 (uneven) and
   over 4 with ``--backend cuda-p2p``, at their full step counts through
   the golden gate; 8192^2 over 4 shards with ``--no-output``, its final
   state bitwise that of phase 4's single-device K4 run of the deck and
   its av series within 1 %.
   Each run logs its shard-to-card layout, MLUPS, peak device memory and
   host microseconds per chunk (the time to issue the runner call's
   chunks); phases 3-5 log their seconds;
6. one JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``;
7. with ``--cards``, instead of phases 3-6: the ring with shard i on card
   i (``phase_cards``), then the result line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
SEED = 20260
# (deck, steps, final_state golden or None)
DECKS = [
    ("128x128", 40000, "128x128.final_state.dat"),
    ("128x256", 40000, "128x256.final_state.dat"),
    ("256x256", 80000, None),
    ("1024x1024", 20000, None),
]
REMAINDER_RUN = ("1024x1024", 1003)
# The wide decks (data/, generated by the JAX package's make_deck; no
# goldens): K4 through Simulation, held against the same deck through K1.
WIDE_DECKS = [("2048x2048", 4000), ("4096x4096", 2000), ("8192x8192", 1000)]
WIDE_REMAINDER_RUN = ("2048x2048", 1003)
# Kernel vs plain on the card. nvcc contracts a*b+c into FMAs where the
# plain PyTorch ops round twice, so the two differ in the last bits, growing
# with the steps of a chunk. The per-step sums of |u| are the more sensitive:
# on near-stagnant cells rounding noise in the momentum becomes a positive
# bias in |u|. Measured on an H100 80GB HBM3 (700 W), 512 K2 steps of a
# perturbed 128^2 state: max|df| 1.38e-7, av rel 1.19e-4 (at step 82); one
# step: df 3.7e-9, sums bitwise equal.
F_ATOL = 5e-7          # max |f_kernel - f_plain| over a chunk
AV_RTOL = 3e-4         # max relative difference of the per-step sums
K3_RTOL = 1e-6         # in-kernel sums vs their partials' torch.sum (1.2e-7)
GOLDEN_TOL = 1.0       # percent, the reference's gate

# Bounds: the least time the card could take for a call's work, the larger
# of its bytes (each input read once, each output written once) over the
# H100 SXM's HBM rate and its fp32 operations over the fp32 peak outside
# the tensor cores (NVIDIA's data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations of one cell update of csrc/lbm_cell.cuh, an FMA counted
# as two: 8 + 5 + 5 adds of the moments, 1 divide, 3 for |m|^2, 2 for the
# 3/(2 rho) factor, 6 for the rest channel, 15 + 15 + 16 + 16 for the four
# channel pairs, 2 for |u|.
OPS_PER_UPDATE = 94


def log(msg: str = "") -> None:
    print(msg, flush=True)


def deck_files(deck):
    return (os.path.join(ROOT, "data", f"input_{deck}.params"),
            os.path.join(ROOT, "data", f"obstacles_{deck}.dat"))


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps calls (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """(bound_ms, bound_by) of a call that moves nbytes and does ops."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def chunk_bound(cells, k):
    """k steps of a periodic grid: state and mask in, state and k sums
    out; k updates of every cell."""
    return bound(4 * (9 + 1 + 9) * cells + 4 * k, OPS_PER_UPDATE * cells * k)


def band_bound(rows, nx, k):
    """k steps of a band of rows keeping rows - 2k: band and mask in, kept
    rows and k sums out; the updates of the kept rows' dependence cone,
    (h + 2(k - s)) rows at step s."""
    h = rows - 2 * k
    return bound(4 * (10 * rows + 9 * h) * nx + 4 * k,
                 OPS_PER_UPDATE * nx * (k * h + k * (k - 1)))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); device 0: {kind}")
    log(smi.stdout.strip().splitlines()[0])
    return kind


def phase_build():
    from tpulbm_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {_build.build()}")
    for k in (8, 3):
        log(f"[build] K4 at k = {k}: {_build.library().lbm_kstep_tile_smem(k)} "
            f"B of dynamic shared memory, "
            f"{_build.library().lbm_kstep_tile_ctas_per_sm(k)} CTA(s) per SM")
    from tpulbm_torch.ops import cluster

    lib = _build.library()
    for deck, (ny, nx) in (("128x128", (128, 128)), ("128x256", (128, 256)),
                           ("256x256", (256, 256))):
        cells = cluster.resident_cells(ny, nx)
        log(f"[build] K5 at {deck}: a cluster of {cluster.RESIDENT_CLUSTER} "
            f"CTAs, {cells} cells a thread, "
            f"{lib.lbm_cluster_resident_smem()} B of dynamic shared memory a "
            f"CTA, at most {lib.lbm_cluster_resident_clusters(cells)} "
            f"cluster(s) active")
    log_path = _build.BUILD_DIR / "build.log"
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"[build] {line.strip()}")


def _state(params, seed):
    """The deck's rest state with a 1 % perturbation, drawn on the card
    from a seeded generator."""
    import torch

    from tpulbm_torch.core.state import initial_state

    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.rand((9, params.ny, params.nx), generator=gen,
                       device="cuda")
    return initial_state(params, "cuda") * (1 + 0.01 * noise)


def _load_deck(deck):
    import torch

    from tpulbm_torch.io.obstacles import read_obstacles
    from tpulbm_torch.io.params_file import read_params

    pf, of = deck_files(deck)
    p = read_params(pf)
    mask, n_free = read_obstacles(of, p.nx, p.ny)
    obst_f = torch.tensor(mask, dtype=torch.float32, device="cuda")
    return p.with_free_cells(n_free), obst_f


def _random_case(ny, nx, seed):
    """A (ny, nx) grid with a seeded 10 % random mask and a perturbed
    state, on the card."""
    import numpy as np
    import torch

    from tpulbm_torch.core.params import LBMParams

    p = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    mask = np.random.RandomState(seed).rand(ny, nx) < 0.1
    p = p.with_free_cells(ny * nx - int(mask.sum()))
    return p, torch.tensor(mask, dtype=torch.float32, device="cuda"), _state(
        p, seed + 1)


def _check_epilogue(name, sums, partials):
    """The fused epilogue of a stepping launch: its sums against
    reduce_partials_ref of the same launch's partials (K3_RTOL), and the
    ticket counter back at 0. Returns the max relative difference."""
    import torch

    from tpulbm_torch.ops import _build, kstep

    torch.cuda.synchronize()
    want = kstep.reduce_partials_ref(partials)
    rel = ((sums - want).abs() / want.abs()).max().item()
    ticket = _build.ticket_counter(sums.device).item()
    if not (rel <= K3_RTOL and ticket == 0):
        raise AssertionError(f"{name}: in-kernel sums off their partials by "
                             f"{rel:.3e}, or ticket counter {ticket}")
    return rel


def _plain(plain, plain_reps):
    """The plain version's result and its CUDA-event ms, for _compare_chunk
    (one plain result held against several kernels)."""
    return plain(), cuda_ms(plain, plain_reps)


def _compare_chunk(name, kernel, plain, reps, plain_reps, bound_of):
    """Kernel vs plain on the same inputs: max|df|, max relative difference
    of the per-step sums, bitwise rerun, CUDA-event ms of both, the bound
    ((ms, "bytes" | "operations")). kernel() returns (f, sums, partials):
    the sums are also held against the partials (_check_epilogue). plain:
    the plain version, or its _plain result. Returns the record of the
    kernels JSON line."""
    import torch

    if callable(plain):
        plain = _plain(plain, plain_reps)
    (f_r, s_r), plain_ms = plain
    f_k, s_k, parts = kernel()
    torch.cuda.synchronize()
    err = (f_k - f_r).abs().max().item()
    av_rel = ((s_k - s_r).abs() / s_r.abs()).max().item()
    k3_rel = _check_epilogue(name, s_k, parts)
    f_k2, s_k2, _ = kernel()
    same = torch.equal(f_k, f_k2) and torch.equal(s_k, s_k2)
    _check_epilogue(name, s_k2, parts)
    del parts
    ms = cuda_ms(kernel, reps)
    bound_ms, bound_by = bound_of
    log(f"[kernel] {name}: max|df| {err:.3e} (<= {F_ATOL:g}), max av rel "
        f"{av_rel:.3e} (<= {AV_RTOL:g}), rerun bitwise {same}, in-kernel "
        f"sums vs their partials rel {k3_rel:.3e} (<= {K3_RTOL:g}); "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms per chunk; bound "
        f"{bound_ms:.4f} ms ({bound_by}), bound/kernel "
        f"{100 * bound_ms / ms:.1f} %")
    if not (err <= F_ATOL and av_rel <= AV_RTOL and same):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _epilogue_record(p, f0, o):
    """The in-kernel reduction of a K1 chunk at p's grid, k = 8: its sums
    against its partials, and its time, the chunk's last launch (which
    reduces rows 6 and 7, the last behind the ticket) less its first (which
    reduces nothing), in turns."""
    import torch

    from tpulbm_torch.ops import _build, kstep

    lib, k = _build.library(), kstep.SKEW_K
    _, sums, parts = kstep._fused_steps(f0, o, p, k, "skew_chunk")
    rel = _check_epilogue("K1 epilogue", sums, parts)
    err = (sums - kstep.reduce_partials_ref(parts)).abs().max().item()
    nblocks = parts.shape[1]
    out, scratch = torch.empty_like(f0), torch.empty(k, device="cuda")
    ticket = _build.ticket_counter("cuda").data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(step):
        _build.check(lib.lbm_fused_step(
            f0.data_ptr(), o.data_ptr(), out.data_ptr(), parts.data_ptr(),
            step, k, scratch.data_ptr(), ticket, p.ny, p.nx, p.accel_row,
            p.omega, p.accel_w1, p.accel_w2, stream), "lbm_fused_step")

    turns = [cuda_ms(lambda: launch(step), 200)
             for step in (0, k - 1, k - 1, 0)]
    ms = (turns[1] + turns[2] - turns[0] - turns[3]) / 2
    torch.cuda.synchronize()
    if _build.ticket_counter("cuda").item() != 0:
        raise AssertionError("K1 epilogue: ticket counter not reset")
    plain_ms = cuda_ms(lambda: kstep.reduce_partials_ref(parts), 200)
    lib_ms = cuda_ms(lambda: torch.sum(parts, dim=1), 200)
    bound_ms, bound_by = bound(4 * (k * nblocks + k), k * (nblocks - 1))
    log(f"[kernel] in-kernel sums (former K3) of a K1 chunk ({k}x{nblocks} "
        f"partials): max abs {err:.3e}, rel {rel:.3e} (<= {K3_RTOL:g}); "
        f"last launch less the first {ms:.4f} ms (turns "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms: step 0, 7, 7, 0) vs "
        f"plain {plain_ms:.4f} ms, torch.sum {lib_ms:.4f} ms; bound "
        f"{bound_ms:.5f} ms ({bound_by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def _ring_check(p, o, f0, off, h, k, reps, plain_reps, what):
    """ring_chunk against ring_chunk_ref on the shard of rows [off, off + h)
    of the state f0 (mask o) and its k-row slabs, cut from the grid (rows
    wrap), as the ring passes them; returns _compare_chunk's record."""
    import torch

    from tpulbm_torch.ops import kstep_tile

    rows = torch.arange(off - k, off + h + k, device="cuda") % p.ny
    band, ob = f0[:, rows].contiguous(), o[rows].contiguous()
    lo, shard, hi = (band[:, :k].contiguous(), band[:, k:k + h].contiguous(),
                     band[:, k + h:].contiguous())
    del band
    base = (off - k) % p.ny
    return _compare_chunk(
        f"ring_chunk K4 ring mode ({what}, {h} rows, {k} "
        f"step{'s' if k > 1 else ''})",
        lambda: kstep_tile._ring_launch(lo, shard, hi, ob, p, k, base),
        lambda: kstep_tile.ring_chunk_ref(lo, shard, hi, ob, p, k, base),
        reps, plain_reps, band_bound(h + 2 * k, p.nx, k))


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_kernels():
    import numpy as np
    import torch

    from tpulbm_torch.core.params import LBMParams
    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh
    from tpulbm_torch.ops import cluster, kstep, kstep_tile, resident

    res = {}
    chunk_ms = {}   # K4 8-step chunk records of the wide decks
    k = resident.RESIDENT_K
    # K5 and K2 on the small decks' shapes, 512 steps, against one plain
    # result: K5's state bitwise K2's, their times in one call.
    for deck, seed in (("128x128", SEED), ("128x256", SEED + 13),
                       ("256x256", SEED + 14)):
        p, o = _load_deck(deck)
        f0 = _state(p, seed)
        plain = _plain(lambda: resident.resident_chunk_ref(f0, o, p, k), 1)
        bound_of = chunk_bound(p.ny * p.nx, k)
        k5 = _compare_chunk(
            f"cluster_resident_chunk K5 ({deck}, {k} steps)",
            lambda: cluster._resident_launch(f0, o, p, k), plain, 10, 1,
            bound_of)
        k2 = _compare_chunk(
            f"resident_chunk K2 ({deck}, {k} steps)",
            lambda: resident._resident_launch(f0, o, p, k), plain, 10, 1,
            bound_of)
        f5 = cluster._resident_launch(f0, o, p, k)[0]
        same = torch.equal(f5, resident._resident_launch(f0, o, p, k)[0])
        log(f"[kernel] K5 vs K2 ({deck}, {k} steps, same input): "
            f"{k5['ms']:.4f} vs {k2['ms']:.4f} ms, K5/K2 "
            f"{k5['ms'] / k2['ms']:.3f}; state bitwise K2's {same}; route: "
            f"{'K5' if cluster.resident_route(p.ny, p.nx) else 'K2'}")
        if not same:
            raise AssertionError(f"K5's state differs from K2's at {deck}")
        if deck == "128x128":
            res["cluster_resident"] = k5
        if deck == "256x256":
            res["resident_chunk"] = k2
        del f0, f5, plain
    # The HBM-edge resident tier's shape (100K-135K aligned cells)
    p = LBMParams(nx=512, ny=256, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    mask = np.random.RandomState(SEED + 4).rand(p.ny, p.nx) < 0.1
    p = p.with_free_cells(p.ny * p.nx - int(mask.sum()))
    o = torch.tensor(mask, dtype=torch.float32, device="cuda")
    f0 = _state(p, SEED + 5)
    _compare_chunk(
        f"resident_chunk K2 (256x512, {k} steps)",
        lambda: resident._resident_launch(f0, o, p, k),
        lambda: resident.resident_chunk_ref(f0, o, p, k), 10, 1,
        chunk_bound(p.ny * p.nx, k))

    p, o = _load_deck("1024x1024")
    f0 = _state(p, SEED + 1)
    # K4 and K1 at 1024^2, 8 and 3 steps, against one plain result: K4's
    # state bitwise K1's.
    for kk, name in ((8, "skew_chunk"), (3, "kstep_chunk")):
        plain = _plain(lambda: kstep.kstep_chunk_ref(f0, o, p, kk), 3)
        bound_of = chunk_bound(p.ny * p.nx, kk)
        k4 = _compare_chunk(
            f"tile_chunk K4 (1024x1024, {kk} steps)",
            lambda: kstep_tile._tile_launch(f0, o, p, kk), plain, 50, 3,
            bound_of)
        k1 = _compare_chunk(
            f"{name} K1 (1024x1024, {kk} steps)",
            lambda: kstep._fused_steps(f0, o, p, kk, name), plain, 50, 3,
            bound_of)
        same = torch.equal(kstep_tile._tile_launch(f0, o, p, kk)[0],
                           kstep._fused_steps(f0, o, p, kk, name)[0])
        log(f"[kernel] K4 vs K1 (1024x1024, {kk} steps, same input): "
            f"{k4['ms']:.4f} vs {k1['ms']:.4f} ms, K4/K1 "
            f"{k4['ms'] / k1['ms']:.3f}; state bitwise K1's {same}")
        if not same:
            raise AssertionError("K4's state differs from K1's at 1024^2")
        res[name] = k1
        del plain
    # The former K3, now the epilogue of K1's launches, at the 1024^2
    # chunk's shape (8, nblocks), its plain version and torch.sum on the
    # same partials beside it.
    res["reduce_partials"] = _epilogue_record(p, f0, o)
    # K4 at the wide decks' shapes: whole grid (8 steps, and the 3-step
    # remainder) and the seam bands of the TPU tiers it replaces.
    p, o = _load_deck("2048x2048")
    f0 = _state(p, SEED + 6)
    chunk_ms["2048x2048"] = _compare_chunk(
        "tile_chunk K4 (2048x2048, 8 steps)",
        lambda: kstep_tile._tile_launch(f0, o, p, 8),
        lambda: kstep_tile.tile_chunk_ref(f0, o, p, 8), 50, 2,
        chunk_bound(p.ny * p.nx, 8))
    _compare_chunk(
        "tile_chunk K4 (2048x2048, 3 steps)",
        lambda: kstep_tile._tile_launch(f0, o, p, 3),
        lambda: kstep_tile.tile_chunk_ref(f0, o, p, 3), 50, 2,
        chunk_bound(p.ny * p.nx, 3))
    f4, s4 = kstep_tile.tile_chunk(f0, o, p, 8)
    f1, s1 = kstep.skew_chunk(f0, o, p)
    same = torch.equal(f4, f1)
    log(f"[kernel] tile_chunk K4 vs skew_chunk K1 (2048x2048, 8 steps, same "
        f"input): max|df| {(f4 - f1).abs().max().item():.3e}, state bitwise "
        f"{same}; max sums rel "
        f"{((s4 - s1).abs() / s1.abs()).max().item():.3e}")
    if not same:
        raise AssertionError("K4's state differs from K1's on the same input")
    del f0, f4, f1
    _free()

    p, o = _load_deck("8192x8192")
    f0 = _state(p, SEED + 7)
    res["tile_chunk"] = chunk_ms["8192x8192"] = _compare_chunk(
        "tile_chunk K4 (8192x8192, 8 steps)",
        lambda: kstep_tile._tile_launch(f0, o, p, 8),
        lambda: kstep_tile.tile_chunk_ref(f0, o, p, 8), 10, 1,
        chunk_bound(p.ny * p.nx, 8))
    # K4 ring mode at the 8192^2 deck's shard over a ring of 4, where the
    # device sets the pace: shard 3 (rows 6144-8191, the accelerated row
    # 8190; its hi slab wraps to rows 0-7). This is the kernels line's
    # record.
    res["ring_chunk"] = _ring_check(p, o, f0, 6144, 2048, 8, 20, 1,
                                    "8192x8192 shard 3 of 4")
    # The seam band of the 2-D skew's fix at 8192^2: rows [-2K, 2K), which
    # hold the accelerated row ny-2, through ring mode: lo, shard and hi
    # cut from the band (the shard rows [-K, K) of the fix's output).
    _ring_check(p, o, f0, p.ny - 8, 16, 8, 200, 5, "8192x8192 seam band")
    del f0
    _free()
    # The fold fix's band at 4096^2 (F=4): rows [-(m+K), m+K), m = 14
    p, o = _load_deck("4096x4096")
    f0 = _state(p, SEED + 8)
    chunk_ms["4096x4096"] = _compare_chunk(
        "tile_chunk K4 (4096x4096, 8 steps)",
        lambda: kstep_tile._tile_launch(f0, o, p, 8),
        lambda: kstep_tile.tile_chunk_ref(f0, o, p, 8), 20, 1,
        chunk_bound(p.ny * p.nx, 8))
    _ring_check(p, o, f0, p.ny - 14, 28, 8, 200, 5, "4096x4096 fold band")
    del f0
    _free()

    # K4 ring mode on the 1024^2 deck's shards over a ring of 4, whose
    # calls are short enough that the host's launch path, not the card,
    # sets their time: shard 3 (the accelerated row 1022; its hi slab wraps
    # to rows 0-7) at 8 steps, shard 0 (its lo slab wraps to row 1023) at
    # 1 step, the function of pallas_step._kernel.
    p, o = _load_deck("1024x1024")
    f0 = _state(p, SEED + 9)
    _ring_check(p, o, f0, 768, 256, 8, 200, 5, "1024x1024 shard 3 of 4")
    _ring_check(p, o, f0, 0, 256, 1, 200, 5, "1024x1024 shard 0 of 4")
    del f0
    _free()
    # tile_chunk at the shapes of the TPU kernels no main path reaches:
    # pallas_kstep2d._kernel_row_inner (the JAX router takes it at
    # 272x8192, k = 8), pallas_kstep_bands._kernel and
    # pallas_kstep_strips._kernel (their tests' grids) and the merge mode
    # of pallas_kstep_skew._kernel (320^2, pallas_kstep_merge.py:4-9).
    for (ny, nx), what in (((272, 8192), "_kernel_row_inner"),
                           ((128, 512), "pallas_kstep_bands._kernel"),
                           ((64, 256), "pallas_kstep_strips._kernel"),
                           ((320, 320), "pallas_kstep_merge (merge mode)")):
        p, o, f0 = _random_case(ny, nx, SEED + ny)
        _compare_chunk(
            f"tile_chunk K4 ({ny}x{nx}, 8 steps; the shape of {what})",
            lambda: kstep_tile._tile_launch(f0, o, p, 8),
            lambda: kstep_tile.tile_chunk_ref(f0, o, p, 8), 50, 3,
            chunk_bound(p.ny * p.nx, 8))

    # Host cost of the Python launch path: a grid so small that the device
    # finishes each launch long before the host issues the next one.
    tiny = LBMParams(nx=64, ny=8, max_iters=1, reynolds_dim=1, density=0.1,
                     accel=0.005, omega=1.85).with_free_cells(512)
    ft = _state(tiny, SEED + 3)
    ot = torch.zeros((8, 64), dtype=torch.float32, device="cuda")
    kstep.skew_chunk(ft, ot, tiny)
    torch.cuda.synchronize()
    n = 500
    t0 = time.perf_counter()
    for _ in range(n):
        kstep.skew_chunk(ft, ot, tiny)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / n * 1e6
    log(f"[launch] host {host_us:.2f} us per skew_chunk call (8 K1 "
        f"launches, {host_us / 8:.2f} us per launch) vs device "
        f"{res['skew_chunk']['ms'] * 1e3:.2f} us per 1024^2 chunk")
    # The same for one chunk of a 4-shard ring: slab copies and K4 per
    # shard, 200 chunks in one runner call
    tiny = LBMParams(nx=64, ny=64, max_iters=1, reynolds_dim=1, density=0.1,
                     accel=0.005, omega=1.85).with_free_cells(64 * 64)
    mesh = get_mesh(4)
    fs, obs = sharding.shard_rows(
        _state(tiny, SEED + 10), torch.zeros((64, 64), dtype=torch.bool,
                                             device="cuda"), mesh)
    run = runner.make_runner(tiny, 8 * 200, "cuda", mesh=mesh)
    run(fs, obs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(fs, obs)
    torch.cuda.synchronize()
    log(f"[launch] host {(time.perf_counter() - t0) / 200 * 1e6:.2f} us per "
        f"chunk of a 4-shard ring (64x64 grid)")
    if torch.cuda.device_count() >= 2:
        _ring_on_cards()
    else:
        log("[kernel] one card: the ring with shards on distinct cards "
            "is not run")
    return res, {deck: r["ms"] for deck, r in chunk_ms.items()}


def _ring_on_cards():
    """The 1024^2 ring with shard i on card i (up to 4 shards), 64 steps
    from a perturbed state: the state within F_ATOL of the single-device K4
    plan's on card 0 (bitwise is expected), the av series within the chunk
    gate."""
    import torch

    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh
    from tpulbm_torch.ops import kstep_tile

    p, o = _load_deck("1024x1024")
    f0 = _state(p, SEED + 11)
    f1, av1 = runner.run_plan(
        runner._chunks(kstep_tile.tile_chunk, kstep_tile.TILE_K, 64), f0, o,
        p)
    mesh = get_mesh(min(4, torch.cuda.device_count()))
    fs, obs = sharding.shard_rows(f0, o != 0, mesh)
    out, av = runner.make_runner(p, 64, "cuda", mesh=mesh)(fs, obs)
    f = sharding.gather_rows(out, "cuda:0")
    torch.cuda.synchronize()
    err = (f - f1).abs().max().item()
    av_rel = ((av - av1).abs() / av1.abs()).max().item()
    log(f"[kernel] 1024x1024 ring, layout {_layout(mesh)}, 64 steps: "
        f"max|df| vs one card {err:.3e}, state bitwise {torch.equal(f, f1)}; "
        f"max av rel {av_rel:.3e}")
    if not (err <= F_ATOL and av_rel <= AV_RTOL):
        raise AssertionError("ring over cards disagrees with one card")


def _layout(mesh):
    names = [str(d) for d in mesh]
    if len(set(names)) == 1:
        return f"{names[0]} x {len(names)}"
    return ",".join(names)


def _run_cli(args):
    from tpulbm_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"    {line}")
    if rc != 0:
        raise AssertionError(f"cli.main({args}) returned {rc}")
    fields = dict(line.split(":", 1) for line in out.splitlines()
                  if ":" in line)
    return (float(fields["Reynolds number"]),
            float(fields["Elapsed time"].split()[0]))


def _check_launches(deck, counts, needed, absent=()):
    """Every kernel of `needed` launched, none of `absent`; the chunks'
    sums all reduced in-kernel: one reduction per chunk (a K2 or K4 launch,
    8 K1 launches, and one K1 remainder chunk per runner call), and the
    library has no second-pass entry point (lbm_reduce_partials) to
    launch."""
    from tpulbm_torch.ops import _build

    log(f"    launches: {counts}")
    missing = [k for k in needed if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{deck}: no launch of {missing}")
    stray = [k for k in absent if counts[k]]
    if stray:
        raise AssertionError(f"{deck}: launches of {stray} off its route")
    chunks = (counts["resident_chunk"] + counts["tile_chunk"]
              + counts["ring_chunk"] + counts["cluster_resident"]
              + counts["skew_chunk"] // 8
              + (counts["kstep_chunk"] > 0))
    if counts["reduce_partials"] != chunks:
        raise AssertionError(f"{deck}: {counts['reduce_partials']} in-kernel "
                             f"reductions for {chunks} chunks")
    if hasattr(_build.library(), "lbm_reduce_partials"):
        raise AssertionError("the library still has lbm_reduce_partials")


def _max_rel_pct(av, ref):
    import numpy as np

    return 100 * float((np.abs(av - ref) / np.abs(ref)).max())


def _k1_plan(n_steps):
    """The K1 route for n_steps (8-step skew chunks, kstep remainder), as
    kernel_plan builds it for the shapes it sends to K1."""
    from tpulbm_torch.dist import runner
    from tpulbm_torch.ops import kstep

    return runner._chunks(runner._skew, kstep.SKEW_K, n_steps,
                          kstep.kstep_chunk)


def _run_wide(deck, steps, totals, chunk_ms):
    """A wide deck through the CLI without output files, which routes it to
    K4: launches, solve time, peak memory. Its av series from the same run
    through Simulation (the CLI's own calls; it must give the same Reynolds
    bits), then the same deck on the K1 route, timed alike. chunk_ms: the
    CUDA-event time of one 8-step K4 chunk of this deck, for the device's
    busy share of the solve. Returns the Simulation's final state, on the
    host, and its av series: the single-device K4 route's result."""
    import numpy as np
    import torch

    from tpulbm_torch.core.state import initial_state
    from tpulbm_torch.dist import runner
    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.ops import _build
    from tpulbm_torch.sim.simulation import Simulation

    pf, of = deck_files(deck)
    p = read_params(pf)
    assert p.max_iters == steps, (deck, p.max_iters)
    log(f"[main] python -m tpulbm_torch {deck} --no-output ({steps} steps)")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    reynolds, elapsed = _run_cli([pf, of, "--no-output"])
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check_launches(deck, counts, ["tile_chunk", "reduce_partials"],
                    ["skew_chunk", "kstep_chunk", "resident_chunk",
                     "cluster_resident"])
    for k, v in counts.items():
        totals[k] += v
    mlups = p.nx * p.ny * steps / elapsed / 1e6
    busy = counts["tile_chunk"] * chunk_ms / 1e3 / elapsed
    log(f"[main] {deck}: Reynolds {reynolds:.12E}, {elapsed:.3f} s, "
        f"{mlups:.1f} MLUPS, peak device memory {peak / 2**30:.3f} GiB; K4 "
        f"chunks {counts['tile_chunk']} x {chunk_ms:.4f} ms = "
        f"{100 * busy:.1f} % of the solve")

    sim = Simulation.from_files(pf, of)
    result = sim.run()
    av = result.av_vels
    same = f"{result.reynolds:.12E}" == f"{reynolds:.12E}"
    if not (av.shape == (steps,) and np.isfinite(av).all() and same):
        raise AssertionError(f"{deck}: Simulation rerun: av series not "
                             f"finite or short, or Reynolds differs")
    p, obst_f = sim.params, sim.obstacles.float()
    final = result.f.cpu()
    del sim, result
    _free()
    f_k1 = initial_state(p, "cuda")
    torch.cuda.synchronize()
    tic = time.time()
    _, av_k1 = runner.run_plan(_k1_plan(steps), f_k1, obst_f, p)
    av_k1 = av_k1.cpu().numpy()
    elapsed_k1 = time.time() - tic
    rel = _max_rel_pct(av, av_k1)
    log(f"[main] {deck} on the K1 route: {elapsed_k1:.3f} s, "
        f"{p.nx * p.ny * steps / elapsed_k1 / 1e6:.1f} MLUPS; av of K4 "
        f"(Simulation rerun, same Reynolds) vs K1: max diff {rel:.3g} % "
        f"(<= {GOLDEN_TOL:g} %)")
    if not rel <= GOLDEN_TOL:
        raise AssertionError(f"{deck}: K4 and K1 av series disagree")
    return final, av


def phase_main_path(chunk_ms):
    import numpy as np

    from tpulbm_torch.core.state import initial_state
    from tpulbm_torch.diag.observables import calc_reynolds
    from tpulbm_torch.dist import runner, tiers
    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.ops import _build, cluster, kstep_tile, resident
    from tpulbm_torch.validation import check

    # The launch counter of each chunk function of the cuda route
    counter = {cluster.cluster_resident_chunk: "cluster_resident",
               kstep_tile.tile_chunk: "tile_chunk",
               resident.resident_chunk: "resident_chunk"}
    totals = dict.fromkeys(_build.LAUNCHES, 0)
    golden = os.path.join(ROOT, "tests", "goldens")
    for deck, steps, fs_golden in DECKS:
        pf, of = deck_files(deck)
        p = read_params(pf)
        assert p.max_iters == steps, (deck, p.max_iters)
        out = os.path.join(OUT, deck)
        log(f"[main] python -m tpulbm_torch {deck} ({steps} steps)")
        _build.reset_launches()
        reynolds, elapsed = _run_cli([pf, of, "--out-dir", out])
        counts = dict(_build.LAUNCHES)
        route = {counter[fn] for fn, _ in runner.kernel_plan(p, steps)}
        _check_launches(deck, counts, [*route, "reduce_partials"],
                        [c for c in ("cluster_resident", "resident_chunk",
                                     "skew_chunk", "kstep_chunk",
                                     "tile_chunk")
                         if c not in route])
        log(f"    route ({tiers.family(p.ny, p.nx, steps)} family): "
            f"{', '.join(sorted(route))}")
        for k, v in counts.items():
            totals[k] += v
        av_ok, av = check.check_av_vels(
            os.path.join(golden, f"{deck}.av_vels.dat"),
            os.path.join(out, "av_vels.dat"), GOLDEN_TOL, verbose=False)
        msg = f"av_vels max diff {av.max_diff_pcnt:.3g} %"
        fs_ok = True
        if fs_golden:
            fs_ok, _, fs = check.check_results(
                os.path.join(golden, f"{deck}.av_vels.dat"),
                os.path.join(golden, fs_golden),
                os.path.join(out, "av_vels.dat"),
                os.path.join(out, "final_state.dat"), GOLDEN_TOL,
                verbose=False)
            msg += f", final_state max diff {fs.max_diff_pcnt:.3g} %"
        mlups = p.nx * p.ny * steps / elapsed / 1e6
        log(f"[main] {deck}: Reynolds {reynolds:.12E}, {elapsed:.3f} s, "
            f"{mlups:.1f} MLUPS; golden ({GOLDEN_TOL:g} %): {msg}")
        if not (av_ok and fs_ok):
            raise AssertionError(f"{deck}: golden check failed")

    deck, steps = REMAINDER_RUN
    pf, of = deck_files(deck)
    out = os.path.join(OUT, f"{deck}_{steps}")
    log(f"[main] python -m tpulbm_torch {deck} --max-iters {steps}")
    _build.reset_launches()
    _run_cli([pf, of, "--out-dir", out, "--max-iters", str(steps)])
    counts = dict(_build.LAUNCHES)
    _check_launches(deck, counts, ["tile_chunk", "reduce_partials"],
                    ["skew_chunk", "kstep_chunk"])
    if counts["tile_chunk"] != -(-steps // kstep_tile.TILE_K):
        raise AssertionError(f"{deck} x {steps}: {counts['tile_chunk']} "
                             f"tile_chunk launches")
    for k, v in counts.items():
        totals[k] += v
    av = np.loadtxt(os.path.join(out, "av_vels.dat"), usecols=[1])
    ref = np.loadtxt(os.path.join(golden, f"{deck}.av_vels.dat"),
                     usecols=[1], max_rows=steps)
    pct = 100 * np.abs(av - ref).max() / np.abs(ref).min()
    rel = _max_rel_pct(av, ref)
    log(f"[main] {deck} x {steps}: av_vels prefix max diff {rel:.3g} % "
        f"(abs over min |ref| {pct:.3g} %)")
    if not (av.shape == (steps,) and rel <= GOLDEN_TOL):
        raise AssertionError(f"{deck} x {steps}: golden prefix check failed")

    one_card = {}   # the single-device K4 result of the ring's wide deck
    for deck, steps in WIDE_DECKS:
        final, av = _run_wide(deck, steps, totals, chunk_ms[deck])
        if deck == RING_WIDE_RUN[0]:
            one_card = {"f": final, "av": av}
        del final
        _free()

    # The sub-8-step remainder of a wide deck: 125 x 8 + 3 steps of K4,
    # its Reynolds number against the K1 route's final state
    deck, steps = WIDE_REMAINDER_RUN
    pf, of = deck_files(deck)
    log(f"[main] python -m tpulbm_torch {deck} --max-iters {steps} "
        f"--no-output")
    _build.reset_launches()
    reynolds, _ = _run_cli([pf, of, "--no-output", "--max-iters", str(steps)])
    counts = dict(_build.LAUNCHES)
    n_chunks = -(-steps // kstep_tile.TILE_K)
    _check_launches(deck, counts, ["tile_chunk", "reduce_partials"],
                    ["skew_chunk", "kstep_chunk"])
    if counts["tile_chunk"] != n_chunks:
        raise AssertionError(f"{deck} x {steps}: {counts['tile_chunk']} "
                             f"tile_chunk launches, not {n_chunks}")
    for k, v in counts.items():
        totals[k] += v
    p, obst_f = _load_deck(deck)
    f_k1, _ = runner.run_plan(_k1_plan(steps), initial_state(p, "cuda"),
                              obst_f, p)
    re_k1 = float(calc_reynolds(f_k1, obst_f != 0, p))
    rel = 100 * abs(reynolds - re_k1) / abs(re_k1)
    log(f"[main] {deck} x {steps}: Reynolds {reynolds:.12E}, K1 route "
        f"{re_k1:.12E}: diff {rel:.3g} % (<= {GOLDEN_TOL:g} %)")
    if not rel <= GOLDEN_TOL:
        raise AssertionError(f"{deck} x {steps}: remainder run disagrees")
    del f_k1
    _free()

    return totals, one_card


# The ring through the CLI: (deck, steps, --device-count, extra arguments).
# The small decks run over 2 shards: on one card the ring's host path sets
# their pace, and 4 shards would double the script's time for them.
RING_RUNS = [
    ("128x128", 40000, 2, []),
    ("128x256", 40000, 2, []),
    ("256x256", 80000, 2, []),
    ("1024x1024", 20000, 4, []),
    ("1024x1024", 20000, 3, []),                          # 342/341/341 rows
    ("1024x1024", 20000, 4, ["--backend", "cuda-p2p"]),
]
RING_WIDE_RUN = ("8192x8192", 1000, 4)


@contextlib.contextmanager
def _watch_simulation(seen):
    """Record the Simulation that cli.main builds (seen["sim"]) and the
    host seconds its runner calls take to return (seen["issue_s"]): the
    runners issue their chunks without waiting for the card, which the
    caller's readback of the av series then does."""
    from tpulbm_torch.sim.simulation import Simulation

    run, make = Simulation.run, Simulation._runner
    seen["issue_s"] = 0.0

    def watched_run(self, *a, **kw):
        seen["sim"] = self
        return run(self, *a, **kw)

    def watched_runner(self, n_steps):
        inner = make(self, n_steps)

        def timed(*a):
            t0 = time.perf_counter()
            out = inner(*a)
            seen["issue_s"] += time.perf_counter() - t0
            return out

        return timed

    Simulation.run, Simulation._runner = watched_run, watched_runner
    try:
        yield
    finally:
        Simulation.run, Simulation._runner = run, make


def _ring_cli(deck, steps, n, extra, totals, out=None):
    """One ring run through cli.main: launches (ring_chunk only),
    MLUPS, peak device memory, host us per chunk, layout. Returns (the
    Simulation, Reynolds number)."""
    import torch

    from tpulbm_torch.dist.sharding import ring_rows
    from tpulbm_torch.ops import _build, kstep_tile

    pf, of = deck_files(deck)
    args = [pf, of, "--device-count", str(n), *extra]
    args += ["--out-dir", out] if out else ["--no-output"]
    log(f"[ring] python -m tpulbm_torch {deck} {' '.join(args[2:])} "
        f"({steps} steps)")
    seen = {}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with _watch_simulation(seen):
        reynolds, elapsed = _run_cli(args)
    counts = dict(_build.LAUNCHES)
    _check_launches(deck, counts, ["ring_chunk", "reduce_partials"],
                    ["skew_chunk", "kstep_chunk", "resident_chunk",
                     "tile_chunk", "cluster_resident"])
    for key, v in counts.items():
        totals[key] += v
    sim = seen["sim"]
    rows, _ = ring_rows(sim.params.ny, n)
    k = min(kstep_tile.TILE_K, min(rows))
    chunks = -(-steps // k)
    log(f"[ring] {deck} over {n} shards ({'/'.join(map(str, rows))} rows), "
        f"layout {_layout(sim.mesh)}: Reynolds {reynolds:.12E}, "
        f"{elapsed:.3f} s, {sim.params.nx * sim.params.ny * steps / elapsed / 1e6:.1f} "
        f"MLUPS, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, {chunks} "
        f"chunks of {k} steps, host {seen['issue_s'] / chunks * 1e6:.1f} us "
        f"per chunk, solve {elapsed / chunks * 1e6:.1f} us per chunk")
    return sim, reynolds


def _ring_golden(deck, steps, n, extra, totals):
    """A reference deck over n shards through cli.main, its outputs
    through the golden gate."""
    from tpulbm_torch.validation import check

    golden = os.path.join(ROOT, "tests", "goldens")
    out = os.path.join(OUT, f"ring_{deck}_{n}{''.join(extra)}")
    sim, _ = _ring_cli(deck, steps, n, extra, totals, out)
    assert sim.params.max_iters == steps, (deck, sim.params.max_iters)
    del sim
    av_ref = os.path.join(golden, f"{deck}.av_vels.dat")
    fs_ref = os.path.join(golden, f"{deck}.final_state.dat")
    av_out = os.path.join(out, "av_vels.dat")
    av_ok, av = check.check_av_vels(av_ref, av_out, GOLDEN_TOL,
                                    verbose=False)
    msg, fs_ok = f"av_vels max diff {av.max_diff_pcnt:.3g} %", True
    if os.path.exists(fs_ref):
        fs_ok, _, fs = check.check_results(
            av_ref, fs_ref, av_out, os.path.join(out, "final_state.dat"),
            GOLDEN_TOL, verbose=False)
        msg += f", final_state max diff {fs.max_diff_pcnt:.3g} %"
    log(f"[ring] {deck} over {n} shards: golden ({GOLDEN_TOL:g} %): {msg}")
    if not (av_ok and fs_ok):
        raise AssertionError(f"{deck} over {n} shards: golden check failed")
    _free()


def _ring_busy():
    """Device time against wall time of 50 chunks of the 1024^2 ring over
    4 shards, from a torch.profiler trace: the sum of the device events'
    self time (kernels and copies) over the wall time of the runner call
    and its readback. Off the main path: its launches are not counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh

    p, o = _load_deck("1024x1024")
    mesh = get_mesh(4)
    fs, obs = sharding.shard_rows(_state(p, SEED + 12), o != 0, mesh)
    run = runner.make_runner(p, 400, "cuda", mesh=mesh)
    run(fs, obs)[1].cpu()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(fs, obs)[1].cpu()
        wall = time.perf_counter() - t0
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    log(f"[ring] 1024x1024 over 4 shards, 50 chunks under torch.profiler: "
        f"wall {wall * 1e3:.3f} ms, device time {device_us / 1e3:.3f} ms, "
        f"busy {100 * device_us / 1e6 / wall:.1f} %")


def phase_ring(one_card):
    """The ring's main path (see the module docstring). one_card: the final
    state (on the host) and av series of phase 4's single-device K4 run of
    the wide deck."""
    import numpy as np
    import torch

    from tpulbm_torch.ops import _build

    totals = dict.fromkeys(_build.LAUNCHES, 0)
    for deck, steps, n, extra in RING_RUNS:
        _ring_golden(deck, steps, n, extra, totals)
    _ring_busy()

    # 8192^2 over 4 shards, full width and steps, against one card's K4
    deck, steps, n = RING_WIDE_RUN
    sim, _ = _ring_cli(deck, steps, n, [], totals)
    f_ring, av_ring = sim.f, sim.av_vels.copy()
    del sim
    f_one = one_card["f"].to(f_ring.device)
    diff = (f_ring - f_one).abs().max().item()
    same = torch.equal(f_ring, f_one)
    rel = _max_rel_pct(av_ring, one_card["av"])
    log(f"[ring] {deck} over {n} shards vs one card (phase 4's K4 run): "
        f"max|df| {diff:.3e} (<= {F_ATOL:g}), state bitwise {same}; av max "
        f"diff {rel:.3g} % (<= {GOLDEN_TOL:g} %)")
    if not (same and rel <= GOLDEN_TOL
            and np.isfinite(av_ring).all() and av_ring.shape == (steps,)):
        raise AssertionError(f"{deck} over {n} shards disagrees with one card")
    del f_ring, f_one
    _free()
    return totals


KERNELS = [
    # (counter, name, source, replaces)
    ("cluster_resident", "lbm_cluster_chunk (K5)",
     "tpulbm_torch/csrc/cluster.cu", "tpulbm/ops/pallas_resident.py:63"),
    ("resident_chunk", "lbm_resident_chunk (K2)",
     "tpulbm_torch/csrc/resident.cu",
     "tpulbm/ops/pallas_resident.py:63, tpulbm/ops/pallas_resident.py:107"),
    ("skew_chunk", "lbm_fused_step (K1, skew_chunk; off the route, the "
     "one-step reference of K4)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/pallas_kstep_skew.py:94"),
    ("kstep_chunk", "lbm_fused_step (K1, kstep_chunk; off the route)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/pallas_kstep.py:79"),
    ("reduce_partials", "reduce_row / reduce_rows (the former K3 "
     "lbm_reduce_partials, now the epilogue of K1, K2, K4 and K5; launches "
     "count the chunks it reduced)",
     "tpulbm_torch/csrc/lbm_cell.cuh", "tpulbm/ops/window_step.py:384"),
    ("tile_chunk", "lbm_kstep_tile (K4, tile_chunk: whole grid)",
     "tpulbm_torch/csrc/kstep_tile.cu",
     "tpulbm/ops/pallas_kstep_skew.py:94, tpulbm/ops/pallas_kstep.py:79, "
     "tpulbm/ops/pallas_kstep_skew_fold.py:118, "
     "tpulbm/ops/pallas_kstep_skew_fold.py:497, "
     "tpulbm/ops/pallas_kstep_skew2d.py:112, "
     "tpulbm/ops/pallas_kstep_skew.py:751, tpulbm/ops/pallas_kstep2d.py:79"),
    ("ring_chunk", "lbm_kstep_tile (K4, ring_chunk: ring mode, the per-shard "
     "body of the 1-D ring and the seam fixes' function)",
     "tpulbm_torch/csrc/kstep_tile.cu",
     "tpulbm/ops/pallas_kstep_skew.py:94, tpulbm/ops/pallas_kstep_skew.py:641, "
     "tpulbm/ops/pallas_kstep_skew.py:751, tpulbm/ops/pallas_kstep.py:79, "
     "tpulbm/ops/pallas_kstep_skew_fold.py:118, "
     "tpulbm/ops/pallas_kstep_skew_fold.py:497, "
     "tpulbm/ops/pallas_kstep_skew2d.py:112, tpulbm/ops/pallas_kstep2d.py:79, "
     "tpulbm/ops/pallas_kstep_bands.py:118, tpulbm/ops/pallas_step.py:55, "
     "tpulbm/ops/pallas_kstep_rdma.py:65, "
     "tpulbm/ops/pallas_resident_rdma.py:63"),
]


def phase_cards():
    """The ring with its shards on distinct cards (``--cards``; needs two
    or more): the kernel-phase check of ``_ring_on_cards``, the 1024^2
    deck over the cards (over twice as many shards, two a card, with
    ``--backend cuda-p2p``; and over 3) and 128^2 through the golden gate,
    and 8192^2 over 4 shards."""
    import torch

    from tpulbm_torch.ops import _build

    if torch.cuda.device_count() < 2:
        raise SystemExit("chip_smoke --cards: needs two or more CUDA devices")
    _ring_on_cards()
    n = min(4, torch.cuda.device_count())
    totals = dict.fromkeys(_build.LAUNCHES, 0)
    for deck, steps, shards, extra in (
            ("1024x1024", 20000, n, []),
            ("1024x1024", 20000, 2 * n, ["--backend", "cuda-p2p"]),
            ("1024x1024", 20000, 3, []), ("128x128", 40000, n, [])):
        _ring_golden(deck, steps, shards, extra, totals)
    deck, steps, _ = RING_WIDE_RUN
    _ring_cli(deck, steps, n, [], totals)
    _free()


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--cards", action="store_true",
        help="run only the ring with its shards on distinct cards (needs "
             "two or more CUDA devices)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    kind = phase_device()
    phase_build()
    if args.cards:
        phase_cards()
        import torch

        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    t0 = time.perf_counter()
    measured, chunk_ms = phase_kernels()
    t1 = time.perf_counter()
    log(f"[time] kernel phase {t1 - t0:.1f} s")
    launches, one_card = phase_main_path(chunk_ms)
    t2 = time.perf_counter()
    log(f"[time] single-device main path {t2 - t1:.1f} s")
    for key, v in phase_ring(one_card).items():
        launches[key] += v
    log(f"[time] ring main path {time.perf_counter() - t2:.1f} s")
    import torch

    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[counter],
                **measured[counter]}
               for counter, name, source, replaces in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
