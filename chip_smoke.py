#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpulbm_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one CUDA device

Phases; any failure raises and exits non-zero before the result lines:

1. the device: ``torch.cuda.is_available()``, its name, and nvidia-smi's
   name and power limit;
2. build: nvcc compiles ``tpulbm_torch/csrc/*.cu`` (``ops._build``);
3. each kernel against its plain PyTorch version on the card, on the same
   inputs (made from a seed with numpy), at the shapes the main path gives
   it, with CUDA-event times of both, a bitwise rerun and the bound (the
   least time the H100 could take for the same work): K2
   (``resident_chunk``, one 512-step chunk of the 128^2 deck and of a
   256x512 grid, the HBM-edge resident tier's), K1 (``skew_chunk``, 8
   steps, and ``kstep_chunk``, 3 steps, of the 1024^2 deck), K3
   (``reduce_partials``, beside ``torch.sum``), K4 (``tile_chunk``, 8 steps
   at 2048^2 and 8192^2 and 3 steps at 2048^2; ``band_chunk`` on the
   8192^2 seam-fix band and the 4096^2 fold-fix band) and K4 against K1 on
   one 2048^2 chunk; plus the host cost of a launch;
4. the main path, launch counts set to 0 just before each run and read
   just after: ``tpulbm_torch.cli.main`` on the four reference decks at
   their full step counts, outputs gated at 1 % against ``tests/goldens/``
   by the port's ``validation.check``; one more 1024^2 run of 1003 steps
   takes the sub-8-step remainder through ``kstep_chunk``. The wide decks
   (2048^2, 4096^2, 8192^2) through ``cli.main`` with ``--no-output``
   (8192^2's final_state.dat would be 67M lines) at their full step
   counts, on K4: launches, MLUPS, peak device memory; their av series,
   from a ``Simulation`` rerun that gives the same Reynolds bits, within
   1 % of the same deck run through K1; 2048^2 for 1003 steps takes the
   remainder through ``tile_chunk``, its Reynolds number within 1 % of
   the K1 route's; 1024^2 through a K4 plan against its golden at 1 %;
5. one JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``.
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
K3_RTOL = 1e-6         # reduce_partials vs torch.sum, relative (1.2e-7)
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
    log_path = _build.BUILD_DIR / "build.log"
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                log(f"[build] {line.strip()}")


def _state(params, seed):
    """The deck's rest state with a 1 % seeded perturbation, on the card."""
    import numpy as np
    import torch

    from tpulbm_torch.core.state import initial_state

    noise = np.random.RandomState(seed).rand(9, params.ny, params.nx)
    return initial_state(params, "cuda") * torch.tensor(
        1 + 0.01 * noise, dtype=torch.float32, device="cuda")


def _load_deck(deck):
    import torch

    from tpulbm_torch.io.obstacles import read_obstacles
    from tpulbm_torch.io.params_file import read_params

    pf, of = deck_files(deck)
    p = read_params(pf)
    mask, n_free = read_obstacles(of, p.nx, p.ny)
    obst_f = torch.tensor(mask, dtype=torch.float32, device="cuda")
    return p.with_free_cells(n_free), obst_f


def _compare_chunk(name, kernel, plain, reps, plain_reps, bound_of):
    """Kernel vs plain on the same inputs: max|df|, max relative difference
    of the per-step sums, bitwise rerun, CUDA-event ms of both, the bound
    ((ms, "bytes" | "operations")). Returns the record of the kernels JSON
    line."""
    import torch

    f_k, s_k = kernel()
    f_r, s_r = plain()
    torch.cuda.synchronize()
    err = (f_k - f_r).abs().max().item()
    av_rel = ((s_k - s_r).abs() / s_r.abs()).max().item()
    f_k2, s_k2 = kernel()
    same = torch.equal(f_k, f_k2) and torch.equal(s_k, s_k2)
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, plain_reps)
    bound_ms, bound_by = bound_of
    log(f"[kernel] {name}: max|df| {err:.3e} (<= {F_ATOL:g}), max av rel "
        f"{av_rel:.3e} (<= {AV_RTOL:g}), rerun bitwise {same}; "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms per chunk; bound "
        f"{bound_ms:.4f} ms ({bound_by}), bound/kernel "
        f"{100 * bound_ms / ms:.1f} %")
    if not (err <= F_ATOL and av_rel <= AV_RTOL and same):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_kernels():
    import numpy as np
    import torch

    from tpulbm_torch.core.params import LBMParams
    from tpulbm_torch.ops import kstep, kstep_tile, resident

    res = {}
    chunk_ms = {}   # K4 8-step chunk records of the wide decks
    k = resident.RESIDENT_K
    p, o = _load_deck("128x128")
    f0 = _state(p, SEED)
    res["resident_chunk"] = _compare_chunk(
        f"resident_chunk K2 (128x128, {k} steps)",
        lambda: resident.resident_chunk(f0, o, p, k),
        lambda: resident.resident_chunk_ref(f0, o, p, k), 10, 1,
        chunk_bound(p.ny * p.nx, k))
    # The HBM-edge resident tier's shape (100K-135K aligned cells)
    p = LBMParams(nx=512, ny=256, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    mask = np.random.RandomState(SEED + 4).rand(p.ny, p.nx) < 0.1
    p = p.with_free_cells(p.ny * p.nx - int(mask.sum()))
    o = torch.tensor(mask, dtype=torch.float32, device="cuda")
    f0 = _state(p, SEED + 5)
    _compare_chunk(
        f"resident_chunk K2 (256x512, {k} steps)",
        lambda: resident.resident_chunk(f0, o, p, k),
        lambda: resident.resident_chunk_ref(f0, o, p, k), 10, 1,
        chunk_bound(p.ny * p.nx, k))

    p, o = _load_deck("1024x1024")
    f0 = _state(p, SEED + 1)
    res["skew_chunk"] = _compare_chunk(
        "skew_chunk K1 (1024x1024, 8 steps)",
        lambda: kstep.skew_chunk(f0, o, p),
        lambda: kstep.skew_chunk_ref(f0, o, p), 50, 3,
        chunk_bound(p.ny * p.nx, 8))
    res["kstep_chunk"] = _compare_chunk(
        "kstep_chunk K1 (1024x1024, 3 steps)",
        lambda: kstep.kstep_chunk(f0, o, p, 3),
        lambda: kstep.kstep_chunk_ref(f0, o, p, 3), 50, 3,
        chunk_bound(p.ny * p.nx, 3))
    # K3 at the 1024^2 chunk's shape: (8, nblocks of one K1 launch). Its
    # plain version is itself one PyTorch call, torch.sum, timed as both.
    nblocks = -(-p.ny * p.nx // 256)
    parts = torch.tensor(
        np.random.RandomState(SEED + 2).rand(kstep.SKEW_K, nblocks),
        dtype=torch.float32, device="cuda")
    got = kstep.reduce_partials(parts)
    want = kstep.reduce_partials_ref(parts)
    k3_err = (got - want).abs().max().item()
    k3_rel = ((got - want).abs() / want.abs()).max().item()
    k3_ms = cuda_ms(lambda: kstep.reduce_partials(parts), 200)
    k3_plain = cuda_ms(lambda: kstep.reduce_partials_ref(parts), 200)
    k3_lib = cuda_ms(lambda: torch.sum(parts, dim=1), 200)
    k3_bound, k3_by = bound(4 * (kstep.SKEW_K * nblocks + kstep.SKEW_K),
                            kstep.SKEW_K * (nblocks - 1))
    log(f"[kernel] reduce_partials K3 ({kstep.SKEW_K}x{nblocks}): max abs "
        f"{k3_err:.3e}, rel {k3_rel:.3e} (<= {K3_RTOL:g}); {k3_ms:.4f} ms vs "
        f"plain {k3_plain:.4f} ms, torch.sum {k3_lib:.4f} ms; bound "
        f"{k3_bound:.5f} ms ({k3_by})")
    if not k3_rel <= K3_RTOL:
        raise AssertionError("reduce_partials disagrees with torch.sum")
    res["reduce_partials"] = {
        "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain,
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": k3_lib}

    # K4 at the wide decks' shapes: whole grid (8 steps, and the 3-step
    # remainder) and the seam bands of the TPU tiers it replaces.
    p, o = _load_deck("2048x2048")
    f0 = _state(p, SEED + 6)
    chunk_ms["2048x2048"] = _compare_chunk(
        "tile_chunk K4 (2048x2048, 8 steps)",
        lambda: kstep_tile.tile_chunk(f0, o, p, 8),
        lambda: kstep_tile.tile_chunk_ref(f0, o, p, 8), 50, 2,
        chunk_bound(p.ny * p.nx, 8))
    _compare_chunk(
        "tile_chunk K4 (2048x2048, 3 steps)",
        lambda: kstep_tile.tile_chunk(f0, o, p, 3),
        lambda: kstep_tile.tile_chunk_ref(f0, o, p, 3), 50, 2,
        chunk_bound(p.ny * p.nx, 3))
    f4, s4 = kstep_tile.tile_chunk(f0, o, p, 8)
    f1, s1 = kstep.skew_chunk(f0, o, p)
    log(f"[kernel] tile_chunk K4 vs skew_chunk K1 (2048x2048, 8 steps, same "
        f"input): max|df| {(f4 - f1).abs().max().item():.3e}, state bitwise "
        f"{torch.equal(f4, f1)}; max sums rel "
        f"{((s4 - s1).abs() / s1.abs()).max().item():.3e}")
    del f0, f4, f1
    _free()

    p, o = _load_deck("8192x8192")
    f0 = _state(p, SEED + 7)
    res["tile_chunk"] = chunk_ms["8192x8192"] = _compare_chunk(
        "tile_chunk K4 (8192x8192, 8 steps)",
        lambda: kstep_tile.tile_chunk(f0, o, p, 8),
        lambda: kstep_tile.tile_chunk_ref(f0, o, p, 8), 10, 1,
        chunk_bound(p.ny * p.nx, 8))
    # The seam band of the 2-D skew's fix at 8192^2: rows [-2K, 2K), which
    # hold the accelerated row ny-2.
    rows = torch.arange(-16, 16, device="cuda") % p.ny
    band, ob = f0[:, rows].contiguous(), o[rows].contiguous()
    base = p.ny - 16
    res["band_chunk"] = _compare_chunk(
        "band_chunk K4 (8192x8192 seam band, 32 rows, 8 steps)",
        lambda: kstep_tile.band_chunk(band, ob, p, 8, base),
        lambda: kstep_tile.band_chunk_ref(band, ob, p, 8, base), 200, 5,
        band_bound(32, p.nx, 8))
    del f0, band
    _free()
    # The fold fix's band at 4096^2 (F=4): rows [-(m+K), m+K), m = 14
    p, o = _load_deck("4096x4096")
    f0 = _state(p, SEED + 8)
    chunk_ms["4096x4096"] = _compare_chunk(
        "tile_chunk K4 (4096x4096, 8 steps)",
        lambda: kstep_tile.tile_chunk(f0, o, p, 8),
        lambda: kstep_tile.tile_chunk_ref(f0, o, p, 8), 20, 1,
        chunk_bound(p.ny * p.nx, 8))
    rows = torch.arange(-22, 22, device="cuda") % p.ny
    band, ob = f0[:, rows].contiguous(), o[rows].contiguous()
    base = p.ny - 22
    _compare_chunk(
        "band_chunk K4 (4096x4096 fold band, 44 rows, 8 steps)",
        lambda: kstep_tile.band_chunk(band, ob, p, 8, base),
        lambda: kstep_tile.band_chunk_ref(band, ob, p, 8, base), 200, 5,
        band_bound(44, p.nx, 8))
    del f0, band
    _free()

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
    log(f"[launch] host {host_us:.2f} us per skew_chunk call (8 K1 + 1 K3 "
        f"launches, {host_us / 9:.2f} us per launch) vs device "
        f"{res['skew_chunk']['ms'] * 1e3:.2f} us per 1024^2 chunk")
    return res, {deck: r["ms"] for deck, r in chunk_ms.items()}


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
    log(f"    launches: {counts}")
    missing = [k for k in needed if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{deck}: no launch of {missing}")
    stray = [k for k in absent if counts[k]]
    if stray:
        raise AssertionError(f"{deck}: launches of {stray} off its route")


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
    busy share of the solve."""
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
                    ["skew_chunk", "kstep_chunk", "resident_chunk"])
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


def phase_main_path(chunk_ms):
    import numpy as np
    import torch

    from tpulbm_torch.core.state import initial_state
    from tpulbm_torch.diag.observables import calc_reynolds
    from tpulbm_torch.dist import runner, tiers
    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.ops import _build, kstep_tile
    from tpulbm_torch.validation import check

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
        route = tiers.family(p.ny, p.nx, steps)
        _check_launches(deck, counts, [
            "resident_chunk" if route == "resident" else "skew_chunk",
            "reduce_partials"])
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
    _check_launches(deck, counts,
                    ["skew_chunk", "kstep_chunk", "reduce_partials"])
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

    for deck, steps in WIDE_DECKS:
        _run_wide(deck, steps, totals, chunk_ms[deck])
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

    # 1024^2 through a K4 plan: the golden K4 can be held against. The CLI
    # routes 1024^2 to K1, so this run is off the main path: its launches
    # are checked here and left out of the totals of the kernels line.
    deck, steps = "1024x1024", 20000
    p, obst_f = _load_deck(deck)
    log(f"[main] {deck} through a K4 plan ({steps} steps)")
    plan = runner._chunks(kstep_tile.tile_chunk, kstep_tile.TILE_K, steps)
    f0 = initial_state(p, "cuda")
    torch.cuda.synchronize()
    _build.reset_launches()
    tic = time.time()
    f, av = runner.run_plan(plan, f0, obst_f, p)
    av = av.cpu().numpy()
    elapsed = time.time() - tic
    counts = dict(_build.LAUNCHES)
    _check_launches(deck, counts, ["tile_chunk", "reduce_partials"],
                    ["skew_chunk", "kstep_chunk"])
    ref = np.loadtxt(os.path.join(golden, f"{deck}.av_vels.dat"),
                     usecols=[1])
    rel = _max_rel_pct(av, ref)
    log(f"[main] {deck} on K4: {elapsed:.3f} s, "
        f"{p.nx * p.ny * steps / elapsed / 1e6:.1f} MLUPS; golden av_vels "
        f"max diff {rel:.3g} % (<= {GOLDEN_TOL:g} %)")
    if not (av.shape == ref.shape and rel <= GOLDEN_TOL):
        raise AssertionError(f"{deck} on K4: golden check failed")
    return totals


KERNELS = [
    # (counter, name, source, replaces)
    ("resident_chunk", "lbm_resident_chunk (K2)",
     "tpulbm_torch/csrc/resident.cu",
     "tpulbm/ops/pallas_resident.py:63, tpulbm/ops/pallas_resident.py:107"),
    ("skew_chunk", "lbm_fused_step (K1, skew_chunk)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/pallas_kstep_skew.py:94"),
    ("kstep_chunk", "lbm_fused_step (K1, kstep_chunk)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/pallas_kstep.py:79"),
    ("reduce_partials", "lbm_reduce_partials (K3)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/window_step.py:384"),
    ("tile_chunk", "lbm_kstep_tile (K4, tile_chunk: whole grid)",
     "tpulbm_torch/csrc/kstep_tile.cu",
     "tpulbm/ops/pallas_kstep_skew_fold.py:118, "
     "tpulbm/ops/pallas_kstep_skew_fold.py:497, "
     "tpulbm/ops/pallas_kstep_skew2d.py:112, "
     "tpulbm/ops/pallas_kstep_skew.py:751, tpulbm/ops/pallas_kstep2d.py:79"),
    ("band_chunk", "lbm_kstep_tile (K4, band_chunk: band mode, the seam "
     "fixes' function; off the single-device path)",
     "tpulbm_torch/csrc/kstep_tile.cu",
     "tpulbm/ops/pallas_kstep_skew_fold.py:497, "
     "tpulbm/ops/pallas_kstep_skew.py:751, "
     "tpulbm/ops/pallas_kstep_skew.py:641"),
]


def main() -> int:
    sys.path.insert(0, ROOT)
    kind = phase_device()
    phase_build()
    measured, chunk_ms = phase_kernels()
    launches = phase_main_path(chunk_ms)
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
