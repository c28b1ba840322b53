#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpulbm_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one CUDA device

Phases; any failure raises and exits non-zero before the result lines:

1. the device: ``torch.cuda.is_available()``, its name, and nvidia-smi's
   name and power limit;
2. build: nvcc compiles ``tpulbm_torch/csrc/*.cu`` (``ops._build``);
3. each kernel against its plain PyTorch version on the card, on the same
   inputs (made from a seed with numpy), at the shapes the main path gives
   it, with CUDA-event times of both: K2 (``resident_chunk``, one 512-step
   chunk of the 128^2 deck), K1 (``skew_chunk``, 8 steps, and
   ``kstep_chunk``, 3 steps, of the 1024^2 deck) and K3
   (``reduce_partials``); plus the host cost of a launch;
4. the main path: ``tpulbm_torch.cli.main`` on the four reference decks at
   their full step counts, outputs gated at 1 % against ``tests/goldens/``
   by the port's ``validation.check``, launch counts of the path's kernels
   above zero per deck; one more 1024^2 run of 1003 steps takes the
   sub-8-step remainder through ``kstep_chunk``;
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


def _compare_chunk(name, kernel, plain, reps, plain_reps):
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
    log(f"[kernel] {name}: max|df| {err:.3e} (<= {F_ATOL:g}), max av rel "
        f"{av_rel:.3e} (<= {AV_RTOL:g}), rerun bitwise {same}; "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms per chunk")
    if not (err <= F_ATOL and av_rel <= AV_RTOL and same):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err, ms, plain_ms


def phase_kernels():
    import numpy as np
    import torch

    from tpulbm_torch.core.params import LBMParams
    from tpulbm_torch.ops import kstep, resident

    res = {}
    p, o = _load_deck("128x128")
    f0 = _state(p, SEED)
    k = resident.RESIDENT_K
    res["resident_chunk"] = _compare_chunk(
        f"resident_chunk K2 (128x128, {k} steps)",
        lambda: resident.resident_chunk(f0, o, p, k),
        lambda: resident.resident_chunk_ref(f0, o, p, k), 10, 1)

    p, o = _load_deck("1024x1024")
    f0 = _state(p, SEED + 1)
    res["skew_chunk"] = _compare_chunk(
        "skew_chunk K1 (1024x1024, 8 steps)",
        lambda: kstep.skew_chunk(f0, o, p),
        lambda: kstep.skew_chunk_ref(f0, o, p), 50, 3)
    res["kstep_chunk"] = _compare_chunk(
        "kstep_chunk K1 (1024x1024, 3 steps)",
        lambda: kstep.kstep_chunk(f0, o, p, 3),
        lambda: kstep.kstep_chunk_ref(f0, o, p, 3), 50, 3)
    # K3 at the 1024^2 chunk's shape: (8, nblocks of one K1 launch)
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
    log(f"[kernel] reduce_partials K3 ({kstep.SKEW_K}x{nblocks}): max abs "
        f"{k3_err:.3e}, rel {k3_rel:.3e} (<= {K3_RTOL:g}); {k3_ms:.4f} ms vs "
        f"plain {k3_plain:.4f} ms")
    if not k3_rel <= K3_RTOL:
        raise AssertionError("reduce_partials disagrees with torch.sum")
    res["reduce_partials"] = (k3_err, k3_ms, k3_plain)

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
        f"{res['skew_chunk'][1] * 1e3:.2f} us per 1024^2 chunk")
    return res


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


def _check_launches(deck, counts, needed):
    log(f"    launches: {counts}")
    missing = [k for k in needed if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{deck}: no launch of {missing}")


def phase_main_path():
    import numpy as np

    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.ops import _build
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
        small = p.nx * p.ny <= 100 * 1024
        _check_launches(deck, counts, ["resident_chunk" if small
                                       else "skew_chunk", "reduce_partials"])
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
    rel = 100 * (np.abs(av - ref) / np.abs(ref)).max()
    log(f"[main] {deck} x {steps}: av_vels prefix max diff {rel:.3g} % "
        f"(abs over min |ref| {pct:.3g} %)")
    if not (av.shape == (steps,) and rel <= GOLDEN_TOL):
        raise AssertionError(f"{deck} x {steps}: golden prefix check failed")
    return totals


KERNELS = [
    # (counter, name, source, replaces)
    ("resident_chunk", "lbm_resident_chunk (K2)",
     "tpulbm_torch/csrc/resident.cu", "tpulbm/ops/pallas_resident.py:63"),
    ("skew_chunk", "lbm_fused_step (K1, skew_chunk)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/pallas_kstep_skew.py:94"),
    ("kstep_chunk", "lbm_fused_step (K1, kstep_chunk)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/pallas_kstep.py:79"),
    ("reduce_partials", "lbm_reduce_partials (K3)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/window_step.py:384"),
]


def main() -> int:
    sys.path.insert(0, ROOT)
    kind = phase_device()
    phase_build()
    measured = phase_kernels()
    launches = phase_main_path()
    import torch

    kernels = []
    for counter, name, source, replaces in KERNELS:
        err, ms, plain_ms = measured[counter]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[counter],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
