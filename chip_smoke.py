#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpulbm_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one CUDA device
    python3 chip_smoke.py --cards  # only the ring and torus over 2-4 cards
                                   # (phase 12)
    python3 chip_smoke.py --cards --processes   # only phase 12's processes
                                                # on four cards
    python3 chip_smoke.py --cards --torus       # only phase 12's torus (in
                                                # one process and across
                                                # processes)

Phases; any failure raises and exits non-zero before the result lines:

1. the device: ``torch.cuda.is_available()``, its name, and nvidia-smi's
   name and power limit;
2. build: nvcc compiles ``tpulbm_torch/csrc/*.cu``, one process a source
   (``ops._build``; K4's shared memory and CTAs per SM, K2's plan at the
   four resident shapes, and each kernel's ptxas line, by name, are
   logged);
3. each kernel against its plain PyTorch version on the card, on the same
   inputs (made from a seed with numpy), at the shapes the main path gives
   it, with CUDA-event times of both, a bitwise rerun and the bound (the
   least time the H100 could take for the same work): K2
   ``resident_chunk``, one 512-step chunk of each small deck's shape, and
   K4 ``tile_chunk`` over the whole grid, 64 chunks of 8 steps, on the
   same inputs, K2's state bitwise K4's; K2 also on a 256x512 grid, the
   HBM-edge resident tier's, at 512 steps and at the custom example's
   392; each K2 line with its plan (CTAs, halo depth h, cells a thread,
   shared memory a CTA), its time a step and nvidia-smi's name and power
   limit;
   K4 ``tile_chunk`` and K1 (``skew_chunk``, 8 steps, and
   ``kstep_chunk``, 3 steps) on the same 1024^2 inputs, K4's state bitwise
   K1's; K4
   (``tile_chunk``, 8 steps at 2048^2 and 8192^2 and 3 steps at 2048^2;
   ``ring_chunk``, ring mode, on a 2048-row shard of the 8192^2 deck and a
   256-row shard of the 1024^2 deck at 8 steps and at 1 step, and on the
   8192^2 seam-fix band and the 4096^2 fold-fix band, cut into lo, shard
   and hi; ``torus_chunk``, torus mode, on a 512x512 block of the 1024^2
   deck over 2x2 at 8 and 3 steps, a 64x64 block of the 128^2 deck and a
   4096x4096 block of the 8192^2 deck at 8 steps, cut into its five
   pieces) and K4 against K1 on one
   2048^2 chunk (state bitwise); the four blocks of the 1024^2 deck after
   one chunk of the torus runner, bitwise the whole grid's ``tile_chunk``;
   K6 (``ring_p2p``, the cuda-p2p ring) over 64 chunks of the 128^2 deck
   over 2 shards and the 1024^2 and 8192^2 decks over 4 on this card: its
   state and sums bitwise the cuda ring's over the same chunks and on a
   rerun, the error word and the ticket counter 0, against
   ``p2p_chunks_ref`` over all 64 chunks (the state within F_ATOL; the
   sums within AV_RTOL over the first SUMS_GATE_CHUNKS and, over all 64,
   within what a state within F_ATOL allows, ``sums_atol``), CUDA-event
   ms a launch beside the cuda ring's chunk and K4's whole-grid chunk of
   the deck, its bound and K6's ptxas line (registers, spills); K6's
   torus mode (``torus_p2p``, the one-process torus) over the 2x2 blocks
   of 128^2 and 1024^2 for 64 chunks and of 8192^2 for 32: against
   ``torus_p2p_chunks_ref`` over all of them (K6's gates), bitwise on a
   rerun, its state and sums bitwise K4's torus mode with the host's
   copies (the parent route) over all chunks and, in launches of one
   chunk, chunk by chunk (the corners among them), CUDA-event ms a launch
   beside the parent route's chunk, its bound and ptxas line; K6's grid
   kind (``grid_p2p``, the one-card wide route) on the 1024^2, 2048^2,
   4096^2 and 8192^2 decks and a ragged 100 x 130 grid: one launch of 3
   chunks at each k of 1-8 and launches of up to 64 chunks, the state
   bitwise K4's whole-grid chunks and the sums bitwise
   ``ring_p2p.grid_sums_ref`` of the launches' partials (the grid kind's
   own order of summing) and within K3_RTOL of K4's, bitwise on a rerun,
   against ``grid_p2p_chunks_ref`` (K6's gates), two runner calls (the
   epoch carried) bitwise K4's in state and Reynolds number, the av series
   within K3_RTOL, CUDA-event ms a chunk beside K4's chunk and the plain
   version's, its bound, item shape and ptxas line.
   Every
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
   port's ``validation.check`` (av_vels, and the final state's pressure
   against ``check.final_state_golden``: the reference's text golden for
   128^2 and 128x256, the f64-oracle ``.f64.npz`` golden for 256^2 and
   1024^2, as on every run below that reaches the golden gate), each
   through the kernel its route names
   (K2 at 128^2, 128x256 and 256^2, K6's grid kind at 1024^2; no K1 or
   K4 launch); one more 1024^2 run of 1003 steps takes the sub-8-step
   remainder through a launch of its own. The wide decks (2048^2,
   4096^2, 8192^2) through ``cli.main`` with ``--no-output`` (8192^2's
   final_state.dat would be 67M lines) at their full step counts, on the
   grid kind:
   launches, MLUPS, peak device memory (at most PEAK_8192_GIB at 8192^2:
   a run holds two states); their av series, from a
   ``Simulation`` rerun that gives the same Reynolds bits, within 1 % of
   the same deck run through K1; 2048^2 for 1003 steps takes the remainder
   through a grid-kind launch of 3 steps, its Reynolds number within 1 %
   of the K1 route's;
5. checkpoints and profiling on one device: 1024^2 with
   ``--checkpoint-every``, then a second process that resumes its
   10,000-step file with ``--resume`` and runs to the end: both runs'
   output files the same bytes as phase 4's uninterrupted run; the time
   of one checkpoint write; a short ``--profile-dir`` run, the process's
   first profiler session, whose Chrome trace must hold every grid-kind
   launch of its run;
6. the ring, through ``cli.main`` with ``--device-count``: the three
   small reference decks over 2 shards and 1024^2 over 4, each on the
   cuda ring and with ``--backend cuda-p2p`` (K6), at their full step
   counts through the golden gate, the two runs' output files the same
   bytes, and 1024^2 over 3 (uneven); the device's busy share of both
   rings at 1024^2 over 4; 8192^2 over 4 shards with ``--no-output`` on
   both rings, each final state bitwise that of phase 4's single-device K4
   run of the deck and its av series within 1 %, its peak device memory
   at most PEAK_MESH_8192_GIB.
   Each run logs its shard-to-card layout, MLUPS, peak device memory and
   host microseconds per chunk (the time to issue the runner call's
   chunks);
7. the torus, through ``cli.main`` with ``--mesh-shape 2x2`` (one
   process: K6's torus mode, ``torus_p2p`` launches and no
   ``torus_chunk``): 128^2 (64
   columns a block, a width the TPU's torus kernel refuses) and 1024^2 at
   their full step counts through the golden gate; the first 10,000 steps
   of 1024^2 with checkpoints every CKPT_EVERY steps, whose last file then
   resumes on one device (its final_state.dat the same bytes as phase 4's
   run);
   8192^2 with ``--no-output``, its final state bitwise phase 4's
   single-device K4 run and its av series within 1 %; logged and bounded
   as the ring's; 1024^2 over 8x16 for 2,000 steps (128 blocks on the
   card, past torus mode's 64): the runner says so on stderr and takes
   K4's torus mode (``torus_chunk`` launches, no ``torus_p2p``), its final
   state bitwise the single-device K4 run of the same steps and its av
   series within 1 %;
8. several processes, through the port's launcher (``python -m
   tpulbm_torch.dist.launch --local-smoke 2x2``: two processes of two
   shards on the one card, so the transport is gloo with the slabs staged
   through the host): 1024^2 at its full step count with dcp checkpoints
   every CKPT_EVERY steps, through the golden gate and the same bytes as
   phase 6's one-process run over 4 shards; its 10,000-step checkpoint
   resumed in one process over 4 shards, the same bytes; 1024^2 over the
   same two processes with ``--backend cuda-p2p`` (K6 in each process,
   the slabs and flags through CUDA IPC mappings of the other process's
   exchange block on the shared card) at its full step count, the same
   bytes as phase 6's run; the torus over 2x2 on the two processes (K6's
   torus mode in each, the edges, corners and flags through CUDA IPC
   mappings of the other process's exchange block): 1024^2 at its full
   step count through the golden gate, the same bytes as phase 7's
   one-process torus, and 128^2 for 4,000 steps, the bytes of one
   process's. Launches are counted and checked in each process
   (``--launch-counts``: the route's kernel launched, no other); MLUPS, ms
   a chunk, the transport, and process 0's host microseconds of exchange a
   chunk (or, on cuda-p2p and the torus, each process's time to open the
   other processes' exchange blocks) are logged;
   Phases 3-8 log their seconds, and their sum;
9. the Python API's path, the two examples through their ``main`` at full
   size (``phase_examples``): ``examples/torch_run_reference_deck.py`` on
   128^2 (40,000 steps, K2) through the golden gate;
   ``examples/torch_custom_simulation.py``, 20,000 steps of a 256x512 box
   (the HBM-edge resident tier's shape) checkpointed every 5,000 steps,
   every chunk on K2 and none elsewhere, its K2 chunks shorter than 512
   steps against their plain version, its output files within 1 % of the
   same deck run on K4 (whether they are K4's bytes is logged), its
   resumed Simulation and one resumed from step 10,000 and run to the end
   the uninterrupted run's bytes; each example's MLUPS and the phase's
   time beside nvidia-smi's name and power limit;
10. the float64 oracle on the card (``phase_f64``;
   ``tpulbm_torch.tools.validate_f64`` and ``make_f64_goldens``): 256^2
   for its full 80,000 steps, the av series within 1e-4 of the upstream
   golden over every step, the pressure golden regenerated under build/
   and within 1e-6 (relative) of the committed
   ``tests/goldens/256x256.final_state.f64.npz``, and phase 4's 256^2 K2
   run's ``final_state.dat`` through the 1 % gate against the regenerated
   golden; the oracle's CUDA-graph path bitwise its eager path on 2,000
   steps of 256^2 and 100 of 1024^2, both timed; the first 100 steps of
   1024^2 within F64_PREFIX_TOL of the golden; the study of 128^2 over
   2,000 steps, the port's f32 route (K2, launches counted) within
   F64_STUDY_TOL of the oracle; seconds and MLUPS beside nvidia-smi's name
   and power limit;
11. one JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``;
12. with ``--cards``, instead of phases 3-11: the ring with shard i on card
    i (the cuda and the cuda-p2p ring, whose K6 hands slabs and flags
    through peer memory), and the torus with block (i, j) on card 2i + j
    (K6's torus mode through peer memory; 1024^2 and 8192^2 bitwise one
    card, and each on both torus routes in turns, ``tools/ring_ab.py
    --mesh-shape 2x2``) (``phase_cards``);
    on four cards, the launcher's NCCL transport: 2 processes x 2 cards
    and 4 x 1, each on the cuda ring and on cuda-p2p (K6 across processes
    through CUDA IPC), 1024^2 (the bytes of the one-process ring, the final
    state of one card) and 8192^2 (its state, from a dcp checkpoint,
    bitwise one card's K4 run), the two backends' MLUPS side by side; the
    torus over 2x2 as 2 processes x 2 cards and 4 x 1 (K6's torus mode
    across processes), 1024^2 (the bytes of the one-process torus over the
    four cards, the final state of one card) and 8192^2 (bitwise one
    card's K4 run), and each on both torus routes in turns across the
    processes (``tools/ring_ab.py`` under the launcher: K6's torus mode and
    K4's over NCCL); 128^2 over 2x4 as 8 processes, two a card (8
    (process, card)s, 6 flag arrays a card), 1,000 steps, the bytes of one
    process's 2x4 run on the four cards; then the result line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
# The output directories this run has written, which a later phase may hold
# its runs against; a directory left by an earlier run is never read.
MADE = set()
SEED = 20260
# (deck, steps); the final-state golden of each is the reference's text
# file or the f64-oracle pressure golden (validation.check.final_state_golden)
DECKS = [("128x128", 40000), ("128x256", 40000), ("256x256", 80000),
         ("1024x1024", 20000)]
REMAINDER_RUN = ("1024x1024", 1003)
# The wide decks (data/, generated by the JAX package's make_deck; no
# goldens): K4 through Simulation, held against the same deck through K1.
WIDE_DECKS = [("2048x2048", 4000), ("4096x4096", 2000), ("8192x8192", 1000)]
WIDE_REMAINDER_RUN = ("2048x2048", 1003)
# Peak device memory of the 8192^2 deck on one card: a runner call takes its
# input over and each chunk writes where the chunk before it read, so a run
# holds two states (2 x 2.25 GiB) and the bool and float masks (0.3125 GiB),
# and the grid kind a launch's partials (16 MiB) and its tile graph (10 MiB).
PEAK_8192_GIB = 4.9
# ... and over a ring of 4 or a 2x2 torus on one card, which hold the bool
# mask's shards (0.0625 GiB), float mask bands in place of the float mask
# (0.25 GiB of 2048 + 16 rows or 4096 + 16 by 4096 + 16) and a chunk's
# slabs (0.02 GiB) beside the two states: 4.9 GiB.
PEAK_MESH_8192_GIB = 5.0
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


def block_bound(h, w, k):
    """k steps of an (h, w) torus block given its neighbours' k-wide
    slabs: the (h + 2k) x (w + 2k) band (populations and mask) in, the
    block and k sums out; the updates of the block's dependence cone,
    (h + 2(k - 1 - s)) x (w + 2(k - 1 - s)) cells at step s."""
    cone = sum((h + 2 * (k - 1 - s)) * (w + 2 * (k - 1 - s))
               for s in range(k))
    return bound(4 * (10 * (h + 2 * k) * (w + 2 * k) + 9 * h * w) + 4 * k,
                 OPS_PER_UPDATE * cone)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    torch.cuda.set_device(0)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); device 0: {kind}")
    log(_smi())
    return kind


def _smi():
    """The first card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_build():
    import torch

    from tpulbm_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s -> {_build.build()}")
    for k in (8, 3):
        log(f"[build] K4 at k = {k}: {_build.library().lbm_kstep_tile_smem(k)} "
            f"B of dynamic shared memory, "
            f"{_build.library().lbm_kstep_tile_ctas_per_sm(k)} CTA(s) per SM")
    from tpulbm_torch.ops import resident

    for deck, (ny, nx) in (("128x128", (128, 128)), ("128x256", (256, 128)),
                           ("256x256", (256, 256)), ("256x512", (256, 512))):
        cy, cx, h, cells, threads, smem = resident.launch_plan(
            ny, nx, torch.device("cuda"))
        log(f"[build] K2 at {deck}: {cy} x {cx} CTAs of {threads} threads, "
            f"h = {h}, {cells} cell(s) a thread, {smem} B of dynamic shared "
            f"memory a CTA")
    log_path = _build.BUILD_DIR / "build.log"
    if log_path.exists():
        name = ""
        for line in log_path.read_text().splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                name = _kernel_name(entry.group(1))
            elif ("ptxas info" in line and "Used" in line) or "spill" in line:
                log(f"[build] {name}: {line.replace('ptxas info    :', '').strip()}")


def _kernel_name(mangled):
    """A kernel's name and template arguments from its mangled name
    (resident_kernel<1, 512>)."""
    arg = r"L(?:i|NS_\d+\w+?E)(\d+)E"
    for m in re.finditer(
            rf"(?=(\d\d?)([a-z_]\w*?kernel)((?:I(?:{arg})+E)?))", mangled):
        if int(m.group(1)) == len(m.group(2)):
            args = re.findall(arg, m.group(3))
            return m.group(2) + (f"<{', '.join(args)}>" if args else "")
    return mangled


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


def _compare_chunk(name, kernel, plain, reps, plain_reps, bound_of,
                   sums_atol_of=None):
    """Kernel vs plain on the same inputs: max|df|, max relative difference
    of the per-step sums, bitwise rerun, CUDA-event ms of both, the bound
    ((ms, "bytes" | "operations")). kernel() returns (f, sums, partials):
    the sums are also held against the partials (_check_epilogue). plain:
    the plain version, or its _plain result. The sums are held within
    AV_RTOL at every step; with ``sums_atol_of`` (the plain state -> the
    sums' absolute bound, ``sums_atol``), as K6's over many chunks: within
    AV_RTOL over the first SUMS_GATE_CHUNKS chunks of 8 steps and within
    the absolute bound at every step. Returns the record of the kernels
    JSON line."""
    import torch

    if callable(plain):
        plain = _plain(plain, plain_reps)
    (f_r, s_r), plain_ms = plain
    f_k, s_k, parts = kernel()
    torch.cuda.synchronize()
    err = (f_k - f_r).abs().max().item()
    rel = (s_k - s_r).abs() / s_r.abs()
    av_rel = rel.max().item()
    sums_gate, sums_ok = f"(<= {AV_RTOL:g})", av_rel <= AV_RTOL
    if sums_atol_of is not None:
        head = rel[:SUMS_GATE_CHUNKS * 8].max().item()
        diff = (s_k - s_r).abs().max().item()
        atol = sums_atol_of(f_r)
        sums_ok = head <= AV_RTOL and diff <= atol
        sums_gate = (f"({head:.3e} over the first {SUMS_GATE_CHUNKS * 8} "
                     f"steps, <= {AV_RTOL:g}; max abs raw sums diff "
                     f"{diff:.4e} over all, <= {atol:.4e}: the free cells x "
                     f"the |u| error F_ATOL allows)")
    k3_rel = _check_epilogue(name, s_k, parts)
    f_k2, s_k2, _ = kernel()
    same = torch.equal(f_k, f_k2) and torch.equal(s_k, s_k2)
    _check_epilogue(name, s_k2, parts)
    del parts
    ms = cuda_ms(kernel, reps)
    bound_ms, bound_by = bound_of
    log(f"[kernel] {name}: max|df| {err:.3e} (<= {F_ATOL:g}), max av rel "
        f"{av_rel:.3e} {sums_gate}, rerun bitwise {same}, in-kernel "
        f"sums vs their partials rel {k3_rel:.3e} (<= {K3_RTOL:g}); "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms per chunk; bound "
        f"{bound_ms:.4f} ms ({bound_by}), bound/kernel "
        f"{100 * bound_ms / ms:.1f} %")
    if not (err <= F_ATOL and sums_ok and same):
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


def _torus_check(p, o, f0, i0, j0, h, w, k, reps, plain_reps, what):
    """torus_chunk against torus_chunk_ref on the (h, w) block at (i0, j0)
    of the state f0 (mask o); returns _compare_chunk's record."""
    from tpulbm_torch.ops import kstep_tile

    *pieces, base = kstep_tile.torus_pieces(f0, o, i0, j0, h, w, k)
    return _compare_chunk(
        f"torus_chunk K4 torus mode ({what}, {h}x{w} block, {k} "
        f"step{'s' if k > 1 else ''})",
        lambda: kstep_tile._torus_launch(*pieces, p, k, base),
        lambda: kstep_tile.torus_chunk_ref(*pieces, p, k, base),
        reps, plain_reps, block_bound(h, w, k))


def _torus_chunk_is_the_whole_grid(p, o, f0):
    """One 8-step chunk of the cuda torus runner over 2x2 blocks of f0
    (the x, then the y exchange, and one torus_chunk a block): the
    gathered blocks bitwise the whole grid's tile_chunk, the same cell
    arithmetic."""
    import torch

    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh_2d
    from tpulbm_torch.ops import kstep_tile

    whole, sums = kstep_tile.tile_chunk(f0, o, p, 8)
    mesh = get_mesh_2d(2, 2)
    blocks, obst = sharding.shard_blocks(f0, o != 0, mesh)
    out, av = runner.make_runner(p, 8, "cuda", mesh=mesh)(blocks, obst)
    f = sharding.gather_blocks(out, 2, 2, "cuda")
    torch.cuda.synchronize()
    same = torch.equal(f, whole)
    rel = ((av - sums * p.free_cells_inv).abs() / av.abs()).max().item()
    log(f"[kernel] torus runner, one chunk over 2x2 blocks of "
        f"{p.ny}x{p.nx} vs tile_chunk of the whole grid: state bitwise "
        f"{same}, max|df| {(f - whole).abs().max().item():.3e}; av rel "
        f"{rel:.3e} (<= {AV_RTOL:g})")
    if not (same and rel <= AV_RTOL):
        raise AssertionError("the torus's blocks differ from the whole grid")


def p2p_bound(rows, nx, k, n_outer):
    """A K6 launch of n_outer chunks of k steps over shards of `rows` rows:
    the states and their mask bands in once, the states, the landing
    slots' last slabs and the sums out once; k n_outer updates of every
    cell (the shards compute no cell twice)."""
    cells = sum(rows) * nx
    bands = sum(h + 2 * k for h in rows) * nx
    slabs = 2 * 9 * k * nx * len(rows)
    return bound(4 * (9 * cells + bands + 9 * cells + slabs
                      + n_outer * k * len(rows)),
                 OPS_PER_UPDATE * cells * k * n_outer)


# K6 against its plain version over several chunks: the per-step sums drift
# apart by nvcc's FMA contraction, growing about as steps^1.5 (an H100 80GB
# HBM3, 700 W: 1.4e-5 after one chunk, 1.3e-4 after 4, 3.8e-4 after 8,
# 8.2e-3 after 64 at 1024^2), and the cuda ring's K4 chunks drift by the
# same bits; the state stays within F_ATOL. Built with -fmad=false, K6's
# state was bitwise the plain version's and its sums within 2.4e-7 over all
# 64 chunks (the same card). The sums are gated relatively (AV_RTOL) over
# the first SUMS_GATE_CHUNKS chunks, and over every chunk absolutely, by
# what a state within F_ATOL allows (sums_atol); the state over all of
# them, and K6 is held bitwise to the cuda ring over every chunk. K2's
# chunks of the custom example (hundreds of steps on its mask) are gated
# alike (_compare_chunk's sums_atol_of).
SUMS_GATE_CHUNKS = 4


def sums_atol(f, o, free_cells):
    """The largest difference of a step's raw sum of |u| over the free
    cells that a state within F_ATOL of f allows (f: states (9, rows, nx);
    o: their masks, nonzero = blocked): each population off by at most
    F_ATOL moves the momentum by at most 6 sqrt(2) F_ATOL (six populations
    carry each component) and the density rho by 9 F_ATOL, so |u| = |m| /
    rho by at most (6 sqrt(2) + 9 |u|max) F_ATOL / (rho_min - 9 F_ATOL),
    times the free cells; rho_min and |u|max over the free cells of f.
    Returns (the bound, rho_min, |u|max)."""
    import torch

    from tpulbm_torch.core.lattice import CX, CY

    rho_min, u_max = float("inf"), 0.0
    for g, m in zip(f, o):
        free = m == 0
        rho = g.sum(0)
        cx = torch.tensor(CX, dtype=g.dtype, device=g.device)[:, None, None]
        cy = torch.tensor(CY, dtype=g.dtype, device=g.device)[:, None, None]
        u = torch.hypot((g * cx).sum(0), (g * cy).sum(0)) / rho
        rho_min = min(rho_min, rho[free].min().item())
        u_max = max(u_max, u[free].max().item())
    per_cell = ((6 * 2 ** 0.5 + 9 * u_max) * F_ATOL
                / (rho_min - 9 * F_ATOL))
    return free_cells * per_cell, rho_min, u_max


def _p2p_check(deck, n, plain_chunks, seed, chunks=64):
    """K6 (ring_p2p._p2p_launch) over n shards of the deck on this card,
    `chunks` chunks of 8 steps from a perturbed state in launches of
    ring_p2p.outer_per_launch chunks (the first reads the neighbours'
    states, the next ones the landing slots): bitwise on a rerun, its
    state and sums bitwise the cuda ring's (ring_chunk a shard and chunk,
    the slabs copied) over the same chunks, the error word and the ticket
    counter 0; over the first plain_chunks chunks against p2p_chunks_ref
    (the state within F_ATOL, the sums within AV_RTOL over the first
    SUMS_GATE_CHUNKS and within sums_atol over all). CUDA-event ms of a
    launch, of the plain version over the same chunks, of the cuda ring's
    chunks (ring_chunk a shard and the slab copies) and of K4's whole-grid
    chunk of the deck, the bound, and K6's ptxas line. Returns the record of
    the kernels JSON line (one launch)."""
    import torch

    from tpulbm_torch.dist import sharding
    from tpulbm_torch.dist.mesh import get_mesh
    from tpulbm_torch.ops import _build, kstep_tile, ring_p2p
    from tpulbm_torch.tools.p2p_ab import ptxas_lines

    p, o = _load_deck(deck)
    f0 = _state(p, seed)
    mesh = get_mesh(n)
    rows, offsets = sharding.ring_rows(p.ny, n)
    shards = [f0[:, off:off + h].contiguous() for off, h in zip(offsets, rows)]
    k = kstep_tile.TILE_K
    grid_ms = cuda_ms(lambda: kstep_tile._tile_launch(f0, o, p, k),
                      max(1, min(50, 10000 // p.ny)))
    del f0
    _free()
    bands = [o[torch.arange(off - k, off + h + k, device="cuda") % p.ny]
             .contiguous() for off, h in zip(offsets, rows)]
    bases = [(off - k) % p.ny for off in offsets]
    n_outer = ring_p2p.outer_per_launch(rows, p.nx, k)

    def k6(n_chunks):
        ex = ring_p2p.Exchange(mesh, rows, p.nx)
        states = [s.clone() for s in shards]
        spares = [torch.empty_like(s) for s in states]
        ex.barrier()   # the clones are written on each card's stream
        sums, first = [[] for _ in rows], True
        while n_chunks:
            m = min(n_outer, n_chunks)
            got, _ = ring_p2p._p2p_launch(ex, states, spares, bands, p, k, m,
                                          bases, first)
            if m % 2:
                states, spares = spares, states
            for d in range(n):
                sums[d].append(got[d])
            n_chunks, first = n_chunks - m, False
        torch.cuda.synchronize()
        ex.check()
        if _build.ticket_counter("cuda").item() != 0:
            raise AssertionError(f"K6 {deck}: ticket counter left non-zero")
        return states, [torch.cat(t) for t in sums]

    def events(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    f_a, s_a = k6(chunks)
    f_b, s_b = k6(chunks)
    rerun = all(torch.equal(a, b) for a, b in zip(f_a + s_a, f_b + s_b))
    del f_b, s_b

    def ring(n_chunks):
        f, sums = [s.clone() for s in shards], [[] for _ in rows]
        for _ in range(n_chunks):
            new = []
            for d in range(n):
                g, t = kstep_tile.ring_chunk(
                    f[d - 1][:, -k:].contiguous(), f[d],
                    f[(d + 1) % n][:, :k].contiguous(), bands[d], p, k,
                    bases[d])
                new.append(g)
                sums[d].append(t)
            f = new
        return f, [torch.cat(t) for t in sums]

    (f_r, s_r), ring_ms = events(lambda: ring(chunks))
    same_ring = all(torch.equal(a, b) for a, b in zip(f_a + s_a, f_r + s_r))
    del f_r, s_r, f_a, s_a
    _free()
    f_c, s_c = k6(plain_chunks)
    nan = float("nan")
    slots = [[torch.full((2, 9 * 8 * p.nx), nan, device="cuda")
              for _ in rows] for _ in range(2)]
    (f_p, s_p), plain_ms = events(lambda: ring_p2p.p2p_chunks_ref(
        [s.clone() for s in shards], bands, slots[0], slots[1], p, k,
        plain_chunks, 0, bases, True))
    err = max((a - b).abs().max().item() for a, b in zip(f_c, f_p))
    rel = torch.stack([(a - b).abs() / b.abs() for a, b in zip(s_c, s_p)])
    rel = rel.max(dim=0).values.cpu()          # per step, over the shards
    # every chunk, absolutely: each shard's raw sums within the bound of its
    # free cells, from the plain state at the start and at the end
    sums_abs, sums_ok, sums_bound = 0.0, True, float("inf")
    for d in range(n):
        mask = bands[d][k:-k]
        atol = min(sums_atol([g], [mask], int((mask == 0).sum().item()))[0]
                   for g in (shards[d], f_p[d]))
        diff = (s_c[d] - s_p[d]).abs().max().item()
        sums_abs, sums_bound = max(sums_abs, diff), min(sums_bound, atol)
        sums_ok = sums_ok and diff <= atol
    av_rel = rel.max().item()
    drift = ", ".join(f"{c} chunks {rel[:c * k].max().item():.3e}"
                      for c in (1, 2, 4, 8, 16, 32, 64) if c <= plain_chunks)
    del f_c, s_c, f_p, s_p
    _free()
    # one launch of n_outer chunks, in a row (each reads the neighbours'
    # states: the host's view of a launch after another)
    ex = ring_p2p.Exchange(mesh, rows, p.nx)
    states = [s.clone() for s in shards]
    spares = [torch.empty_like(s) for s in states]
    ex.barrier()
    ms = cuda_ms(lambda: ring_p2p._p2p_launch(ex, states, spares, bands, p, k,
                                              n_outer, bases, True), 10)
    ex.check()
    del states, spares
    _free()
    bound_ms, bound_by = p2p_bound(rows, p.nx, k, n_outer)
    ring_per = ring_ms / chunks
    ptxas = "; ".join(line.split(": ", 1)[1].replace("ptxas info    : ", "")
                      for line in ptxas_lines(_build.BUILD_DIR)
                      if line.startswith(f"k={k}:"))
    log(f"[kernel] ring_p2p K6 ({deck} over {n} shards, "
        f"{'/'.join(map(str, rows))} rows, {chunks} chunks of {k} steps in "
        f"launches of {n_outer}): max|df| {err:.3e} (<= {F_ATOL:g}), max av "
        f"rel {av_rel:.3e} at step {int(rel.argmax())} (over the first "
        f"{drift}; <= {AV_RTOL:g} over the first {SUMS_GATE_CHUNKS}), max "
        f"abs raw sums diff {sums_abs:.4e} over all {plain_chunks} (<= "
        f"{sums_bound:.4e} on every shard: its free cells x the |u| error "
        f"F_ATOL allows) against p2p_chunks_ref over {plain_chunks} "
        f"chunks; rerun bitwise {rerun}; state and sums "
        f"bitwise the cuda ring's over {chunks} chunks {same_ring}; "
        f"{ms:.4f} ms a launch ({ms / n_outer:.4f} ms a chunk) vs the cuda "
        f"ring (ring_chunk x {n} and the slab copies) {ring_per:.4f} ms a "
        f"chunk, K6/K4 ring {ms / n_outer / ring_per:.3f}, vs K4's "
        f"whole-grid chunk {grid_ms:.4f} ms, K6/K4 grid "
        f"{ms / n_outer / grid_ms:.3f}; plain "
        f"{plain_ms:.2f} ms for {plain_chunks} chunks; bound {bound_ms:.4f} "
        f"ms a launch ({bound_by}), bound/kernel {100 * bound_ms / ms:.1f} %; "
        f"ptxas ring_p2p_kernel<{k}>: {ptxas or 'not in build.log'}")
    sums_rel = rel[:SUMS_GATE_CHUNKS * k].max().item()
    if not (err <= F_ATOL and sums_rel <= AV_RTOL and sums_ok and rerun
            and same_ring):
        raise AssertionError(f"K6 {deck} over {n}: disagrees with its plain "
                             f"version or the cuda ring")
    if _build.ticket_counter("cuda").item() != 0:
        raise AssertionError("the ticket counter is not 0 after K6")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _grid_p2p_check(p, o, f0, what, chunks, plain_chunks, reps):
    """K6's grid kind (ring_p2p._grid_launch, the one-card wide route) on
    the whole grid p from f0: one launch of 3 chunks at each k of 1-8 (the
    state bitwise K4's whole-grid chunks, the sums bitwise grid_sums_ref of
    the launch's partials and within K3_RTOL of K4's, the ticket counter
    0); then `chunks` chunks of 8 steps in launches of grid_outer_per_launch
    chunks, bitwise on a rerun, the state bitwise K4's chain over the same
    chunks and the sums its grid_sums_ref (within K3_RTOL of K4's); over
    the first plain_chunks chunks against grid_p2p_chunks_ref (the state
    within F_ATOL, the sums within AV_RTOL over the first SUMS_GATE_CHUNKS
    and within sums_atol over all); then two runner calls of make_runner
    (launches of several chunks and a remainder, the epoch carried): state
    and Reynolds number bitwise the same calls on K4, av series within
    K3_RTOL. CUDA-event ms of a launch a chunk beside K4's chunk and the
    plain version's, the bound of a launch (chunk_bound over its steps),
    the item shape and its computed updates an owned one (in the log
    line), the ptxas line of grid_p2p_kernel<8>. Returns the record of the
    kernels JSON line (a chunk)."""
    import numpy as np
    import torch

    from tpulbm_torch.diag.observables import calc_reynolds
    from tpulbm_torch.dist import runner
    from tpulbm_torch.ops import _build, kstep_tile, ring_p2p
    from tpulbm_torch.tools.p2p_ab import ptxas_lines

    def k4(f, k, n):
        sums = []
        for _ in range(n):
            f, s = kstep_tile.tile_chunk(f, o, p, k)
            sums.append(s)
        return f, torch.cat(sums)

    def grid(f, k, n, per):
        """The state after n chunks, the sums, and whether they are bitwise
        grid_sums_ref of the launches' partials."""
        f, spare, sums, ok = f.clone(), torch.empty_like(f), [], True
        while n:
            m = min(per, n)
            s, parts = ring_p2p._grid_launch(f, spare, o, p, k, m)
            parts = parts.cpu().numpy()
            model = np.concatenate([ring_p2p.grid_sums_ref(
                parts[c * k:(c + 1) * k]) for c in range(m)])
            ok = ok and np.array_equal(s.cpu().numpy(), model)
            if m % 2:
                f, spare = spare, f
            sums.append(s)
            n -= m
        return f, torch.cat(sums), ok

    def rel(a, b):
        return ((a - b).abs() / b.abs()).max().item()

    for k in range(1, 9):
        (f_g, s_g, ok), (f_r, s_r) = grid(f0, k, 3, 3), k4(f0, k, 3)
        if not (torch.equal(f_g, f_r) and ok and rel(s_g, s_r) <= K3_RTOL
                and _build.ticket_counter("cuda").item() == 0):
            raise AssertionError(f"grid_p2p {what}, k = {k}: not K4's state "
                                 f"or not its own sums' order")
        del f_g, f_r
    k = kstep_tile.TILE_K
    per = ring_p2p.grid_outer_per_launch(p.ny, p.nx, k)
    f_a, s_a, model_a = grid(f0, k, chunks, per)
    f_b, s_b, _ = grid(f0, k, chunks, per)
    rerun = torch.equal(f_a, f_b) and torch.equal(s_a, s_b)
    del f_b, s_b
    f_r, s_r = k4(f0, k, chunks)
    same_k4 = torch.equal(f_a, f_r) and model_a
    sums_k4 = rel(s_a, s_r)
    del f_a, s_a, f_r, s_r
    _free()
    f_c, s_c, _ = grid(f0, k, plain_chunks, per)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_p, s_p = ring_p2p.grid_p2p_chunks_ref(f0, o, p, k, plain_chunks)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / plain_chunks
    err = (f_c - f_p).abs().max().item()
    rels = ((s_c - s_p).abs() / s_p.abs()).cpu()
    head = rels[:SUMS_GATE_CHUNKS * k].max().item()
    free = int((o == 0).sum().item())
    atol = min(sums_atol([g], [o], free)[0] for g in (f0, f_p))
    diff = (s_c - s_p).abs().max().item()
    del f_c, s_c, f_p, s_p
    _free()
    n = 8 * (per + 2) + 3
    run = runner.make_runner(p, n, "cuda", "cuda")
    plan = runner._chunks(kstep_tile.tile_chunk, k, n)
    f, g = f0.clone(), f0.clone()
    calls, av_rel = True, 0.0
    for _ in range(2):
        f, av = run(f, o != 0)
        g, av_k4 = runner.run_plan(plan, g, o, p)
        calls = calls and torch.equal(f, g)
        av_rel = max(av_rel, rel(av, av_k4))
    calls = calls and av_rel <= K3_RTOL and (
        calc_reynolds(f, o != 0, p).item()
        == calc_reynolds(g, o != 0, p).item())
    del f, g
    _free()
    f, spare = f0.clone(), torch.empty_like(f0)
    ms = cuda_ms(lambda: ring_p2p._grid_launch(f, spare, o, p, k, per),
                 reps) / per
    del f, spare
    k4_ms = cuda_ms(lambda: kstep_tile._tile_launch(f0, o, p, k),
                    max(1, reps * per // 4))
    ring_p2p.grid_exchange(f0.device, p.ny, p.nx).check()
    bound_ms, bound_by = chunk_bound(p.ny * p.nx, k * per)
    bound_ms /= per
    h, w, ratio = ring_p2p.grid_item(p.ny, p.nx, k)
    ptxas = "; ".join(line.split(": ", 1)[1].replace("ptxas info    : ", "")
                      for line in ptxas_lines(_build.BUILD_DIR,
                                              "grid_p2p_kernel")
                      if line.startswith(f"k={k}:"))
    log(f"[kernel] grid_p2p K6 grid kind ({what}, {h} x {w} items, "
        f"{ratio:.3f} updates computed an owned one, {chunks} chunks of {k} "
        f"steps in launches of {per}): state bitwise K4's whole-grid chain "
        f"and sums bitwise grid_sums_ref of the partials {same_k4} (and at "
        f"k = 1-8, 3 chunks a launch: True), sums rel K4's {sums_k4:.3e} "
        f"(<= {K3_RTOL:g}), rerun bitwise {rerun}; two runner calls: state "
        f"and Reynolds bitwise K4's, av rel {av_rel:.3e} {calls}; against "
        f"grid_p2p_chunks_ref over {plain_chunks} chunks: max|df| "
        f"{err:.3e} (<= {F_ATOL:g}), max av rel {head:.3e} over the first "
        f"{SUMS_GATE_CHUNKS} (<= {AV_RTOL:g}), max abs raw sums diff "
        f"{diff:.4e} (<= {atol:.4e}); {ms:.4f} ms a chunk vs K4's "
        f"whole-grid chunk {k4_ms:.4f} ms, grid/K4 {ms / k4_ms:.3f}; plain "
        f"{plain_ms:.3f} ms a chunk; bound {bound_ms:.4f} ms a chunk "
        f"({bound_by}, a launch of {per}), bound/kernel "
        f"{100 * bound_ms / ms:.1f} %; ptxas grid_p2p_kernel<{k}>: "
        f"{ptxas or 'not in build.log'}")
    if not (same_k4 and sums_k4 <= K3_RTOL and rerun and calls
            and err <= F_ATOL and head <= AV_RTOL and diff <= atol):
        raise AssertionError(f"grid_p2p {what}: not K4's state, not its own "
                             f"sums' order, or off its plain version")
    if _build.ticket_counter("cuda").item() != 0:
        raise AssertionError("the ticket counter is not 0 after grid_p2p")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "k4_ms": k4_ms}


def torus_p2p_bound(h, w, n, k, n_outer):
    """A torus-mode launch of n_outer chunks of k steps over n (h, w)
    blocks: the states and their mask bands in once, the states, the
    landing slots' last slabs (two x slabs of h x k and two y slabs of
    k x (w + 2k) a block) and the sums out once; k n_outer updates of
    every cell (the blocks compute no cell twice)."""
    cells = n * h * w
    bands = n * (h + 2 * k) * (w + 2 * k)
    slabs = n * 9 * (2 * h * k + 2 * k * (w + 2 * k))
    return bound(4 * (9 * cells + bands + 9 * cells + slabs
                      + n_outer * k * n),
                 OPS_PER_UPDATE * cells * k * n_outer)


def _torus_p2p_check(deck, chunks, seed, dy=2, dx=2):
    """Torus mode of K6 (ring_p2p._torus_launch) over the deck's dy x dx
    blocks on this card, `chunks` chunks of 8 steps from a perturbed state.
    In launches of ring_p2p.outer_per_launch chunks (the first reads
    the neighbours' states, the next ones the landing slots): bitwise on a
    rerun; the state after all chunks and every chunk's sums bitwise K4's
    torus mode (the parent route: the host's two-phase exchange and one
    torus_chunk a block and chunk); against torus_p2p_chunks_ref over the
    same chunks (the state within F_ATOL, the sums within AV_RTOL over the
    first SUMS_GATE_CHUNKS and within sums_atol over all). In launches of
    one chunk, in lockstep with K4's torus mode: every chunk's state (the
    blocks' corner cells among them) and sums bitwise. The error word and
    the ticket counter 0. CUDA-event ms of a launch (and a chunk) beside
    the parent route's chunk (its torus_chunk launches and the host's
    copies) and one torus_chunk launch, the plain version's over the same
    chunks, the bound, and the kernel's ptxas line. Returns the record of
    the kernels JSON line (one launch)."""
    import torch

    from tpulbm_torch.dist import multihost, runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh_2d
    from tpulbm_torch.ops import _build, kstep_tile, ring_p2p
    from tpulbm_torch.tools.p2p_ab import ptxas_lines

    p, o = _load_deck(deck)
    f0 = _state(p, seed)
    mesh = get_mesh_2d(dy, dx)
    n, (h, w), k = dy * dx, sharding.block_shape(p.ny, p.nx, dy, dx), 8
    blocks, obs = sharding.shard_blocks(f0, o != 0, mesh)
    del f0
    tr = multihost.Transport([d for row in mesh for d in row])
    bands = runner._torus_mask_bands(tr, obs, {k}, dy, dx, h, w)[k]
    del obs
    bases = [(b // dx * h - k) % p.ny for b in range(n)]
    n_outer = ring_p2p.outer_per_launch([h], w, k)
    pieces = runner._torus_pieces(k, dy, dx, (9,), h, w)

    def k4_chunk(f):
        """One chunk of the parent route: (the blocks, (n, k) sums)."""
        halos = runner._torus_halos(tr, pieces, f, n)
        step = [kstep_tile.torus_chunk(xlo, f[b], xhi, ylo, yhi, bands[b], p,
                                       k, bases[b])
                for b, (xlo, xhi, ylo, yhi) in enumerate(halos)]
        return [g for g, _ in step], torch.stack([s for _, s in step])

    def p2p(n_chunks, per=n_outer, each=None):
        ex = ring_p2p.TorusExchange(mesh, h, w)
        states = [b.clone() for b in blocks]
        spares = [torch.empty_like(b) for b in blocks]
        sums, first, c = [], True, 0
        while c < n_chunks:
            m = min(per, n_chunks - c)
            got, _ = ring_p2p._torus_launch(ex, states, spares, bands, p, k,
                                            m, bases, first)
            if m % 2:
                states, spares = spares, states
            sums.append(torch.stack(got))
            if each:
                each(c, states, sums[-1])
            c, first = c + m, False
        torch.cuda.synchronize()
        ex.check()
        if _build.ticket_counter("cuda").item() != 0:
            raise AssertionError(f"torus mode {deck}: ticket counter left "
                                 f"non-zero")
        return states, torch.cat(sums, 1)

    f_a, s_a = p2p(chunks)
    f_b, s_b = p2p(chunks)
    rerun = torch.equal(s_a, s_b) and all(torch.equal(a, b)
                                          for a, b in zip(f_a, f_b))
    del f_b, s_b
    f_r, sums_r = [b.clone() for b in blocks], []
    for _ in range(chunks):
        f_r, s = k4_chunk(f_r)
        sums_r.append(s)
    same_k4 = torch.equal(s_a, torch.cat(sums_r, 1)) and all(
        torch.equal(a, b) for a, b in zip(f_a, f_r))
    del f_r, sums_r
    _free()
    # launches of one chunk in lockstep with the parent route
    lock = {"f": [b.clone() for b in blocks], "same": True, "corners": True}

    def step_k4(c, states, s):
        lock["f"], s_r = k4_chunk(lock["f"])
        lock["same"] &= torch.equal(s, s_r) and all(
            torch.equal(a, b) for a, b in zip(states, lock["f"]))
        for a, b in zip(states, lock["f"]):
            for rows in (slice(0, k), slice(h - k, h)):
                for cols in (slice(0, k), slice(w - k, w)):
                    lock["corners"] &= torch.equal(a[:, rows, cols],
                                                   b[:, rows, cols])

    p2p(chunks, per=1, each=step_k4)
    del lock["f"]
    nan = float("nan")
    land = [{name: torch.full((2, m), nan, device="cuda")
             for name, m in ring_p2p.torus_buffer_floats(h, w).items()}
            for _ in range(n)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    f_p, s_p = ring_p2p.torus_p2p_chunks_ref(
        [b.clone() for b in blocks], bands, land, p, k, chunks, 0, bases,
        True, dy, dx)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    del land
    s_p = torch.stack(s_p)
    err = max((a - b).abs().max().item() for a, b in zip(f_a, f_p))
    rel = ((s_a - s_p).abs() / s_p.abs()).max(dim=0).values.cpu()
    sums_abs, sums_ok, sums_bound = 0.0, True, float("inf")
    for b in range(n):
        mask = bands[b][k:-k, k:-k]
        atol = min(sums_atol([g], [mask], int((mask == 0).sum().item()))[0]
                   for g in (blocks[b], f_p[b]))
        diff = (s_a[b] - s_p[b]).abs().max().item()
        sums_abs, sums_bound = max(sums_abs, diff), min(sums_bound, atol)
        sums_ok = sums_ok and diff <= atol
    av_rel = rel.max().item()
    sums_rel = rel[:SUMS_GATE_CHUNKS * k].max().item()
    del f_a, s_a, f_p, s_p
    _free()
    # one launch of n_outer chunks, in a row (each reads the neighbours'
    # states: the host's view of a launch after another), beside the
    # parent route's chunk and one torus_chunk launch
    ex = ring_p2p.TorusExchange(mesh, h, w)
    states = [b.clone() for b in blocks]
    spares = [torch.empty_like(b) for b in blocks]
    reps = max(2, min(10, 2000 // n_outer))
    ms = cuda_ms(lambda: ring_p2p._torus_launch(ex, states, spares, bands, p,
                                                k, n_outer, bases, True),
                 reps)
    ex.check()
    del states, spares
    f = [b.clone() for b in blocks]
    route_ms = cuda_ms(lambda: k4_chunk(f), max(2, min(50, 400 // n_outer
                                                       * 8)))
    *one, base = kstep_tile.torus_pieces(
        sharding.gather_blocks(blocks, dy, dx, "cuda"), o, h * (dy - 1),
        w * (dx - 1), h, w, k)
    block_ms = cuda_ms(lambda: kstep_tile._torus_launch(*one, p, k, base),
                       max(2, min(50, 400 // n_outer * 8)))
    del f, one
    _free()
    bound_ms, bound_by = torus_p2p_bound(h, w, n, k, n_outer)
    ptxas = "; ".join(line.split(": ", 1)[1].replace("ptxas info    : ", "")
                      for line in ptxas_lines(_build.BUILD_DIR,
                                              "torus_p2p_kernel")
                      if line.startswith(f"k={k}:"))
    log(f"[kernel] torus_p2p K6 torus mode ({deck} over {dy}x{dx}, "
        f"{h}x{w} blocks, {chunks} chunks of {k} steps in launches of "
        f"{n_outer}): max|df| {err:.3e} (<= {F_ATOL:g}), max av rel "
        f"{av_rel:.3e} at step {int(rel.argmax())} ({sums_rel:.3e} over the "
        f"first {SUMS_GATE_CHUNKS}, <= {AV_RTOL:g}), max abs raw sums diff "
        f"{sums_abs:.4e} over all (<= {sums_bound:.4e} on every block: its "
        f"free cells x the |u| error F_ATOL allows) against "
        f"torus_p2p_chunks_ref; rerun bitwise {rerun}; state and sums "
        f"bitwise K4's torus mode over {chunks} chunks {same_k4}, chunk by "
        f"chunk in launches of one {lock['same']} (corners "
        f"{lock['corners']}); "
        f"{ms:.4f} ms a launch ({ms / n_outer:.4f} ms a chunk) vs the parent "
        f"route (torus_chunk x {n} and the host's copies) {route_ms:.4f} ms "
        f"a chunk, one torus_chunk launch {block_ms:.4f} ms; plain "
        f"{plain_ms:.2f} ms for {chunks} chunks; bound {bound_ms:.4f} ms a "
        f"launch ({bound_by}), bound/kernel {100 * bound_ms / ms:.1f} %; "
        f"ptxas torus_p2p_kernel<{k}>: {ptxas or 'not in build.log'}")
    if not (err <= F_ATOL and sums_rel <= AV_RTOL and sums_ok and rerun
            and same_k4 and lock["same"]):
        raise AssertionError(f"torus mode {deck} over {dy}x{dx}: disagrees "
                             f"with its plain version or K4's torus mode")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _free():
    """Release what the checks left on the card: garbage, the grid kind's
    exchanges (the flags and tile graphs of every shape and k that the
    checks ran: ~0.1 GiB after the 8192^2 check's k = 1-8; a later runner
    makes its own afresh) and the allocator's cache."""
    import gc

    import torch

    from tpulbm_torch.ops import ring_p2p

    gc.collect()
    ring_p2p._GRIDS.clear()
    torch.cuda.empty_cache()


def _k2_plan(what, p, k, ms, smi):
    """K2's plan at p's grid (the CTA grid, threads a CTA, halo depth h,
    cells a thread, shared memory a CTA) beside its time a call and a
    step."""
    import torch

    from tpulbm_torch.ops import resident

    cy, cx, h, cells, threads, smem = resident.launch_plan(
        p.ny, p.nx, torch.device("cuda"))
    log(f"[kernel] K2 {what}, {k} steps: {cy} x {cx} CTAs of {threads} "
        f"threads, h = {h}, {cells} cell(s) a thread, {smem} B of shared "
        f"memory a CTA; {ms:.4f} ms a call, {1e3 * ms / k:.3f} us a step "
        f"({smi})")


def phase_kernels():
    import numpy as np
    import torch

    from tpulbm_torch.core.params import LBMParams
    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh
    from tpulbm_torch.ops import kstep, kstep_tile, resident

    res = {}
    chunk_ms = {}   # K4 8-step chunk records of the wide decks
    k = resident.RESIDENT_K
    smi = _smi()
    # K2 and K4 (64 whole-grid chunks of 8 steps) on the small decks'
    # shapes, 512 steps, against one plain result: K2's state bitwise K4's,
    # their times in one call.
    for deck, seed in (("128x128", SEED), ("128x256", SEED + 13),
                       ("256x256", SEED + 14)):
        p, o = _load_deck(deck)
        f0 = _state(p, seed)
        plain = _plain(lambda: resident.resident_chunk_ref(f0, o, p, k), 1)
        bound_of = chunk_bound(p.ny * p.nx, k)
        bufs = (torch.empty_like(f0), torch.empty_like(f0))

        def k4_chain():
            """K4 whole grid, k // 8 chunks of 8 steps from f0: (f, sums,
            partials) of them all."""
            f, sums, parts = f0, [], []
            for c in range(k // kstep_tile.TILE_K):
                f, s, pp = kstep_tile._tile_launch(
                    f, o, p, kstep_tile.TILE_K, out=bufs[c % 2])
                sums.append(s)
                parts.append(pp)
            return f, torch.cat(sums), torch.cat(parts)

        k4 = _compare_chunk(
            f"tile_chunk K4 ({deck}, {k // kstep_tile.TILE_K} chunks of "
            f"{kstep_tile.TILE_K} steps)", k4_chain, plain, 10, 1, bound_of)
        k2 = _compare_chunk(
            f"resident_chunk K2 ({deck}, {k} steps)",
            lambda: resident._resident_launch(f0, o, p, k), plain, 10, 1,
            bound_of)
        _k2_plan(deck, p, k, k2["ms"], smi)
        same = torch.equal(k4_chain()[0],
                           resident._resident_launch(f0, o, p, k)[0])
        log(f"[kernel] K4 vs K2 ({deck}, {k} steps, same input): "
            f"{k4['ms']:.4f} vs {k2['ms']:.4f} ms, K4/K2 "
            f"{k4['ms'] / k2['ms']:.3f}; state bitwise K4's {same}; route: "
            f"{', '.join(sorted(_route(p, k)))}")
        if not same:
            raise AssertionError(f"K2's state differs from K4's at {deck}")
        if deck == "256x256":
            res["resident_chunk"] = k2
        del f0, plain, bufs
    # The HBM-edge resident tier's shape (100K-135K aligned cells)
    p = LBMParams(nx=512, ny=256, max_iters=1, reynolds_dim=10, density=0.1,
                  accel=0.005, omega=1.85)
    mask = np.random.RandomState(SEED + 4).rand(p.ny, p.nx) < 0.1
    p = p.with_free_cells(p.ny * p.nx - int(mask.sum()))
    o = torch.tensor(mask, dtype=torch.float32, device="cuda")
    f0 = _state(p, SEED + 5)
    # a full chunk, and the custom example's 392-step chunk (20,000 steps
    # in runner calls of 5,000: 9 x 512 + 392)
    for kk in (k, 392):
        rec = _compare_chunk(
            f"resident_chunk K2 (256x512, {kk} steps)",
            lambda kk=kk: resident._resident_launch(f0, o, p, kk),
            lambda kk=kk: resident.resident_chunk_ref(f0, o, p, kk), 10, 1,
            chunk_bound(p.ny * p.nx, kk))
        _k2_plan("256x512", p, kk, rec["ms"], smi)

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
    # K6's grid kind, the one-card wide route, bitwise K4's whole-grid
    # chunks: 1024^2 (the kernels line's record) and a ragged 100 x 130
    # (4-byte window loads); 2048^2, 4096^2 and 8192^2 below
    res["grid_p2p"] = _grid_p2p_check(p, o, f0, "1024x1024", 64, 8, 10)
    p, o, f0 = _random_case(100, 130, SEED + 130)
    _grid_p2p_check(p, o, f0, "100x130", 64, 8, 20)
    # K4 at the wide decks' shapes: whole grid (8 steps, and the 3-step
    # remainder) and the seam bands of the TPU tiers it replaces.
    p, o = _load_deck("2048x2048")
    f0 = _state(p, SEED + 6)
    chunk_ms["2048x2048"] = _grid_p2p_check(p, o, f0, "2048x2048", 64, 4,
                                            5)
    _compare_chunk(
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
    chunk_ms["8192x8192"] = _grid_p2p_check(p, o, f0, "8192x8192", 16, 2,
                                            3)
    res["tile_chunk"] = _compare_chunk(
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
    # K4 torus mode at the 8192^2 deck's block over 2x2, where the device
    # sets the pace: block (1, 1) (the accelerated row 8190; its yhi slab
    # wraps to rows 0-7, its xhi slab to columns 0-7). This is the kernels
    # line's record.
    res["torus_chunk"] = _torus_check(p, o, f0, 4096, 4096, 4096, 4096, 8,
                                      20, 1, "8192x8192 block (1, 1) of 2x2")
    # The seam band of the 2-D skew's fix at 8192^2: rows [-2K, 2K), which
    # hold the accelerated row ny-2, through ring mode: lo, shard and hi
    # cut from the band (the shard rows [-K, K) of the fix's output).
    _ring_check(p, o, f0, p.ny - 8, 16, 8, 200, 5, "8192x8192 seam band")
    del f0
    _free()
    # The fold fix's band at 4096^2 (F=4): rows [-(m+K), m+K), m = 14
    p, o = _load_deck("4096x4096")
    f0 = _state(p, SEED + 8)
    chunk_ms["4096x4096"] = _grid_p2p_check(p, o, f0, "4096x4096", 32, 2,
                                            5)
    _compare_chunk(
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
    # K4 torus mode on the 1024^2 deck's block (1, 1) over 2x2 at 8 steps
    # and at the 3 steps of a remainder chunk; then the four blocks after
    # one torus chunk against the whole grid's tile_chunk.
    for kk in (8, 3):
        _torus_check(p, o, f0, 512, 512, 512, 512, kk, 200, 5,
                     "1024x1024 block (1, 1) of 2x2")
    _torus_chunk_is_the_whole_grid(p, o, f0)
    del f0
    _free()
    # ... and on the 128^2 deck's block (1, 1) over 2x2, the main path's
    # most launched torus shape: 64 x 64 (a width the TPU's torus kernel
    # refuses), the accelerated row 126 in its band, its yhi slab wrapping
    # to rows 0-7 and its xhi slab to columns 0-7.
    p, o = _load_deck("128x128")
    f0 = _state(p, SEED + 15)
    _torus_check(p, o, f0, 64, 64, 64, 64, 8, 200, 5,
                 "128x128 block (1, 1) of 2x2")
    del f0
    # Torus mode of K6 over the 2x2 blocks of 128^2 and 1024^2 (the kernels
    # line's record: one launch of 64 chunks), 64 chunks of 8 steps, and of
    # 8192^2, 32 chunks (one launch): each against the plain version over
    # all of them and bitwise K4's torus mode
    _torus_p2p_check("128x128", 64, SEED + 19)
    res["torus_p2p"] = _torus_p2p_check("1024x1024", 64, SEED + 20)
    _torus_p2p_check("8192x8192", 32, SEED + 21)
    _free()
    # K6 over the ring's shards on this card, 64 chunks of 8 steps: 128^2
    # over 2, 1024^2 over 4 (the kernels line's record: one launch of 64
    # chunks) and 8192^2 over 4 (two launches of 32), each held against the
    # plain version over all 64 chunks (~18 s of plain steps at 8192^2).
    _p2p_check("128x128", 2, 64, SEED + 16)
    res["ring_p2p"] = _p2p_check("1024x1024", 4, 64, SEED + 17)
    _p2p_check("8192x8192", 4, 64, SEED + 18)
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
    # (a call takes its input over: each goes on from a later state, and
    # only its time is read)
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
    from a perturbed state, on the cuda ring and on the cuda-p2p ring (K6:
    slabs and flags through peer memory): the state within F_ATOL of the
    single-device K4 plan's on card 0 (bitwise is expected), the av series
    within the chunk gate."""
    import torch

    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh
    from tpulbm_torch.ops import kstep_tile

    p, o = _load_deck("1024x1024")
    f0 = _state(p, SEED + 11)
    # a run takes its input over, so the single-device plan gets a copy
    f1, av1 = runner.run_plan(
        runner._chunks(kstep_tile.tile_chunk, kstep_tile.TILE_K, 64),
        f0.clone(), o, p)
    mesh = get_mesh(min(4, torch.cuda.device_count()))
    for backend in ("cuda", "cuda-p2p"):
        fs, obs = sharding.shard_rows(f0, o != 0, mesh)
        out, av = runner.make_runner(p, 64, backend, mesh=mesh)(fs, obs)
        f = sharding.gather_rows(out, "cuda:0")
        torch.cuda.synchronize()
        err = (f - f1).abs().max().item()
        av_rel = ((av - av1).abs() / av1.abs()).max().item()
        log(f"[kernel] 1024x1024 ring ({backend}), layout {_layout(mesh)}, "
            f"64 steps: max|df| vs one card {err:.3e}, state bitwise "
            f"{torch.equal(f, f1)}; max av rel {av_rel:.3e}")
        if not (err <= F_ATOL and av_rel <= AV_RTOL):
            raise AssertionError(f"ring ({backend}) over cards disagrees "
                                 f"with one card")


def _layout(mesh):
    """The devices of a ring's shards or a torus's blocks (row-major)."""
    names = [str(d) for row in mesh
             for d in (row if isinstance(row, list) else [row])]
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


def _check_launches(deck, counts, needed, absent=(), p2p_chunks=0):
    """Every kernel of `needed` launched, none of `absent`; the chunks'
    sums all reduced in-kernel: one reduction per chunk (a K2 or K4 launch,
    8 K1 launches, one K1 remainder chunk per runner call, and p2p_chunks,
    the chunks times the shards that K6 launches ran, or the chunks of the
    grid kind's launches, _grid_chunks), and the library has no
    second-pass entry point (lbm_reduce_partials) to launch."""
    from tpulbm_torch.ops import _build

    log(f"    launches: {counts}")
    missing = [k for k in needed if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{deck}: no launch of {missing}")
    stray = [k for k in absent if counts[k]]
    if stray:
        raise AssertionError(f"{deck}: launches of {stray} off its route")
    chunks = (counts["resident_chunk"] + counts["tile_chunk"]
              + counts["ring_chunk"] + counts["torus_chunk"]
              + counts["skew_chunk"] // 8
              + (counts["kstep_chunk"] > 0) + p2p_chunks)
    if counts["reduce_partials"] != chunks:
        raise AssertionError(f"{deck}: {counts['reduce_partials']} in-kernel "
                             f"reductions for {chunks} chunks")
    if hasattr(_build.library(), "lbm_reduce_partials"):
        raise AssertionError("the library still has lbm_reduce_partials")


def _grid_chunks(p, calls):
    """The chunks that the grid kind's launches run over runner calls of
    `calls` steps (kernel_plan's)."""
    from tpulbm_torch.dist import runner
    from tpulbm_torch.ops import ring_p2p

    return sum(n for c in calls for fn, _, n in runner.kernel_plan(p, c)
               if fn is ring_p2p.grid_p2p_chunks)


def _max_rel_pct(av, ref):
    import numpy as np

    return 100 * float((np.abs(av - ref) / np.abs(ref)).max())


def _k1_plan(n_steps):
    """A plan of K1 for n_steps (8-step skew chunks, kstep remainder),
    which no route takes: the one-pass-per-step reference that the wide
    decks' av series and Reynolds numbers are held against."""
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
    chunks = _grid_chunks(p, [steps])
    _check_launches(deck, counts, ["grid_p2p", "reduce_partials"],
                    ["skew_chunk", "kstep_chunk", "resident_chunk",
                     "tile_chunk"], chunks)
    for k, v in counts.items():
        totals[k] += v
    mlups = p.nx * p.ny * steps / elapsed / 1e6
    busy = chunks * chunk_ms / 1e3 / elapsed
    log(f"[main] {deck}: Reynolds {reynolds:.12E}, {elapsed:.3f} s, "
        f"{mlups:.1f} MLUPS, peak device memory {peak / 2**30:.3f} GiB; "
        f"grid-kind chunks {chunks} ({counts['grid_p2p']} launches) x "
        f"{chunk_ms:.4f} ms = {100 * busy:.1f} % of the solve")
    if deck == "8192x8192" and not peak / 2**30 <= PEAK_8192_GIB:
        raise AssertionError(f"{deck}: peak device memory {peak / 2**30:.3f} "
                             f"GiB over {PEAK_8192_GIB} GiB")

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
    from tpulbm_torch.dist import runner
    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.ops import _build, kstep_tile

    totals = dict.fromkeys(_build.LAUNCHES, 0)
    golden = os.path.join(ROOT, "tests", "goldens")
    for deck, steps in DECKS:
        pf, of = deck_files(deck)
        p = read_params(pf)
        assert p.max_iters == steps, (deck, p.max_iters)
        out = os.path.join(OUT, deck)
        log(f"[main] python -m tpulbm_torch {deck} ({steps} steps)")
        _build.reset_launches()
        reynolds, elapsed = _run_cli([pf, of, "--out-dir", out])
        counts = dict(_build.LAUNCHES)
        route = _route(p, steps)
        _check_launches(deck, counts, [*route, "reduce_partials"],
                        [c for c in ("resident_chunk", "skew_chunk",
                                     "kstep_chunk", "tile_chunk", "grid_p2p")
                         if c not in route], _grid_chunks(p, [steps]))
        log(f"    route: {', '.join(sorted(route))}")
        for k, v in counts.items():
            totals[k] += v
        ok, msg = _gate(deck, out)
        mlups = p.nx * p.ny * steps / elapsed / 1e6
        log(f"[main] {deck}: Reynolds {reynolds:.12E}, {elapsed:.3f} s, "
            f"{mlups:.1f} MLUPS; golden ({GOLDEN_TOL:g} %): {msg}")
        if not ok:
            raise AssertionError(f"{deck}: golden check failed")

    deck, steps = REMAINDER_RUN
    pf, of = deck_files(deck)
    out = os.path.join(OUT, f"{deck}_{steps}")
    p = read_params(pf)
    log(f"[main] python -m tpulbm_torch {deck} --max-iters {steps}")
    _build.reset_launches()
    _run_cli([pf, of, "--out-dir", out, "--max-iters", str(steps)])
    counts = dict(_build.LAUNCHES)
    _check_launches(deck, counts, ["grid_p2p", "reduce_partials"],
                    ["skew_chunk", "kstep_chunk", "tile_chunk"],
                    _grid_chunks(p, [steps]))
    if counts["grid_p2p"] != len(runner.kernel_plan(p, steps)):
        raise AssertionError(f"{deck} x {steps}: {counts['grid_p2p']} "
                             f"grid_p2p launches")
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
    p = read_params(pf)
    n_launches = len(runner.kernel_plan(p, steps))
    _check_launches(deck, counts, ["grid_p2p", "reduce_partials"],
                    ["skew_chunk", "kstep_chunk", "tile_chunk"],
                    _grid_chunks(p, [steps]))
    if counts["grid_p2p"] != n_launches:
        raise AssertionError(f"{deck} x {steps}: {counts['grid_p2p']} "
                             f"grid_p2p launches, not {n_launches}")
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


# The ring through the CLI: (deck, steps, --device-count), each run on the
# cuda ring and on the cuda-p2p ring (K6), whose outputs must be the same
# bytes. The small decks run over 2 shards: on one card the cuda ring's host
# path sets their pace, and 4 shards would double the script's time for
# them.
RING_RUNS = [
    ("128x128", 40000, 2),
    ("128x256", 40000, 2),
    ("256x256", 80000, 2),
    ("1024x1024", 20000, 4),
]
RING_UNEVEN_RUN = ("1024x1024", 20000, 3)                # 342/341/341 rows
RING_WIDE_RUN = ("8192x8192", 1000, 4)
P2P = ["--backend", "cuda-p2p"]
# The launch counters that a mesh run may not touch but its own
KERNEL_COUNTERS = ("skew_chunk", "kstep_chunk", "resident_chunk",
                   "tile_chunk", "ring_chunk",
                   "ring_p2p", "torus_chunk", "torus_p2p", "grid_p2p")


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


def _mesh_cli(deck, steps, mesh_args, totals, out=None, peak_gib=None,
              kernel=None):
    """One ring (``--device-count N``) or torus (``--mesh-shape DYxDX``)
    run through cli.main: launches (ring_chunk, ring_p2p with
    ``--backend cuda-p2p``, or torus_p2p, the torus's in-kernel exchange;
    ``kernel`` where another is the route's), MLUPS, peak device memory (at
    most peak_gib where given), host us per chunk, layout. Returns (the
    Simulation, Reynolds number)."""
    import torch

    from tpulbm_torch.dist.sharding import ring_rows
    from tpulbm_torch.ops import _build, kstep_tile

    torus = "--mesh-shape" in mesh_args
    kernel = kernel or ("torus_p2p" if torus else
                        "ring_p2p" if "cuda-p2p" in mesh_args else
                        "ring_chunk")
    p2p = kernel in ("torus_p2p", "ring_p2p")
    tag = "[torus]" if torus else "[ring]"
    pf, of = deck_files(deck)
    args = [pf, of, *mesh_args]
    args += ["--out-dir", out] if out else ["--no-output"]
    log(f"{tag} python -m tpulbm_torch {deck} {' '.join(args[2:])} "
        f"({steps} steps)")
    seen = {}
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with _watch_simulation(seen):
        reynolds, elapsed = _run_cli(args)
    counts = dict(_build.LAUNCHES)
    sim = seen["sim"]
    ny, nx = sim.params.ny, sim.params.nx
    if torus:
        dy, dx = len(sim.mesh), len(sim.mesh[0])
        k = min(kstep_tile.TILE_K, ny // dy, nx // dx)
        what = f"{dy}x{dx} blocks of {ny // dy}x{nx // dx}"
        shards = dy * dx
    else:
        rows, _ = ring_rows(ny, len(sim.mesh))
        k = min(kstep_tile.TILE_K, min(rows))
        what = f"{len(rows)} shards ({'/'.join(map(str, rows))} rows)"
        shards = len(rows)
    chunks = -(-steps // k)
    _check_launches(deck, counts, [kernel, "reduce_partials"],
                    [c for c in KERNEL_COUNTERS if c != kernel],
                    p2p_chunks=chunks * shards if p2p else 0)
    for key, v in counts.items():
        totals[key] += v
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} {deck} over {what}, layout {_layout(sim.mesh)}: Reynolds "
        f"{reynolds:.12E}, {elapsed:.3f} s, "
        f"{nx * ny * steps / elapsed / 1e6:.1f} MLUPS, peak device memory "
        f"{peak:.3f} GiB, {chunks} chunks of {k} steps"
        f"{f' in {counts[kernel]} {kernel} launches' if p2p else ''}, host "
        f"{seen['issue_s'] / chunks * 1e6:.1f} us per chunk, solve "
        f"{elapsed / chunks * 1e6:.1f} us per chunk")
    if peak_gib is not None and not peak <= peak_gib:
        raise AssertionError(f"{deck} {' '.join(mesh_args)}: peak device "
                             f"memory {peak:.3f} GiB over {peak_gib} GiB")
    return sim, reynolds


def _mesh_golden(deck, steps, mesh_args, totals, extra=()):
    """A reference deck over a ring or torus (``mesh_args``) through
    cli.main, with ``extra`` arguments, its outputs through the golden
    gate. Returns the output directory."""
    name = "".join(mesh_args).replace("--", "_")
    out = os.path.join(OUT, f"{deck}{name}")
    sim, _ = _mesh_cli(deck, steps, [*mesh_args, *extra], totals, out)
    assert sim.params.max_iters == steps, (deck, sim.params.max_iters)
    del sim
    _golden(deck, out, " ".join(mesh_args))
    _free()
    MADE.add(out)
    return out


# Host seconds of the final-state gates against an f64-oracle golden
# (.f64.npz; 256^2 and 1024^2): what gating those decks' final state adds.
NPZ_GATES = {"runs": 0, "s": 0.0}


def _gate(deck, out):
    """The output files in `out` through the golden gate at GOLDEN_TOL: the
    av series, and the final state's pressure against the deck's
    final-state golden (``check.final_state_golden``: the reference's text
    file, else the f64-oracle golden), where it has one. Returns (passed,
    the max differences as text)."""
    from tpulbm_torch.validation import check

    golden = os.path.join(ROOT, "tests", "goldens")
    av_ref = os.path.join(golden, f"{deck}.av_vels.dat")
    av_out = os.path.join(out, "av_vels.dat")
    fs_ref = check.final_state_golden(golden, deck)
    if fs_ref is None:
        ok, av = check.check_av_vels(av_ref, av_out, GOLDEN_TOL,
                                     verbose=False)
        return ok, (f"av_vels max diff {av.max_diff_pcnt:.3g} % (no "
                    f"final-state golden)")
    t0 = time.perf_counter()
    ok, av, fs = check.check_results(
        av_ref, fs_ref, av_out, os.path.join(out, "final_state.dat"),
        GOLDEN_TOL, verbose=False)
    if fs_ref.endswith(".npz"):
        NPZ_GATES["runs"] += 1
        NPZ_GATES["s"] += time.perf_counter() - t0
    return ok, (f"av_vels max diff {av.max_diff_pcnt:.3g} %, final_state "
                f"max diff {fs.max_diff_pcnt:.3g} % (against "
                f"{os.path.basename(fs_ref)})")


def _golden(deck, out, what):
    """The output files in `out` through the golden gate (``_gate``)."""
    ok, msg = _gate(deck, out)
    log(f"[golden] {deck} {what}: golden ({GOLDEN_TOL:g} %): {msg}")
    if not ok:
        raise AssertionError(f"{deck} {what}: golden check failed")


def _ring_busy(backend="cuda"):
    """Device time against wall time of 50 chunks of the 1024^2 ring over
    4 shards on `backend`, from a torch.profiler trace: the sum of the
    device events' self time (kernels and copies) over the wall time of the
    runner call and its readback. Off the main path: its launches are not
    counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpulbm_torch.dist import runner, sharding
    from tpulbm_torch.dist.mesh import get_mesh

    p, o = _load_deck("1024x1024")
    mesh = get_mesh(4)
    fs, obs = sharding.shard_rows(_state(p, SEED + 12), o != 0, mesh)
    run = runner.make_runner(p, 400, backend, mesh=mesh)
    run(fs, obs)[1].cpu()   # the timed call goes on from its later state
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(fs, obs)[1].cpu()
        wall = time.perf_counter() - t0
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    log(f"[ring] 1024x1024 over 4 shards ({backend}), 50 chunks under "
        f"torch.profiler: "
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
    for deck, steps, n in RING_RUNS:
        mesh_args = ["--device-count", str(n)]
        cuda = _mesh_golden(deck, steps, mesh_args, totals)
        p2p = _mesh_golden(deck, steps, [*mesh_args, *P2P], totals)
        _same_bytes(p2p, cuda, f"{deck} over {n} shards, cuda-p2p",
                    ref_what="the cuda ring's run")
    deck, steps, n = RING_UNEVEN_RUN
    _mesh_golden(deck, steps, ["--device-count", str(n)], totals)
    _ring_busy("cuda")
    _ring_busy("cuda-p2p")

    # 8192^2 over 4 shards, full width and steps, on both rings, against
    # one card's K4
    deck, steps, n = RING_WIDE_RUN
    for extra in ([], P2P):
        what = f"{deck} over {n} shards{' (cuda-p2p)' if extra else ''}"
        sim, _ = _mesh_cli(deck, steps, ["--device-count", str(n), *extra],
                           totals, peak_gib=PEAK_MESH_8192_GIB)
        f_ring, av_ring = sim.f, sim.av_vels.copy()
        del sim
        _free()
        f_one = one_card["f"].to(f_ring.device)
        diff = (f_ring - f_one).abs().max().item()
        same = torch.equal(f_ring, f_one)
        rel = _max_rel_pct(av_ring, one_card["av"])
        log(f"[ring] {what} vs one card (phase 4's K4 run): max|df| "
            f"{diff:.3e} (<= {F_ATOL:g}), state bitwise {same}; av max diff "
            f"{rel:.3g} % (<= {GOLDEN_TOL:g} %)")
        if not (same and rel <= GOLDEN_TOL
                and np.isfinite(av_ring).all() and av_ring.shape == (steps,)):
            raise AssertionError(f"{what} disagrees with one card")
        del f_ring, f_one
        _free()
    return totals


# The torus through the CLI, over --mesh-shape 2x2 (one card: the four
# blocks share it): the reference decks at their full step counts, through
# the golden gate; then the first RESUME_STEP steps of the 1024^2 deck,
# saving every CKPT_EVERY steps, the last of which resumes on one device.
TORUS = ["--mesh-shape", "2x2"]
TORUS_RUNS = [("128x128", 40000), ("1024x1024", 20000)]
TORUS_WIDE_RUN = ("8192x8192", 1000)
# 128 blocks of 128 x 64 on the card, past torus mode's 64 a card: the
# route of K4's torus mode (deck, steps, --mesh-shape)
TORUS_K4_RUN = ("1024x1024", 2000, "8x16")
CKPT_EVERY = 5000
RESUME_STEP = 10000


def _expect_checkpoints(ck, steps, ext="npz"):
    """The checkpoint directory of a run of `steps` steps that saved every
    CKPT_EVERY: one npz file (or dcp directory) a multiple of CKPT_EVERY.
    Returns the path of step RESUME_STEP's."""
    names = sorted(os.listdir(ck))
    want = [f"ckpt_{s:08d}.{ext}" for s in range(CKPT_EVERY, steps + 1,
                                                 CKPT_EVERY)]
    if names != want:
        raise AssertionError(f"{ck}: {names}, not {want}")
    return os.path.join(ck, f"ckpt_{RESUME_STEP:08d}.{ext}")


def _read(out, name):
    with open(os.path.join(out, name), "rb") as fh:
        return fh.read()


def _same_bytes(out, ref, what, av_from=0,
                ref_what="phase 4's uninterrupted run"):
    """The output files in `out` are the bytes of those in `ref` (av_vels.dat
    from its line av_from on)."""
    fs_same = _read(out, "final_state.dat") == _read(ref, "final_state.dat")
    av, av_ref = (_read(out, "av_vels.dat").splitlines()[av_from:],
                  _read(ref, "av_vels.dat").splitlines()[av_from:])
    av_same = av == av_ref and len(av) > 0
    log(f"    {what}: final_state.dat the same bytes as {ref_what}: "
        f"{fs_same}; av_vels.dat"
        f"{f' from step {av_from}' if av_from else ''}: {av_same}")
    if not (fs_same and av_same):
        raise AssertionError(f"{what}: output files differ from {ref_what}")


def phase_torus(one_card):
    """The torus's main path (see the module docstring). one_card: as for
    phase_ring."""
    import numpy as np
    import torch

    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.ops import _build

    totals = dict.fromkeys(_build.LAUNCHES, 0)
    for deck, steps in TORUS_RUNS:
        _mesh_golden(deck, steps, TORUS, totals)

    # The torus's checkpoint resumes on one device: the state is the one
    # card's, so the run ends in phase 4's bytes. The torus runs the first
    # RESUME_STEP steps, saving every CKPT_EVERY.
    ck = os.path.join(OUT, f"ckpt_torus_{deck}")
    shutil.rmtree(ck, ignore_errors=True)
    _mesh_cli(deck, RESUME_STEP, [*TORUS, "--max-iters", str(RESUME_STEP),
                                  "--checkpoint-every", str(CKPT_EVERY),
                                  "--checkpoint-dir", ck], totals)
    path = _expect_checkpoints(ck, RESUME_STEP)
    pf, of = deck_files(deck)
    out = os.path.join(OUT, f"{deck}_torus_resumed_on_one_card")
    log(f"[torus] python -m tpulbm_torch {deck} --resume {path} (the torus's "
        f"step {RESUME_STEP}, on one device)")
    _build.reset_launches()
    _run_cli([pf, of, "--resume", path, "--out-dir", out])
    counts = dict(_build.LAUNCHES)
    p = read_params(pf)
    _check_launches(deck, counts, ["grid_p2p", "reduce_partials"],
                    ["torus_chunk", "ring_chunk", "skew_chunk",
                     "kstep_chunk", "tile_chunk"],
                    _grid_chunks(p, [p.max_iters - RESUME_STEP]))
    for key, v in counts.items():
        totals[key] += v
    _same_bytes(out, os.path.join(OUT, deck), "torus checkpoint resumed",
                av_from=RESUME_STEP)

    # 8192^2 over 2x2, full width and steps, against one card's K4
    deck, steps = TORUS_WIDE_RUN
    sim, _ = _mesh_cli(deck, steps, TORUS, totals,
                       peak_gib=PEAK_MESH_8192_GIB)
    f_torus, av_torus = sim.f, sim.av_vels.copy()
    del sim
    f_one = one_card["f"].to(f_torus.device)
    diff = (f_torus - f_one).abs().max().item()
    same = torch.equal(f_torus, f_one)
    rel = _max_rel_pct(av_torus, one_card["av"])
    log(f"[torus] {deck} over 2x2 vs one card (phase 4's K4 run): "
        f"max|df| {diff:.3e}, state bitwise {same}; av max diff {rel:.3g} % "
        f"(<= {GOLDEN_TOL:g} %)")
    if not (same and rel <= GOLDEN_TOL
            and np.isfinite(av_torus).all() and av_torus.shape == (steps,)):
        raise AssertionError(f"{deck} over 2x2 disagrees with one card")
    del f_torus, f_one
    _free()
    _torus_k4_route(totals)
    return totals


def _torus_k4_route(totals):
    """TORUS_K4_RUN through cli.main: make_runner names the limit on
    stderr and builds K4's torus mode (torus_chunk launches only); the final
    state bitwise the single-device K4 run of the same steps, the av series
    within GOLDEN_TOL."""
    import dataclasses

    import numpy as np
    import torch

    from tpulbm_torch.ops import _build
    from tpulbm_torch.sim.simulation import Simulation

    deck, steps, shape = TORUS_K4_RUN
    one = Simulation.from_files(*deck_files(deck))
    one.params = dataclasses.replace(one.params, max_iters=steps)
    one.av_vels = np.zeros((steps,), dtype=np.float32)
    _build.reset_launches()
    one.run()
    counts = dict(_build.LAUNCHES)
    _check_launches(deck, counts, ["grid_p2p", "reduce_partials"],
                    [c for c in KERNEL_COUNTERS if c != "grid_p2p"],
                    _grid_chunks(one.params, [steps]))
    for key, v in counts.items():
        totals[key] += v
    f_one, av_one = one.f.cpu(), one.av_vels.copy()
    del one
    _free()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        sim, _ = _mesh_cli(deck, steps, ["--mesh-shape", shape, "--max-iters",
                                         str(steps)], totals,
                           kernel="torus_chunk")
    for line in err.getvalue().splitlines():
        log(f"    {line}")
    said = [line for line in err.getvalue().splitlines()
            if "falling back to K4's torus mode" in line]
    if len(said) != 1 or "128 blocks on (process 0, cuda:0)" not in said[0]:
        raise AssertionError(f"{deck} over {shape}: the route's line on "
                             f"stderr is missing")
    f_torus, av_torus = sim.f.cpu(), sim.av_vels.copy()
    del sim
    _free()
    same = torch.equal(f_torus, f_one)
    rel = _max_rel_pct(av_torus, av_one)
    log(f"[torus] {deck} over {shape} (K4's torus mode) vs one card's K4 "
        f"run of {steps} steps: state bitwise {same}; av max diff "
        f"{rel:.3g} % (<= {GOLDEN_TOL:g} %)")
    if not (same and rel <= GOLDEN_TOL and np.isfinite(av_torus).all()
            and av_torus.shape == (steps,)):
        raise AssertionError(f"{deck} over {shape} disagrees with one card")


def _time_save(path):
    """The host seconds of one checkpoint write of the state in `path`:
    the port's ``save`` (uncompressed npz) beside the same keys written
    compressed, as the JAX package writes them."""
    import dataclasses

    import numpy as np

    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.sim import checkpoint as ckpt

    params = read_params(deck_files("1024x1024")[0])
    step, f, av = ckpt.restore(path, params)
    scratch = os.path.join(OUT, "ckpt_timing")
    shutil.rmtree(scratch, ignore_errors=True)
    t0 = time.perf_counter()
    ckpt.save(scratch, step, f, av, params)
    t1 = time.perf_counter()
    np.savez_compressed(os.path.join(scratch, "compressed.npz"),
                        step=np.int64(step), f=f, av_vels=av,
                        params=json.dumps(dataclasses.asdict(params)))
    t2 = time.perf_counter()
    log(f"[ckpt] one checkpoint write of the {f.shape} state: save() "
        f"{t1 - t0:.3f} s (uncompressed), compressed {t2 - t1:.3f} s")


def phase_checkpoint():
    """Checkpoints and profiling on one device (see the module docstring):
    the resumed run is a second process, as a user would start it."""
    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.ops import _build

    totals = dict.fromkeys(_build.LAUNCHES, 0)
    deck, steps = "1024x1024", 20000
    pf, of = deck_files(deck)
    ref = os.path.join(OUT, deck)
    ck = os.path.join(OUT, f"ckpt_{deck}")
    shutil.rmtree(ck, ignore_errors=True)
    out = os.path.join(OUT, f"{deck}_checkpointed")
    log(f"[ckpt] python -m tpulbm_torch {deck} --checkpoint-every "
        f"{CKPT_EVERY} ({steps} steps)")
    _build.reset_launches()
    _run_cli([pf, of, "--checkpoint-every", str(CKPT_EVERY),
              "--checkpoint-dir", ck, "--out-dir", out])
    counts = dict(_build.LAUNCHES)
    p = read_params(pf)
    _check_launches(deck, counts, ["grid_p2p", "reduce_partials"],
                    ["torus_chunk", "ring_chunk", "skew_chunk",
                     "kstep_chunk", "tile_chunk"],
                    _grid_chunks(p, [CKPT_EVERY] * (steps // CKPT_EVERY)))
    for key, v in counts.items():
        totals[key] += v
    path = _expect_checkpoints(ck, steps)
    _same_bytes(out, ref, "checkpointed run")
    _time_save(path)

    resumed = os.path.join(OUT, f"{deck}_resumed")
    cmd = [sys.executable, "-m", "tpulbm_torch", pf, of, "--resume", path,
           "--out-dir", resumed]
    log(f"[ckpt] a second process: python -m tpulbm_torch {deck} --resume "
        f"{path}")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    for line in (proc.stdout + proc.stderr).splitlines():
        log(f"    {line}")
    log(f"    the process took {time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{cmd} exited {proc.returncode}")
    _same_bytes(resumed, ref, "resumed process")

    trace = os.path.join(OUT, "profile")
    shutil.rmtree(trace, ignore_errors=True)
    log(f"[ckpt] python -m tpulbm_torch {deck} --max-iters 80 --no-output "
        f"--profile-dir {trace}")
    _build.reset_launches()
    _run_cli([pf, of, "--max-iters", "80", "--no-output", "--profile-dir",
              trace])
    counts = dict(_build.LAUNCHES)
    _check_launches(deck, counts, ["grid_p2p", "reduce_partials"],
                    p2p_chunks=_grid_chunks(p, [80]))
    for key, v in counts.items():
        totals[key] += v
    with open(os.path.join(trace, "mainloop.pt.trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    region = any(e.get("name") == "mainloop" for e in events)
    k6 = sum(1 for e in events if e.get("cat") == "kernel"
             and "grid_p2p_kernel" in e.get("name", ""))
    log(f"    trace: {len(events)} events, the mainloop region {region}, "
        f"{k6} grid-kind kernel events (of {counts['grid_p2p']} launches)")
    if not (region and k6 == counts["grid_p2p"]):
        raise AssertionError("the --profile-dir trace lacks its region or "
                             "some of its grid-kind launches")
    return totals


# The multi-process main path: python -m tpulbm_torch.dist.launch
# --local-smoke PROCESSES (two processes of two shards; on one card they
# share it, so the transport is gloo with the slabs staged through the
# host). 1024^2 with dcp checkpoints every CKPT_EVERY steps, its outputs
# through the golden gate and the bytes of phase 6's --device-count 4 run;
# its RESUME_STEP checkpoint resumed in one process over the same four
# shards, the same bytes; 1024^2 over the two processes on cuda-p2p (K6
# across processes, the two contexts time-sliced on the card), the same
# bytes; the torus over 2x2 on the two processes (K6's torus mode in each,
# through CUDA IPC): 1024^2 through the golden gate and the bytes of phase
# 7's one-process torus, and 128^2 for TORUS_PROCESS_STEPS steps, the bytes
# of one process's torus.
PROCESSES = "2x2"
TORUS_PROCESS_STEPS = 4000
_EXCHANGE = re.compile(r"multihost: transport (.*), (\d+) chunks, host "
                       r"exchange ([\d.]+) us a chunk")


# (the processes' lines may interleave on the launcher's stderr)
_STARTED = re.compile(r"multihost: process \d+/\d+, [^,\n]*?, transport "
                      r"(gloo|nccl)")
_OPENED = re.compile(r"(?:cuda-p2p|the torus) over \d+ processes: (\d+) "
                     r"exchange blocks of other processes opened in "
                     r"([\d.]+) ms")
P2P_KERNELS = ("ring_p2p", "torus_p2p")


def _last_call(metrics, deck):
    """MLUPS of the last runner call of a run, from its ``--metrics-file``
    (one line a call: the steps done and the wall seconds so far)."""
    with open(metrics) as fh:
        a, b = [json.loads(line) for line in fh.readlines()[-2:]]
    nx, ny = map(int, deck.split("x"))
    steps, wall = b["step"] - a["step"], b["wall_s"] - a["wall_s"]
    return nx * ny * steps / wall / 1e6


def _split(deck, steps, what):
    """Arguments that run ``steps`` in two runner calls of whole 8-step
    chunks with a metrics file (``_last_call``: the second call, past the
    first call's set-up)."""
    metrics = os.path.join(OUT, f"metrics_{deck}_{what}.jsonl")
    with contextlib.suppress(FileNotFoundError):
        os.remove(metrics)
    return (["--chunk", str(-(-steps // 16) * 8), "--metrics-file", metrics],
            metrics)


def _launch(deck, steps, args, kernel, totals, shape=PROCESSES,
            transport="gloo", split=False):
    """One run of the port's launcher, ``--local-smoke shape``: its lines
    logged, each process's launch counts (``--launch-counts``) checked
    (only ``kernel``, in every process) and added to totals; the transport
    must be ``transport``. Logs MLUPS, ms a chunk, and process 0's host
    exchange time a chunk (the cuda ring, the torus) or every process's
    time to open the other processes' exchange blocks (cuda-p2p); with
    ``split``, the steps run in two runner calls and the second call's
    MLUPS are logged too. Returns (MLUPS, the second call's or None)."""
    pf, of = deck_files(deck)
    procs, per = map(int, shape.split("x"))
    counts = os.path.join(OUT, f"launches_{deck}_{shape}")
    for r in range(procs):
        with contextlib.suppress(FileNotFoundError):
            os.remove(f"{counts}.{r}")
    extra, metrics = (_split(deck, steps, f"{shape}_{kernel}") if split
                      else ([], None))
    cmd = [sys.executable, "-m", "tpulbm_torch.dist.launch", "--local-smoke",
           shape, "--timeout", "300", pf, of, *args, *extra,
           "--launch-counts", counts]
    log(f"[multiproc] python -m tpulbm_torch.dist.launch --local-smoke "
        f"{shape} {deck} {' '.join(args)} ({steps} steps)")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=360)
    wall = time.perf_counter() - t0
    for line in (proc.stdout + proc.stderr).splitlines():
        log(f"    {line}")
    if proc.returncode != 0:
        raise AssertionError(f"{cmd} exited {proc.returncode}")
    nx, ny = map(int, deck.split("x"))
    if "--mesh-shape" in args:
        dy, dx = map(int, args[args.index("--mesh-shape") + 1].split("x"))
        k = min(8, ny // dy, nx // dx)
    else:
        k = min(8, ny // (procs * per))
    chunks = -(-steps // k)
    p2p = kernel in P2P_KERNELS
    for r in range(procs):
        with open(f"{counts}.{r}") as fh:
            got = json.load(fh)
        _check_launches(f"{deck}, process {r}", got,
                        [kernel, "reduce_partials"],
                        [c for c in KERNEL_COUNTERS if c != kernel],
                        p2p_chunks=chunks * per if p2p else 0)
        for key, v in got.items():
            totals[key] += v
    fields = dict(line.split(":", 1) for line in proc.stdout.splitlines()
                  if ":" in line)
    elapsed = float(fields["Elapsed time"].split()[0])
    mlups = nx * ny * steps / elapsed / 1e6
    hows = _STARTED.findall(proc.stderr)
    if p2p:
        opened = [(int(n), float(ms)) for n, ms in
                  _OPENED.findall(proc.stderr)]
        if not opened or len(opened) % procs:
            # one line a process and runner (a run of two call sizes has
            # two runners)
            raise AssertionError(f"{procs} processes, {len(opened)} lines "
                                 f"of opened exchange blocks")
        what = ("exchange blocks of other processes opened: "
                + ", ".join(f"{n} in {ms} ms" for n, ms in opened))
    else:
        how, _, us = _EXCHANGE.search(proc.stderr).groups()
        what = f"host exchange {us} us a chunk (process 0), {how}"
    last = _last_call(metrics, deck) if split else None
    log(f"[multiproc] {deck} over {shape} (processes x shards), {kernel}: "
        f"{mlups:.1f} MLUPS ({elapsed:.3f} s, {chunks} chunks, "
        f"{elapsed / chunks * 1e3:.4f} ms a chunk"
        f"{f'; the second of two calls {last:.1f} MLUPS' if split else ''}"
        f"), transport {'/'.join(sorted(set(hows)))}, {what}, the "
        f"launcher's wall {wall:.1f} s")
    if len(hows) != procs or set(hows) != {transport}:
        raise AssertionError(f"transports {hows}, not {transport}")
    return mlups, last


def phase_multiproc():
    """The multi-process main path (see PROCESSES)."""
    from tpulbm_torch.ops import _build

    totals = dict.fromkeys(_build.LAUNCHES, 0)
    deck, steps = "1024x1024", 20000
    pf, of = deck_files(deck)
    ring4 = os.path.join(OUT, f"{deck}_device-count4")
    ck = os.path.join(OUT, f"ckpt_multiproc_{deck}")
    shutil.rmtree(ck, ignore_errors=True)
    out = os.path.join(OUT, f"{deck}_multiproc")
    _free()
    _launch(deck, steps, ["--ckpt-backend", "dcp", "--checkpoint-every",
                          str(CKPT_EVERY), "--checkpoint-dir", ck,
                          "--out-dir", out], "ring_chunk", totals)
    _golden(deck, out, f"over {PROCESSES} (processes x shards)")
    _same_bytes(out, ring4, f"{PROCESSES} processes x shards",
                ref_what="phase 6's --device-count 4 run")
    path = _expect_checkpoints(ck, steps, "dcp")

    resumed = os.path.join(OUT, f"{deck}_multiproc_resumed")
    log(f"[multiproc] python -m tpulbm_torch {deck} --device-count 4 "
        f"--resume {path} (the two processes' step {RESUME_STEP}, in one)")
    _build.reset_launches()
    _run_cli([pf, of, "--device-count", "4", "--resume", path, "--out-dir",
              resumed])
    counts = dict(_build.LAUNCHES)
    _check_launches(deck, counts, ["ring_chunk", "reduce_partials"],
                    ["torus_chunk", "tile_chunk", "skew_chunk",
                     "kstep_chunk", "ring_p2p", "grid_p2p"])
    for key, v in counts.items():
        totals[key] += v
    _same_bytes(resumed, ring4, "dcp checkpoint resumed in one process",
                ref_what="phase 6's --device-count 4 run")
    _free()

    # cuda-p2p across the two processes: K6 in each, the slabs and flags
    # through CUDA IPC mappings of the other process's exchange block on
    # the shared card
    out = os.path.join(OUT, f"{deck}_multiproc_p2p")
    _launch(deck, steps, [*P2P, "--out-dir", out], "ring_p2p", totals)
    _same_bytes(out, ring4, f"{PROCESSES} processes x shards, cuda-p2p",
                ref_what="phase 6's --device-count 4 run")

    # the torus on the two processes: K6's torus mode in each, the
    # exchange through CUDA IPC mappings on the shared card
    deck = "1024x1024"
    out = os.path.join(OUT, f"{deck}_multiproc_torus")
    _launch(deck, steps, [*TORUS, "--out-dir", out], "torus_p2p", totals)
    _golden(deck, out, f"over a 2x2 torus on {PROCESSES} (processes x "
            f"blocks)")
    _same_bytes(out, os.path.join(OUT, f"{deck}_mesh-shape2x2"),
                f"the torus over {PROCESSES} (processes x blocks)",
                ref_what="phase 7's one-process torus")

    # ... and against one process's, for the first TORUS_PROCESS_STEPS
    # steps of 128^2
    deck, steps = "128x128", TORUS_PROCESS_STEPS
    pf, of = deck_files(deck)
    one = os.path.join(OUT, f"{deck}_torus_{steps}")
    short = ["--max-iters", str(steps)]
    log(f"[multiproc] python -m tpulbm_torch {deck} {' '.join(TORUS)} "
        f"{' '.join(short)} (one process)")
    _build.reset_launches()
    _run_cli([pf, of, *TORUS, *short, "--out-dir", one])
    for key, v in _build.LAUNCHES.items():
        totals[key] += v
    out = os.path.join(OUT, f"{deck}_multiproc_torus")
    _launch(deck, steps, [*TORUS, *short, "--out-dir", out], "torus_p2p",
            totals)
    _same_bytes(out, one, f"the torus over {PROCESSES} (processes x blocks)",
                ref_what="one process's torus")
    return totals


# The examples (examples/torch_*.py), each through its main in a working
# directory of its own: out/ is theirs, data/ a link to the repository's.
EXAMPLES = os.path.join(OUT, "examples")
EXAMPLE_CKPT_EVERY = 5000   # the custom example's checkpoint_every


def _example(name, argv):
    """examples/<name>.py's main(argv), run in EXAMPLES, its lines logged.
    Returns what main returns."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    try:
        with contextlib.chdir(EXAMPLES), contextlib.redirect_stdout(buf):
            return module.main(argv)
    finally:
        for line in buf.getvalue().splitlines():
            log(f"    {line}")


def _route(p, steps):
    """The launch counters of the chunk functions of the cuda route that
    kernel_plan picks for a runner call of ``steps``."""
    from tpulbm_torch.dist import runner
    from tpulbm_torch.ops import resident, ring_p2p

    counter = {ring_p2p.grid_p2p_chunks: "grid_p2p",
               resident.resident_chunk: "resident_chunk"}
    return {counter[fn] for fn, _, _ in runner.kernel_plan(p, steps)}


def phase_examples():
    """The Python API's path (see the module docstring): the reference-deck
    example on 128^2 through the golden gate; the custom example's 256x512
    box, the HBM-edge resident tier's shape, on K2 alone, its outputs
    against the same deck run on K4, its K2 chunks shorter than 512 steps
    against their plain version, its resumed Simulations against the
    uninterrupted run."""
    import torch

    from tpulbm_torch.core.state import initial_state
    from tpulbm_torch.diag.observables import output_fields
    from tpulbm_torch.dist import runner
    from tpulbm_torch.io import writers
    from tpulbm_torch.ops import _build, kstep_tile, resident
    from tpulbm_torch.sim.simulation import Simulation
    from tpulbm_torch.validation import check

    totals = dict.fromkeys(_build.LAUNCHES, 0)
    shutil.rmtree(EXAMPLES, ignore_errors=True)
    os.makedirs(EXAMPLES)
    os.symlink(os.path.join(ROOT, "data"), os.path.join(EXAMPLES, "data"))
    smi = _smi()
    t0 = time.perf_counter()

    deck = "128x128"
    log(f"[examples] python examples/torch_run_reference_deck.py ({deck})")
    _build.reset_launches()
    result = _example("torch_run_reference_deck", [])
    counts = dict(_build.LAUNCHES)
    p = result.params
    route = _route(p, p.max_iters)
    _check_launches(f"{deck} example", counts, [*route, "reduce_partials"],
                    [c for c in KERNEL_COUNTERS if c not in route])
    for key, v in counts.items():
        totals[key] += v
    log(f"[examples] {deck}: {p.max_iters} steps in {result.elapsed_s:.3f} "
        f"s, {p.total_updates / result.elapsed_s / 1e6:.1f} MLUPS "
        f"({smi}); route {', '.join(sorted(route))}")
    _golden(deck, os.path.join(EXAMPLES, "out", deck),
            "examples/torch_run_reference_deck.py")
    del result
    _free()

    log("[examples] python examples/torch_custom_simulation.py (256x512)")
    _build.reset_launches()
    result, resumed = _example("torch_custom_simulation", [])
    counts = dict(_build.LAUNCHES)
    sim, p = result.sim, result.params
    steps = p.max_iters
    calls = Simulation._plan_chunks(0, steps, EXAMPLE_CKPT_EVERY,
                                    EXAMPLE_CKPT_EVERY)
    plan = [(fn, k) for n in calls for fn, k, _ in runner.kernel_plan(p, n)]
    short = sorted({k for _, k in plan if k < resident.RESIDENT_K})
    _check_launches("256x512 example", counts,
                    ["resident_chunk", "reduce_partials"],
                    [c for c in KERNEL_COUNTERS if c != "resident_chunk"])
    for key, v in counts.items():
        totals[key] += v
    if not ({fn for fn, _ in plan} == {resident.resident_chunk} and short
            and counts["resident_chunk"] == len(plan)):
        raise AssertionError(f"256x512 example: {counts['resident_chunk']} "
                             f"K2 launches for a plan of {len(plan)} chunks "
                             f"({sorted({k for _, k in plan})} steps)")
    ck = os.path.join(EXAMPLES, "out", "custom_ckpts")
    names = sorted(os.listdir(ck))
    want = [f"ckpt_{s:08d}.npz"
            for s in range(EXAMPLE_CKPT_EVERY, steps + 1, EXAMPLE_CKPT_EVERY)]
    with open(os.path.join(EXAMPLES, "out", "custom_metrics.jsonl")) as fh:
        metrics = fh.readlines()
    if names != want or len(metrics) != len(calls):
        raise AssertionError(f"256x512 example: checkpoints {names}, "
                             f"{len(metrics)} metrics lines")
    log(f"[examples] 256x512: {steps} steps in {result.elapsed_s:.3f} s, "
        f"{p.total_updates / result.elapsed_s / 1e6:.1f} MLUPS ({smi}); "
        f"{len(calls)} runner calls, {counts['resident_chunk']} K2 launches "
        f"(chunks of {sorted({k for _, k in plan})} steps), {len(names)} "
        f"checkpoints, {len(metrics)} metrics lines")

    # K2's chunks shorter than RESIDENT_K against their plain version, on
    # the example's mask: over hundreds of steps the sums drift apart as
    # K6's do over many chunks, so they are gated as K6's are
    o = sim.obstacles.float()
    f0 = _state(p, SEED + 19)
    free = int((o == 0).sum().item())
    for k in short:
        _compare_chunk(
            f"resident_chunk K2 (the 256x512 example's {k}-step chunk)",
            lambda: resident._resident_launch(f0, o, p, k),
            lambda: resident.resident_chunk_ref(f0, o, p, k), 10, 1,
            chunk_bound(p.ny * p.nx, k),
            lambda f: min(sums_atol([g], [o], free)[0] for g in (f0, f)))
    del f0

    # the same deck on K4 (tile_chunk), its outputs written alike
    f_k4, av_k4 = runner.run_plan(
        runner._chunks(kstep_tile.tile_chunk, kstep_tile.TILE_K, steps),
        initial_state(p, "cuda"), o, p)
    ex_out = os.path.join(EXAMPLES, "out", "custom")
    k4_out = os.path.join(EXAMPLES, "out", "custom_k4")
    os.makedirs(k4_out)
    mask = sim.obstacles
    writers.write_final_state(
        os.path.join(k4_out, "final_state.dat"), None, mask.cpu().numpy(), p,
        fields=[x.cpu().numpy() for x in output_fields(f_k4, mask,
                                                       p.density)])
    writers.write_av_vels(os.path.join(k4_out, "av_vels.dat"),
                          av_k4.cpu().numpy())
    ok, av_d, fs_d = check.check_results(
        os.path.join(k4_out, "av_vels.dat"),
        os.path.join(k4_out, "final_state.dat"),
        os.path.join(ex_out, "av_vels.dat"),
        os.path.join(ex_out, "final_state.dat"), GOLDEN_TOL, verbose=False)
    diff = (result.f - f_k4).abs().max().item()
    log(f"[examples] 256x512 on K2 (the example) vs K4 (tile_chunk, "
        f"{-(-steps // kstep_tile.TILE_K)} chunks): av_vels max diff "
        f"{av_d.max_diff_pcnt:.3g} %, final_state max diff "
        f"{fs_d.max_diff_pcnt:.3g} % (<= {GOLDEN_TOL:g} %); max|df| "
        f"{diff:.3e}, state bitwise {torch.equal(result.f, f_k4)}, "
        f"final_state.dat the same bytes "
        f"{_read(ex_out, 'final_state.dat') == _read(k4_out, 'final_state.dat')}"
        f", av_vels.dat {_read(ex_out, 'av_vels.dat') == _read(k4_out, 'av_vels.dat')}")
    if not ok:
        raise AssertionError("256x512: the example's K2 run and K4's disagree")
    del f_k4, av_k4

    # the example's resumed Simulation (its last checkpoint), and one resumed
    # from the middle checkpoint and run to the end, against the
    # uninterrupted run: the same bytes
    mid = Simulation(p, mask.cpu().numpy())
    mid.restore_checkpoint(os.path.join(ck, want[len(want) // 2 - 1]))
    start = mid.step_count
    mid.run()
    for what, other in ((f"resumed at step {resumed.step_count}", resumed),
                        (f"resumed at step {start}, run to the end", mid)):
        n = other.step_count
        same = (n == sim.step_count and torch.equal(other.f, sim.f)
                and other.av_vels[:n].tobytes() == sim.av_vels[:n].tobytes())
        log(f"[examples] 256x512 {what}: state and av_vels[:{n}] the same "
            f"bytes as the uninterrupted run: {same}")
        if not same:
            raise AssertionError(f"256x512 {what}: differs from the "
                                 f"uninterrupted run")
    del result, resumed, sim, mid
    _free()
    log(f"[examples] the examples phase {time.perf_counter() - t0:.1f} s "
        f"({smi})")
    return totals


# The float64 oracle (phase 10). Gates: the av series against the upstream
# golden (the JAX package's oracle: 2e-12 at 256^2 over 80,000 steps and
# 4.7e-12 at 1024^2 over 100, docs/VALIDATION.md); the regenerated pressure
# against the committed golden (f32 storage: a few elements one ulp, ~1e-7,
# apart); the port's f32 route against the oracle (the 1 % gate).
F64_RUN = ("256x256", 80000)
F64_GRAPH_RUNS = [("256x256", 2000), ("1024x1024", 100)]
F64_PREFIX_TOL = 1e-10
F64_STUDY = ("128x128", 2000)
F64_STUDY_TOL = 1e-2
F64_GOLDENS = os.path.join(OUT, "f64_goldens")


def phase_f64():
    """The float64 oracle on the card (see the module docstring). Returns
    the launch counts of the study's f32 route."""
    import numpy as np

    from tpulbm_torch.ops import _build
    from tpulbm_torch.tools import make_f64_goldens as mk
    from tpulbm_torch.tools import validate_f64 as v
    from tpulbm_torch.validation import check

    smi = _smi()
    data = os.path.join(ROOT, "data")
    golden = os.path.join(ROOT, "tests", "goldens")
    t0 = time.perf_counter()

    # (a) 256^2, the whole run: the av gate, the regenerated golden against
    # the committed one, phase 4's K2 run against the regenerated golden
    deck, steps = F64_RUN
    shutil.rmtree(F64_GOLDENS, ignore_errors=True)
    path, seconds, rel = mk.make_golden(deck, device="cuda",
                                        out_dir=F64_GOLDENS, data_dir=data,
                                        golden_dir=golden)
    p, _ = v.load_deck(deck, data)
    assert p.max_iters == steps, (deck, p.max_iters)
    log(f"[f64] {deck}: {steps} steps of the f64 oracle in {seconds:.3f} s, "
        f"{p.nx * p.ny * steps / seconds / 1e6:.1f} MLUPS ({smi}); av_vels "
        f"vs the upstream golden over all {steps} steps: max rel {rel:.3e} "
        f"(<= {mk.AV_GATE:g})")
    committed = os.path.join(golden, f"{deck}.final_state.f64.npz")
    worst, n_diff = mk.compare(path, committed)
    log(f"[f64] {deck}: regenerated pressure vs the committed "
        f"{os.path.basename(committed)}: max rel {worst:.3e}, {n_diff} of "
        f"{p.nx * p.ny} elements differ (<= {mk.COMPARE_GATE:g})")
    if not worst <= mk.COMPARE_GATE:
        raise AssertionError(f"{deck}: the regenerated f64 golden differs "
                             f"from the committed one by {worst:.3e}")
    out = os.path.join(OUT, deck)
    ok, av_d, fs_d = check.check_results(
        os.path.join(golden, f"{deck}.av_vels.dat"), path,
        os.path.join(out, "av_vels.dat"), os.path.join(out, "final_state.dat"),
        GOLDEN_TOL, verbose=False)
    log(f"[f64] {deck}: phase 4's K2 run against the regenerated golden: "
        f"av_vels max diff {av_d.max_diff_pcnt:.3g} %, final_state max diff "
        f"{fs_d.max_diff_pcnt:.3g} % (<= {GOLDEN_TOL:g} %)")
    if not ok:
        raise AssertionError(f"{deck}: phase 4's run fails the gate against "
                             f"the regenerated f64 golden")

    # the CUDA-graph path against the eager path, both timed; (b) the
    # 1024^2 prefix against the golden
    for deck, steps in F64_GRAPH_RUNS:
        p, obst = v.load_deck(deck, data)
        runs = {}
        for graph in (True, False):
            t = time.perf_counter()
            f, av = v.run_f64(p, obst, steps, device="cuda", graph=graph)
            runs[graph] = (f, av, time.perf_counter() - t)
        same = all(np.array_equal(a, b)
                   for a, b in zip(runs[True][:2], runs[False][:2]))
        ref = np.loadtxt(os.path.join(golden, f"{deck}.av_vels.dat"),
                         usecols=[1], max_rows=steps)
        rel = float(v.max_rel(runs[True][1], ref).max())
        log(f"[f64] {deck}, {steps} steps: CUDA graph {runs[True][2]:.3f} s "
            f"({p.nx * p.ny * steps / runs[True][2] / 1e6:.1f} MLUPS), eager "
            f"{runs[False][2]:.3f} s "
            f"({p.nx * p.ny * steps / runs[False][2] / 1e6:.1f} MLUPS) "
            f"({smi}); the same bytes: {same}; av_vels vs the upstream golden "
            f"max rel {rel:.3e}")
        if not same:
            raise AssertionError(f"{deck}: the f64 oracle's CUDA-graph path "
                                 f"differs from its eager path")
        if deck == "1024x1024" and not rel <= F64_PREFIX_TOL:
            raise AssertionError(f"{deck}: the f64 oracle's first {steps} "
                                 f"steps differ from the golden by {rel:.3e}")
        del runs

    # (c) the study: the port's f32 route (K2 at 128^2) against the oracle
    deck, steps = F64_STUDY
    _build.reset_launches()
    r = v.study(deck, steps, device="cuda", data_dir=data, golden_dir=golden)
    counts = dict(_build.LAUNCHES)
    route = _route(r["params"], steps)
    _check_launches(f"{deck} study", counts, [*route, "reduce_partials"],
                    [c for c in KERNEL_COUNTERS if c not in route])
    p = r["params"]
    log(f"[f64] {deck}, {steps} steps: the f64 oracle {r['f64_s']:.3f} s "
        f"({p.nx * p.ny * steps / r['f64_s'] / 1e6:.1f} MLUPS), the port's "
        f"f32 route ({', '.join(sorted(route))}) {r['f32_s']:.3f} s "
        f"({smi}); max rel: f64 vs goldens {r['f64_vs_golden'].max():.3e}, "
        f"f32 vs f64 {r['f32_vs_f64'].max():.3e} (mean "
        f"{r['f32_vs_f64'].mean():.3e}; <= {F64_STUDY_TOL:g}), f32 vs "
        f"goldens {r['f32_vs_golden'].max():.3e}")
    if not r["f32_vs_f64"].max() <= F64_STUDY_TOL:
        raise AssertionError(f"{deck}: the port's f32 route is "
                             f"{r['f32_vs_f64'].max():.3e} from the oracle")
    del r
    _free()
    log(f"[f64] the f64 phase {time.perf_counter() - t0:.1f} s ({smi})")
    return counts


KERNELS = [
    # (counter, name, source, replaces)
    ("resident_chunk", "lbm_resident_chunk (K2)",
     "tpulbm_torch/csrc/resident.cu",
     "tpulbm/ops/pallas_resident.py:63, tpulbm/ops/pallas_resident.py:107"),
    ("skew_chunk", "lbm_fused_step (K1, skew_chunk; off the route, the "
     "one-step reference of K4)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/pallas_kstep_skew.py:94"),
    ("kstep_chunk", "lbm_fused_step (K1, kstep_chunk; off the route)",
     "tpulbm_torch/csrc/fused_step.cu", "tpulbm/ops/pallas_kstep.py:79"),
    ("reduce_partials", "reduce_row / reduce_rows (the former K3 "
     "lbm_reduce_partials, now the epilogue of K1, K2, K4 and K6; launches "
     "count the chunks it reduced)",
     "tpulbm_torch/csrc/lbm_cell.cuh", "tpulbm/ops/window_step.py:384"),
    ("tile_chunk", "lbm_kstep_tile (K4, tile_chunk: whole grid; off the "
     "route, the bitwise reference of K6's grid kind and of K2)",
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
     "tpulbm/ops/pallas_kstep_bands.py:118, tpulbm/ops/pallas_step.py:55"),
    ("ring_p2p", "lbm_ring_p2p (K6, the cuda-p2p ring: every shard of a "
     "card for up to 64 chunks a launch, the slabs handed between shards "
     "inside the kernel)",
     "tpulbm_torch/csrc/ring_p2p.cu",
     "tpulbm/ops/pallas_kstep_rdma.py:65, "
     "tpulbm/ops/pallas_resident_rdma.py:63"),
    ("torus_chunk", "lbm_kstep_tile_torus (K4, torus_chunk: torus mode, the "
     "per-block body of the 2-D torus; the route past K6 torus mode's "
     "limits and across hosts)",
     "tpulbm_torch/csrc/kstep_tile.cu",
     "tpulbm/ops/pallas_kstep.py:79 (x_halo=True)"),
    ("torus_p2p", "lbm_torus_p2p (K6 torus mode, the torus in one process "
     "or across processes: every block of a card for up to 64 chunks a "
     "launch, edge columns, rows and corners handed between blocks inside "
     "the kernel)",
     "tpulbm_torch/csrc/ring_p2p.cu",
     "tpulbm/ops/pallas_kstep.py:79 (x_halo=True)"),
    ("grid_p2p", "lbm_grid_p2p (K6's grid kind, the one-card wide route: "
     "the whole periodic grid for up to 64 chunks a launch, the tiles "
     "handing off between chunks through epoch flags)",
     "tpulbm_torch/csrc/ring_p2p.cu",
     "tpulbm/ops/pallas_kstep_skew.py:94, tpulbm/ops/pallas_kstep.py:79, "
     "tpulbm/ops/pallas_kstep_skew_fold.py:118, "
     "tpulbm/ops/pallas_kstep_skew_fold.py:497, "
     "tpulbm/ops/pallas_kstep_skew2d.py:112, "
     "tpulbm/ops/pallas_kstep_skew.py:751, tpulbm/ops/pallas_kstep2d.py:79"),
]


def phase_cards(processes_only=False, torus_only=False):
    """The ring and the torus across cards (``--cards``; needs two or
    more): the kernel-phase check of ``_ring_on_cards``, the 1024^2 deck
    over the cards on the cuda and the cuda-p2p ring (the same bytes), over
    twice as many shards with cuda-p2p (two a card, neither neighbour of a
    shard on its card) and over 3, and 128^2, through the golden gate;
    8192^2 over the cards on both rings, the state bitwise one card's K4
    run; the torus over 2x2 with block (i, j) on card (2i + j) % cards:
    1024^2 through the golden gate, and 8192^2, its state bitwise one
    card's K4 run; on four cards, ``_processes_on_cards`` and
    ``_torus_processes_on_cards``. ``processes_only`` (``--cards
    --processes``, four cards): only those two and what they are held
    against, one card's 8192^2 run, the one-process ring over the four
    cards at 1024^2 and the one-process torus. ``torus_only`` (``--cards
    --torus``): only the torus across cards, in one process and (on four
    cards) across processes, and what it is held against."""
    import torch

    from tpulbm_torch.ops import _build
    from tpulbm_torch.sim.simulation import Simulation

    if torch.cuda.device_count() < (4 if processes_only else 2):
        raise SystemExit(f"chip_smoke --cards: needs "
                         f"{'four' if processes_only else 'two'} or more "
                         f"CUDA devices")
    deck, steps = TORUS_WIDE_RUN
    one = Simulation.from_files(*deck_files(deck))
    one.run()
    f_one = one.f.cpu()
    del one
    _free()
    n = min(4, torch.cuda.device_count())
    totals = dict.fromkeys(_build.LAUNCHES, 0)
    if processes_only:
        _mesh_golden("1024x1024", 20000, ["--device-count", str(n)], totals)
        _processes_on_cards(f_one, totals)
        _torus_processes_on_cards(f_one, totals)
        return
    if torus_only:
        _torus_on_cards(f_one, totals)
        if n >= 4:
            _torus_processes_on_cards(f_one, totals)
        return
    _ring_on_cards()
    outs = {}
    for deck, steps, shards, extra in (
            ("1024x1024", 20000, n, []), ("1024x1024", 20000, n, P2P),
            ("1024x1024", 20000, 2 * n, P2P),
            ("1024x1024", 20000, 3, []), ("128x128", 40000, n, [])):
        outs[deck, shards, tuple(extra)] = _mesh_golden(
            deck, steps, ["--device-count", str(shards), *extra], totals)
    _same_bytes(outs["1024x1024", n, tuple(P2P)], outs["1024x1024", n, ()],
                f"1024x1024 over {n} cards, cuda-p2p",
                ref_what="the cuda ring's run")
    deck, steps, _ = RING_WIDE_RUN
    for extra in ([], P2P):
        sim, _ = _mesh_cli(deck, steps, ["--device-count", str(n), *extra],
                           totals)
        f_ring = sim.f.cpu()
        del sim
        same = torch.equal(f_ring, f_one)
        log(f"[ring] {deck} over {n} cards{' (cuda-p2p)' if extra else ''} "
            f"vs one card's K4 run: state bitwise {same}")
        if not same:
            raise AssertionError(f"{deck} over {n} cards disagrees")
        del f_ring
        _free()
    _torus_on_cards(f_one, totals)
    if n >= 4:
        _processes_on_cards(f_one, totals)
        _torus_processes_on_cards(f_one, totals)
    else:
        log("[multiproc] fewer than four cards: the NCCL transport is not "
            "run")


def _torus_on_cards(f_one, totals):
    """The torus over 2x2 with block (i, j) on card (2i + j) % cards (K6's
    torus mode, through peer memory): 1024^2 through the golden gate,
    8192^2 bitwise one card's K4 run (``f_one``); each on both torus
    routes in turns (``_torus_routes``)."""
    import torch

    _mesh_golden("1024x1024", 20000, TORUS, totals)
    deck, steps = TORUS_WIDE_RUN
    sim, _ = _mesh_cli(deck, steps, TORUS, totals)
    f_torus = sim.f.cpu()
    del sim
    same = torch.equal(f_torus, f_one)
    log(f"[torus] {deck} over 2x2 across cards vs one card's K4 run: state "
        f"bitwise {same}")
    if not same:
        raise AssertionError(f"{deck} over 2x2 across cards disagrees")
    del f_torus
    _free()
    for deck, _ in (("1024x1024", 20000), TORUS_WIDE_RUN):
        _torus_routes(deck)


def _torus_routes(deck, pairs=2, processes=None):
    """The torus over 2x2 on both its routes in turns
    (``tools/ring_ab.py --mesh-shape 2x2``: p2p, make_runner's route, K6's
    torus mode; and k4, K4's torus mode with the host's exchange), its
    lines logged; with ``processes`` (PxL) across the processes of the
    port's launcher (``--module tpulbm_torch.tools.ring_ab``), k4's
    exchange over the transport. The two routes' states must be bitwise
    the same; logs the two medians (MLUPS, the deck's full step count a
    call)."""
    args = [*deck_files(deck), "--mesh-shape", "2x2", "--pairs", str(pairs)]
    if processes is None:
        from tpulbm_torch.tools import ring_ab

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ring_ab.main(args)
        text = buf.getvalue()
    else:
        proc = subprocess.run(
            [sys.executable, "-m", "tpulbm_torch.dist.launch",
             "--local-smoke", processes, "--timeout", "600", "--module",
             "tpulbm_torch.tools.ring_ab", *args],
            cwd=ROOT, capture_output=True, text=True, timeout=700)
        rc, text = proc.returncode, proc.stdout + proc.stderr
    lines = text.splitlines()
    for line in lines:
        log(f"    {line}")
    if rc != 0:
        raise AssertionError(f"ring_ab {deck} --mesh-shape 2x2 returned {rc}")
    result = json.loads([line for line in lines if line.startswith("{")][-1])
    if not all(result["same_state"].values()):
        raise AssertionError(f"ring_ab {deck}: the routes' states differ: "
                             f"{result['same_state']}")
    med = result["median_mlups"]
    where = (f"as {processes} processes x cards" if processes else
             f"({_layout(result['layout'].split(','))})")
    log(f"[torus] {deck} over 2x2 {where}: p2p {med['p2p']:.1f} MLUPS, "
        f"K4's torus mode (k4) {med['k4']:.1f} MLUPS "
        f"({med['p2p'] / med['k4']:.2f}x), medians of {pairs} in turns, "
        f"the states bitwise the same")


def _one_card(deck):
    """The output directory of the deck's single-device run (made once a
    run)."""
    out = os.path.join(OUT, f"{deck}_one_card")
    if out not in MADE:
        log(f"[multiproc] python -m tpulbm_torch {deck} (one card)")
        _run_cli([*deck_files(deck), "--out-dir", out])
        MADE.add(out)
    return out


def _torus_processes_on_cards(f_one, totals):
    """The torus across processes on four cards (K6's torus mode in each
    process, the exchange through CUDA IPC mappings; the NCCL transport):
    2 processes x 2 cards and 4 x 1 of 2x2. 1024^2: the same bytes as the
    one-process torus over the four cards, final_state.dat one card's;
    8192^2: its state, from a dcp checkpoint of the last step, bitwise one
    card's K4 run (``f_one``); each on both torus routes in turns across
    the processes (``_torus_routes``). Then 128^2 over 2x4 as 8 processes,
    two a card (8 (process, card)s, 6 flag arrays a card): the bytes of one
    process's 2x4 run on the four cards."""
    import torch

    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.ops import _build
    from tpulbm_torch.sim import checkpoint as ckpt

    deck, steps = "1024x1024", 20000
    single = _one_card(deck)
    torus = os.path.join(OUT, f"{deck}_mesh-shape2x2")
    if torus not in MADE:
        # not yet run over the cards in this run (``_torus_on_cards``)
        _mesh_golden(deck, steps, TORUS, totals)
    wide, wide_steps = TORUS_WIDE_RUN
    for shape in ("2x2", "4x1"):
        out = os.path.join(OUT, f"{deck}_torus_processes_{shape}")
        _launch(deck, steps, [*TORUS, "--out-dir", out], "torus_p2p", totals,
                shape, "nccl", split=True)
        _same_bytes(out, torus, f"the torus over {shape} processes x cards",
                    ref_what="the one-process torus over the four cards")
        same = _read(out, "final_state.dat") == _read(single,
                                                      "final_state.dat")
        log(f"    final_state.dat the same bytes as one card's: {same}")
        if not same:
            raise AssertionError(f"{deck} over a 2x2 torus of {shape} "
                                 f"processes x cards disagrees with one card")
        ck = os.path.join(OUT, f"ckpt_{wide}_torus_{shape}")
        shutil.rmtree(ck, ignore_errors=True)
        _launch(wide, wide_steps, [*TORUS, "--no-output", "--ckpt-backend",
                                   "dcp", "--checkpoint-every",
                                   str(wide_steps), "--checkpoint-dir", ck],
                "torus_p2p", totals, shape, "nccl", split=True)
        _, f, _ = ckpt.restore(os.path.join(ck, f"ckpt_{wide_steps:08d}.dcp"),
                               read_params(deck_files(wide)[0]))
        same = torch.equal(torch.from_numpy(f), f_one)
        log(f"[multiproc] {wide} over a 2x2 torus of {shape} processes x "
            f"cards vs one card's K4 run: state bitwise {same}")
        shutil.rmtree(ck, ignore_errors=True)
        del f
        if not same:
            raise AssertionError(f"{wide} over a 2x2 torus of {shape} "
                                 f"processes x cards disagrees with one card")
        for d in (deck, wide):
            _torus_routes(d, processes=shape)
    deck, steps, mesh = "128x128", 1000, "2x4"
    pf, of = deck_files(deck)
    args = ["--mesh-shape", mesh, "--max-iters", str(steps)]
    one = os.path.join(OUT, f"{deck}_mesh-shape{mesh}_{steps}")
    log(f"[multiproc] python -m tpulbm_torch {deck} {' '.join(args)} (one "
        f"process, the four cards)")
    _build.reset_launches()
    _run_cli([pf, of, *args, "--out-dir", one])
    counts = dict(_build.LAUNCHES)
    _check_launches(deck, counts, ["torus_p2p", "reduce_partials"],
                    [c for c in KERNEL_COUNTERS if c != "torus_p2p"],
                    p2p_chunks=-(-steps // 8) * 8)
    for key, v in counts.items():
        totals[key] += v
    out = os.path.join(OUT, f"{deck}_torus_processes_8x1")
    _launch(deck, steps, [*args, "--out-dir", out], "torus_p2p", totals,
            "8x1", "gloo")
    _same_bytes(out, one, f"{deck} over {mesh} as 8 processes, two a card",
                ref_what=f"one process's {mesh} run on the four cards")


def _processes_on_cards(f_one, totals):
    """The launcher's NCCL transport on four cards: 2 processes x 2 cards
    and 4 x 1, each on the cuda ring and on cuda-p2p. 1024^2: the same
    bytes as the one-process ring over 4 (``phase_cards``), final_state.dat
    the bytes of one card's run; 8192^2 at its 1,000 steps: its state, read
    back from a dcp checkpoint of the last step, bitwise one card's K4 run
    (``f_one``); the MLUPS of both backends side by side."""
    import torch

    from tpulbm_torch.io.params_file import read_params
    from tpulbm_torch.sim import checkpoint as ckpt

    deck, steps = "1024x1024", 20000
    single = _one_card(deck)
    wide, wide_steps = TORUS_WIDE_RUN
    # one process's cuda-p2p over the four cards, the yardstick of this call
    mlups = {}
    for d, n_steps in ((deck, steps), (wide, wide_steps)):
        extra, metrics = _split(d, n_steps, "one_process_p2p")
        sim, _ = _mesh_cli(d, n_steps, ["--device-count", "4", *P2P, *extra],
                           totals)
        del sim
        _free()
        mlups[d, "one process"] = (None, _last_call(metrics, d))
    for shape in ("2x2", "4x1"):
        for backend, kernel, extra in (("cuda", "ring_chunk", []),
                                       ("cuda-p2p", "ring_p2p", P2P)):
            out = os.path.join(OUT, f"{deck}_processes_{shape}_{backend}")
            mlups[deck, backend] = _launch(deck, steps,
                                           [*extra, "--out-dir", out],
                                           kernel, totals, shape, "nccl",
                                           split=True)
            _same_bytes(out, os.path.join(OUT, f"{deck}_device-count4"),
                        f"{shape} processes x cards, {backend}",
                        ref_what="the one-process ring over 4 cards")
            same = _read(out, "final_state.dat") == _read(single,
                                                          "final_state.dat")
            log(f"    final_state.dat the same bytes as one card's: {same}")
            if not same:
                raise AssertionError(f"{deck} over {shape} processes x "
                                     f"cards ({backend}) disagrees with one "
                                     f"card")
            ck = os.path.join(OUT, f"ckpt_{wide}_{shape}")
            shutil.rmtree(ck, ignore_errors=True)
            mlups[wide, backend] = _launch(
                wide, wide_steps, [*extra, "--no-output", "--ckpt-backend",
                                   "dcp", "--checkpoint-every",
                                   str(wide_steps), "--checkpoint-dir", ck],
                kernel, totals, shape, "nccl", split=True)
            _, f, _ = ckpt.restore(
                os.path.join(ck, f"ckpt_{wide_steps:08d}.dcp"),
                read_params(deck_files(wide)[0]))
            same = torch.equal(torch.from_numpy(f), f_one)
            log(f"[multiproc] {wide} over {shape} processes x cards "
                f"({backend}) vs one card's K4 run: state bitwise {same}")
            shutil.rmtree(ck, ignore_errors=True)
            del f
            if not same:
                raise AssertionError(f"{wide} over {shape} processes x cards "
                                     f"({backend}) disagrees with one card")
        for d in (deck, wide):
            (p2p, p2p_last), (ring, ring_last) = (mlups[d, "cuda-p2p"],
                                                  mlups[d, "cuda"])
            one = mlups[d, "one process"][1]
            log(f"[multiproc] {d} over {shape} processes x cards: cuda-p2p "
                f"{p2p:.1f} MLUPS, the NCCL cuda ring {ring:.1f} MLUPS "
                f"({p2p / ring:.2f}x); the second of two calls: cuda-p2p "
                f"{p2p_last:.1f}, the NCCL cuda ring {ring_last:.1f} "
                f"({p2p_last / ring_last:.2f}x), one process's cuda-p2p over "
                f"the four cards {one:.1f} ({p2p_last / one:.2f}x)")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--cards", action="store_true",
        help="run only the ring and the torus across cards (needs two or "
             "more CUDA devices)")
    parser.add_argument(
        "--processes", action="store_true",
        help="with --cards: only the processes across four cards and what "
             "they are held against")
    parser.add_argument(
        "--torus", action="store_true",
        help="with --cards: only the torus across cards and what it is "
             "held against")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    kind = phase_device()
    phase_build()
    if args.cards:
        phase_cards(processes_only=args.processes, torus_only=args.torus)
        log(f"[time] the final-state gates against an f64-oracle golden: "
            f"{NPZ_GATES['runs']} runs, {NPZ_GATES['s']:.1f} s")
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
    # before the ring's torch.profiler session (_ring_busy): after it, the
    # --profile-dir run's trace held 7 of its 10 K4 launches, for a cause
    # not found; in a fresh process it holds all
    for key, v in phase_checkpoint().items():
        launches[key] += v
    t3 = time.perf_counter()
    log(f"[time] checkpoint and profile runs {t3 - t2:.1f} s")
    for key, v in phase_ring(one_card).items():
        launches[key] += v
    t4 = time.perf_counter()
    log(f"[time] ring main path {t4 - t3:.1f} s")
    for key, v in phase_torus(one_card).items():
        launches[key] += v
    t5 = time.perf_counter()
    log(f"[time] torus main path {t5 - t4:.1f} s")
    del one_card
    for key, v in phase_multiproc().items():
        launches[key] += v
    t6 = time.perf_counter()
    log(f"[time] multi-process main path {t6 - t5:.1f} s")
    log(f"[time] phases 3-8 {t6 - t0:.1f} s")
    for key, v in phase_examples().items():
        launches[key] += v
    t7 = time.perf_counter()
    log(f"[time] examples {t7 - t6:.1f} s")
    log(f"[time] phases 3-9 {t7 - t0:.1f} s; of it the final-state gates "
        f"against an f64-oracle golden: {NPZ_GATES['runs']} runs, "
        f"{NPZ_GATES['s']:.1f} s")
    for key, v in phase_f64().items():
        launches[key] += v
    t8 = time.perf_counter()
    log(f"[time] f64 oracle {t8 - t7:.1f} s; phases 3-10 {t8 - t0:.1f} s")
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
