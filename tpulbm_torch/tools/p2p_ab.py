"""Paired timing of K6 (``ops.ring_p2p``) of several trees on one card,
beside the cuda ring's chunk and K4's whole-grid chunk.

    python -m tpulbm_torch.tools.p2p_ab [TREE ...] \\
        [--shapes 8192x8192/4,1024x1024/4,128x128/2] [--rounds 3] \\
        [--sass-dir build/sass]

Each TREE is the root of another copy of the repository (an earlier commit
unpacked by ``git archive`` under the git-ignored ``build/``, or an edited
copy); its ``tpulbm_torch.ops`` is imported beside this tree's
(``kernel_ab.import_tree``) and every library is built at once. For each
shape (a deck of ``data/`` over N shards, all on this card) every tree
steps the same perturbed rest state (drawn from a seed on the card) with
its public ``p2p_chunks``: one launch of ``outer_per_launch`` chunks of 8
steps, the first reading the neighbours' states. The trees are timed in
turns, this tree first, then the others, then the others reversed and
this tree last, ``--rounds`` times, CUDA-event ms a launch; each tree's
state and sums after one launch are compared with this tree's (an edited
copy may be wrong on purpose: a timing floor). Beside them, in the same
call, from this tree: the cuda ring's chunk (``ring_chunk`` a shard with
the slabs cut from the neighbours, as ``chip_smoke.py`` issues it) and
K4's whole-grid chunk (``tile_chunk`` of the deck), CUDA-event ms.

Also prints each tree's ptxas lines of ``ring_p2p_kernel`` (registers,
stack, spills, from its ``build.log``) and, where ``cuobjdump`` is found,
counts of the instructions of ``ring_p2p_kernel<8>`` that show local
memory, constant-bank loads with a register index, and the memory
ordering (fences, strong loads and stores, L1 invalidations); with
``--sass-dir`` the kernel's SASS is written there, one file a tree.

Prints the card's name and power limit first, one line a turn and shape,
then one JSON line of the samples and each tree's median ms a chunk.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from tpulbm_torch.dist import sharding
from tpulbm_torch.dist.mesh import get_mesh
from tpulbm_torch.ops import _build, kstep_tile, ring_p2p
from tpulbm_torch.tools.kernel_ab import _deck, cuda_ms, import_tree

SEED = 20260
K = kstep_tile.TILE_K
OPS = ("_build", "ring_p2p")
# SASS opcodes counted in ring_p2p_kernel<8>: local memory, constant-bank
# loads (a register index shows as c[...][R..]), and memory ordering.
SASS_OPS = ("LDL", "STL", "LDC", "MEMBAR", "FENCE", "CCTL", "ERRBAR",
            "STRONG", "BAR", "SYNCS", "LDGSTS", "UBLKCP", "NANOSLEEP")


def ptxas_lines(build_dir: Path, kernel: str = "ring_p2p_kernel") -> list:
    """The ptxas lines (registers, stack, spills) of every instance of
    ``kernel`` (K6's ring mode, or ``torus_p2p_kernel``) in
    ``build_dir``'s build.log, each prefixed by its k."""
    log = build_dir / "build.log"
    if not log.exists():
        return []
    out, fn = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\S+?)'?(?: for|$)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and kernel in fn and (
                "Used" in line or "spill" in line or "stack" in line):
            k = re.search(r"ILi(\d+)E", fn)
            out.append(f"k={k.group(1) if k else '?'}: {line.strip()}")
    return out


def _cuobjdump():
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    return cand if os.path.exists(cand) else None


def sass_summary(lib_path: Path, out_file):
    """Counts of SASS_OPS in ring_p2p_kernel<8> of the library (None
    without cuobjdump); the kernel's SASS is written to out_file if given."""
    tool = _cuobjdump()
    if tool is None:
        return None
    res = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300)
    text, body, on = res.stdout, [], False
    for line in text.splitlines():
        if "Function :" in line:
            on = "ring_p2p_kernel" in line and "ILi8E" in line
        if on:
            body.append(line)
    if out_file:
        Path(out_file).parent.mkdir(parents=True, exist_ok=True)
        Path(out_file).write_text("\n".join(body) + "\n")
    instrs = [ln for ln in body if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]
    counts = {op: sum(1 for ln in instrs if re.search(rf"\b{op}\b", ln))
              for op in SASS_OPS}
    counts["instructions"] = len(instrs)
    counts["LDC_register_index"] = sum(
        1 for ln in instrs if re.search(r"\bLDC\b.*c\[0x[0-9a-f]+\]\[R", ln))
    counts["strong_lines"] = sorted({
        re.sub(r"^.*?\*/\s*|\s*;.*$|R\d+|UR\d+|0x[0-9a-f]+|\[[^\]]*\]", "",
               ln).strip()
        for ln in instrs if re.search(r"STRONG|MEMBAR|FENCE|CCTL", ln)})
    return counts


def _shape(spec: str):
    deck, n = spec.split("/")
    return deck, int(n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", type=Path,
                    help="roots of the other trees (each holds tpulbm_torch/)")
    ap.add_argument("--shapes", default="8192x8192/4,1024x1024/4,128x128/2",
                    help="deck/shards, comma-separated")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--sass-dir", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("p2p_ab: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    sides = {"this": {"_build": _build, "ring_p2p": ring_p2p}}
    for tree in args.trees:
        sides[str(tree)] = import_tree(tree, OPS)
    names = list(sides)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(lambda s: s["_build"].build(),
                             sides.values()))
    info = {}
    for name, lib in zip(names, libs):
        print(f"[p2p_ab] {name}: built {lib}", flush=True)
        lines = ptxas_lines(sides[name]["_build"].BUILD_DIR)
        for line in lines:
            print(f"[p2p_ab] {name}: ptxas {line}", flush=True)
        sass = sass_summary(lib, args.sass_dir and os.path.join(
            args.sass_dir, re.sub(r"\W+", "_", name).strip("_") + ".sass"))
        print(f"[p2p_ab] {name}: ring_p2p_kernel<8> SASS {sass}", flush=True)
        info[name] = {"ptxas": lines, "sass": sass}
    records = []
    order = names + names[:0:-1] + names[:1]
    for spec in args.shapes.split(","):
        deck, n = _shape(spec)
        p, o, f0 = _deck(deck, SEED + 18)
        mesh = get_mesh(n)
        rows, offsets = sharding.ring_rows(p.ny, n)
        shards = [f0[:, a:a + h].contiguous() for a, h in zip(offsets, rows)]
        del f0
        bands = [o[torch.arange(a - K, a + h + K, device="cuda") % p.ny]
                 .contiguous() for a, h in zip(offsets, rows)]
        bases = [(a - K) % p.ny for a in offsets]
        n_outer = ring_p2p.outer_per_launch(rows, p.nx, K)
        runs = {}
        for name in names:
            rp = sides[name]["ring_p2p"]
            ex = rp.Exchange(mesh, rows, p.nx)
            states = [s.clone() for s in shards]
            spares = [torch.empty_like(s) for s in states]
            got = rp.p2p_chunks(ex, states, spares, bands, p, K, n_outer,
                                bases, True)
            torch.cuda.synchronize()
            ex.check()
            runs[name] = (rp, ex, got[0] + got[2])
        want = runs["this"][2]
        same = {name: all(torch.equal(a, b) for a, b in zip(r[2], want))
                for name, r in runs.items()}
        for name in names:
            rp, ex, _ = runs[name]
            runs[name] = (rp, ex, [s.clone() for s in shards],
                          [torch.empty_like(s) for s in shards])
        torch.cuda.empty_cache()
        reps = max(1, int(300 / max(1e-3, cuda_ms(
            lambda: _launch(runs["this"], bands, p, n_outer, bases), 1))))
        samples = {name: [] for name in names}
        for _ in range(args.rounds):
            for name in order:
                ms = cuda_ms(lambda: _launch(runs[name], bands, p, n_outer,
                                             bases), reps)
                samples[name].append(ms / n_outer)
                print(f"[p2p_ab] {deck} over {n}: {name} {ms:.4f} ms a "
                      f"launch of {n_outer} chunks, {ms / n_outer:.4f} ms a "
                      f"chunk", flush=True)
        for name in names:
            runs[name][1].check()
        del runs
        torch.cuda.empty_cache()

        def ring():
            f = [s.clone() for s in shards]
            for _ in range(4):
                f = [kstep_tile.ring_chunk(
                    f[d - 1][:, -K:].contiguous(), f[d],
                    f[(d + 1) % n][:, :K].contiguous(), bands[d], p, K,
                    bases[d])[0] for d in range(n)]
            return f

        ring_ms = cuda_ms(ring, max(1, reps * n_outer // 8)) / 4
        del bands, shards
        torch.cuda.empty_cache()
        p, o, f0 = _deck(deck, SEED + 18)
        k4_ms = cuda_ms(lambda: kstep_tile.tile_chunk(f0, o, p, K),
                        max(1, reps * n_outer // 2))
        del f0, o
        torch.cuda.empty_cache()
        med = {name: statistics.median(v) for name, v in samples.items()}
        print(f"[p2p_ab] {deck} over {n} shards, one card: median ms a chunk "
              + ", ".join(f"{name} {m:.4f}" for name, m in med.items())
              + f"; the cuda ring {ring_ms:.4f} (ring_chunk x {n} and the "
              f"slabs); K4 whole grid {k4_ms:.4f}; bitwise this tree's "
              f"{same}", flush=True)
        records.append({"deck": deck, "shards": n, "n_outer": n_outer,
                        "ms_a_chunk": samples, "median": med,
                        "cuda_ring_ms": ring_ms, "k4_grid_ms": k4_ms,
                        "bitwise_this": same})
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "trees": info, "shapes": records}), flush=True)
    return 0


def _launch(run, bands, p, n_outer, bases):
    rp, ex, states, spares = run
    rp.p2p_chunks(ex, states, spares, bands, p, K, n_outer, bases, True)


if __name__ == "__main__":
    raise SystemExit(main())
