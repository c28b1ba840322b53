"""Build and load the CUDA kernels of ``tpulbm_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into an object file, one
``nvcc`` a source, all started together, and links them into one shared
library with a plain C interface under ``build/tpulbm_torch/`` at the
repository root (git-ignored); the file name carries a hash of the sources,
so an edit rebuilds and an unchanged tree reuses the library. ``ctypes``
binds it: each entry point takes ``c_void_p`` pointers and the CUDA stream,
``c_int`` and ``c_float`` scalars, and returns a ``cudaError_t`` that
``check`` turns into an exception. Nothing here runs at import time, and
torch is imported only where a tensor is handled, so a launcher can build
the library without it.

Every kernel wrapper adds one to its entry of ``LAUNCHES`` where it launches
its kernel and nowhere else, so a run can show which kernels it went through.

The stepping kernels reduce a chunk's per-step sums themselves; K1 and K4
find the block that finishes last by tickets
(``csrc/lbm_cell.cuh::last_ticket``) on one zeroed ``unsigned int`` per
device: ``ticket_counter`` makes it once and caches it. Launches that share
it must be ordered, which holds because every wrapper launches on the
device's current stream; the last block resets it, so a launch that faults
midway leaves it non-zero.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpulbm_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# Launch counts per kernel wrapper (see the module docstring).
LAUNCHES = {
    "skew_chunk": 0,        # K1 launches made by ops.kstep.skew_chunk
    "kstep_chunk": 0,       # K1 launches made by ops.kstep.kstep_chunk
    "resident_chunk": 0,    # K2 launches made by ops.resident.resident_chunk
    "tile_chunk": 0,        # K4 launches made by ops.kstep_tile.tile_chunk
    "ring_chunk": 0,        # K4 launches made by ops.kstep_tile.ring_chunk
    "torus_chunk": 0,       # K4 launches made by ops.kstep_tile.torus_chunk
    "ring_p2p": 0,          # K6 launches (one a card) made by ring_p2p
    "torus_p2p": 0,         # K6 torus-mode launches (one a card) made by
                            # ring_p2p.torus_p2p_chunks
    "grid_p2p": 0,          # K6 grid-kind launches made by
                            # ring_p2p.grid_p2p_chunks
    # Chunks whose per-step sums the stepping kernels' epilogue reduced
    # (one per K1 chunk and K2 or K4 launch, one per chunk and shard of
    # a K6 launch, one per chunk of a grid-kind launch): the former K3 pass
    "reduce_partials": 0,
}

_lock = threading.Lock()
_lib = None
_counters: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
_SIGNATURES = {
    "lbm_fused_step_blocks": ([_I], _I),
    "lbm_fused_step": (
        [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _F, _F, _F, _P], _I),
    "lbm_resident_max_ctas": ([_I, _I, _I], _I),
    "lbm_resident_chunk": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _I, _I, _I, _I, _F,
         _F, _F, _P], _I),
    "lbm_kstep_tile_blocks": ([_I, _I], _I),
    "lbm_kstep_tile_smem": ([_I], _I),
    "lbm_kstep_tile_ctas_per_sm": ([_I], _I),
    "lbm_kstep_tile": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _P], _I),
    "lbm_kstep_tile_ring": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _I,
         _P], _I),
    "lbm_kstep_tile_torus": (
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _I,
         _I, _I, _I, _P], _I),
    "lbm_ring_p2p_words": ([], _I),
    "lbm_ring_p2p_max_local": ([], _I),
    "lbm_ring_p2p_max_outer": ([], _I),
    "lbm_ring_p2p_smem": ([_I], _I),
    "lbm_ring_p2p_ctas": ([_I], _I),
    "lbm_ring_p2p_enable_peer": ([_I, _I], _I),
    "lbm_ring_p2p_handle_bytes": ([], _I),
    "lbm_ring_p2p_alloc": ([_I, _L, ctypes.POINTER(_P), _P], _I),
    "lbm_ring_p2p_free": ([_I, _P], _I),
    "lbm_ring_p2p_open": ([_I, _P, ctypes.POINTER(_P)], _I),
    "lbm_ring_p2p_close": ([_I, _P], _I),
    "lbm_ring_p2p_copy": ([_P, _L, _P, _L, _L, _L, _P], _I),
    "lbm_ring_p2p": (
        [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _F, _F,
         _F, _I, _P], _I),
    "lbm_torus_p2p": (
        [_P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I, _F,
         _F, _F, _I, _I, _I, _P], _I),
    "lbm_grid_p2p_smem": ([_I], _I),
    "lbm_grid_p2p": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _I, _I,
         _I, _F, _F, _F, _I, _P], _I),
    "lbm_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "tpulbm_torch cannot be built"
    )


def build() -> Path:
    """Compile csrc/*.cu unless the library of this source hash exists:
    one ``nvcc -c`` a source, all at once, then one link. Writes to a
    temporary file and renames, so concurrent builders never load a
    half-written library; a file lock lets one process build while the
    others of a multi-process start wait and then load its library. The
    compilers' output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) goes to ``build.log``."""
    lib_path = BUILD_DIR / f"libtpulbm_torch_{source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib_path.exists():
            _compile(lib_path)
    return lib_path


def _compile(lib_path: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{p.stem}.o" for p in sorted(CSRC.glob("*.cu"))]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                 str(CSRC / f"{o.stem}.cu")] for o in objs]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(Path(tmp) / "lib.so"),
                *map(str, objs)]
        log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
        failed = [(c, p.returncode) for c, p in zip(cmds, procs)
                  if p.returncode]
        if not failed:
            res = subprocess.run(link, capture_output=True, text=True)
            log += " ".join(link) + "\n" + res.stdout + res.stderr
            if res.returncode:
                failed = [(link, res.returncode)]
        (BUILD_DIR / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0][1]}):\n{log}")
        os.replace(Path(tmp) / "lib.so", lib_path)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().lbm_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def on_device(t: torch.Tensor):
    """Context that makes ``t``'s card the current device: the C entry
    points set their kernel's attributes and launch on the current device,
    so every launch of a tensor on another card than the current one runs
    inside it."""
    import torch

    return torch.cuda.device(t.device)


def ticket_counter(device) -> torch.Tensor:
    """The zeroed int32 ticket counter of a CUDA device (see the module
    docstring), made on first use and cached."""
    import torch

    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    with _lock:
        if index not in _counters:
            _counters[index] = torch.zeros(1, dtype=torch.int32,
                                           device=f"cuda:{index}")
        return _counters[index]


def require_cuda(*tensors) -> None:
    """The kernels take contiguous float32 CUDA tensors on one device."""
    import torch

    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"CUDA kernel needs tensors on one CUDA device, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"CUDA kernel needs contiguous float32, got {t.dtype}")

