"""ctypes bindings to the port's native C++ IO runtime
(``tpulbm_torch/csrc/io_native.cpp``).

g++ builds it on first use into the git-ignored ``build/tpulbm_torch/``,
under a file name that carries a hash of the source, so a library built
from another source text is never loaded. Its writers print each float32
"%.12E" exactly in integer arithmetic, with the bytes of C's printf and a
fraction of its time (formatting from Python is slower still). Every
caller has a pure Python/numpy path giving the same bytes for hosts without
g++ (or with ``TPULBM_NO_NATIVE`` set).

``FALLBACKS`` counts the values the writers formatted on their slow path
(subnormal, below 1e-32 or from 1e13 in magnitude, NaN, Inf); zero is
exact on the fast one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "tpulbm_torch" / "csrc" / "io_native.cpp"
_BUILD_DIR = _ROOT / "build" / "tpulbm_torch"

# Values formatted on the writers' slow path (see the module docstring).
FALLBACKS = 0

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> Path | None:
    """The library of ``_SRC``'s text, or None without the source."""
    try:
        text = _SRC.read_bytes()
    except OSError:
        return None
    digest = hashlib.sha256(text).hexdigest()[:16]
    return _BUILD_DIR / f"libtpulbm_io_{digest}.so"


def _build() -> Path | None:
    """The library of the source as it stands, compiled unless it exists;
    None where g++ fails or is absent."""
    lib_path = _lib_path()
    if lib_path is None or lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
    except (subprocess.SubprocessError, FileNotFoundError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib_path = None if os.environ.get("TPULBM_NO_NATIVE") else _build()
        if lib_path is None:
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.tpulbm_write_final_state.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, f32p, i32p,
        ]
        lib.tpulbm_write_final_state.restype = ctypes.c_longlong
        lib.tpulbm_write_av_vels.argtypes = [ctypes.c_char_p, ctypes.c_int, f32p]
        lib.tpulbm_write_av_vels.restype = ctypes.c_longlong
        lib.tpulbm_read_obstacles.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, i32p,
        ]
        lib.tpulbm_read_obstacles.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _count(rc: int, what: str, path) -> None:
    """A writer's return: -1 a failure, else its slow-path values."""
    global FALLBACKS
    if rc < 0:
        raise IOError(f"native {what} write failed: {path}")
    FALLBACKS += rc


def write_final_state(path, u_x, u_y, u, pressure, obstacles_i32) -> None:
    lib = _load()
    ny, nx = obstacles_i32.shape
    rc = lib.tpulbm_write_final_state(
        path.encode(), nx, ny,
        np.ascontiguousarray(u_x, dtype=np.float32),
        np.ascontiguousarray(u_y, dtype=np.float32),
        np.ascontiguousarray(u, dtype=np.float32),
        np.ascontiguousarray(pressure, dtype=np.float32),
        np.ascontiguousarray(obstacles_i32, dtype=np.int32),
    )
    _count(rc, "final_state", path)


def write_av_vels(path, av_vels) -> None:
    lib = _load()
    av = np.ascontiguousarray(av_vels, dtype=np.float32)
    rc = lib.tpulbm_write_av_vels(path.encode(), av.size, av)
    _count(rc, "av_vels", path)


def read_obstacles(path, nx, ny):
    """Returns (mask bool (ny,nx), num_free) or None if unavailable/failed."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros((ny, nx), dtype=np.int32)
    n_free = lib.tpulbm_read_obstacles(path.encode(), nx, ny, out)
    if n_free < 0:
        return None
    return out.astype(bool), int(n_free)
