"""ctypes bindings to the native C++ IO runtime (``native/io_native.cpp``).

The same library as ``tpulbm.io.native``, built by the port into its own
git-ignored directory ``build/tpulbm_torch/`` with g++ on first use:
formatting a million "%.12E" lines from Python is 10-20x slower than C
stdio. Every caller has a pure Python/numpy path giving the same bytes for
hosts without g++ (or with ``TPULBM_NO_NATIVE`` set).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "io_native.cpp"
_BUILD_DIR = _ROOT / "build" / "tpulbm_torch"
_LIB_PATH = _BUILD_DIR / "libtpulbm_io.so"

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        src_mtime = _SRC.stat().st_mtime
    except OSError:
        return False
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= src_mtime:
        return True
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(_SRC), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("TPULBM_NO_NATIVE") or not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
        lib.tpulbm_write_final_state.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, f32p, i32p,
        ]
        lib.tpulbm_write_final_state.restype = ctypes.c_int
        lib.tpulbm_write_av_vels.argtypes = [ctypes.c_char_p, ctypes.c_int, f32p]
        lib.tpulbm_write_av_vels.restype = ctypes.c_int
        lib.tpulbm_read_obstacles.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, i32p,
        ]
        lib.tpulbm_read_obstacles.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


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
    if rc != 0:
        raise IOError(f"native final_state write failed: {path}")


def write_av_vels(path, av_vels) -> None:
    lib = _load()
    av = np.ascontiguousarray(av_vels, dtype=np.float32)
    rc = lib.tpulbm_write_av_vels(path.encode(), av.size, av)
    if rc != 0:
        raise IOError(f"native av_vels write failed: {path}")


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
