"""The port's native text writers (``tpulbm_torch/csrc/io_native.cpp``):
every float32 printed "%.12E" with the bytes of C's printf, the count of
values formatted on the slow path, the same bytes as the pure-Python path
at the sweep's size, and a library name tied to its source text."""

import ctypes
import math
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from tpulbm_torch.io import native, writers
from tpulbm_torch.io.params_file import read_params

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "goldens"


@pytest.fixture
def built():
    if not native.available():
        pytest.skip("no g++ (or TPULBM_NO_NATIVE): no native writer")


def _f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _ties() -> list:
    """Exact halfway cases of 13 digits: m * 2^-q with m odd and m * 5^q of
    14 digits, so the 14th digit is a 5 with nothing after it."""
    rng = np.random.RandomState(7)
    out = []
    for q in range(1, 40):
        lo = -(-10**13 // 5**q) | 1
        hi = min((10**14 - 1) // 5**q, (1 << 24) - 1)
        if lo > hi:
            continue
        for m in {lo, hi - (hi % 2 == 0), *(rng.randint(lo, hi + 1, 40) | 1)}:
            if m <= hi:
                out.append(m * 2.0**-q)
    return out


def _cases() -> np.ndarray:
    rng = np.random.RandomState(19)
    normal = [(b << 23) | m for b in range(1, 255)
              for m in (0, 1, 0x7FFFFF, rng.randint(1, 1 << 23))]
    subnormal = [1, 2, 0x400000, 0x7FFFFF, rng.randint(1, 1 << 23)]
    ties = _ties()
    assert len(ties) > 300
    tens = np.float32([10.0**j for j in range(-30, 12)])
    below = np.nextafter(tens, np.float32(0))
    above = np.nextafter(tens, np.float32(np.inf))
    dyadic = np.arange(-10**5, 10**5 + 1, dtype=np.float32) * 2**-10
    pos = np.concatenate([
        _f32(normal), _f32(subnormal), np.float32([0.0, np.finfo("f4").max]),
        np.float32(ties), dyadic, tens, below, above,
        _f32(rng.randint(0, 1 << 32, 200_000, dtype=np.uint64)),
    ])
    assert pos.dtype == np.float32
    return np.concatenate([pos, -pos])


def _libc_e12(v: float) -> str:
    buf = ctypes.create_string_buffer(64)
    ctypes.CDLL(None).snprintf(buf, 64, b"%.12E", ctypes.c_double(v))
    return buf.value.decode()


def test_every_float32_kind_prints_as_printf(tmp_path, built):
    """Normal exponents, subnormals, +-0, +-FLT_MAX, halfway cases, dyadic
    i * 2^-10, neighbours of powers of ten and random bit patterns, line
    by line against Python's "%.12E" (C's printf for NaN and Inf, whose
    sign Python drops). The slow path takes exactly the subnormals, NaN,
    Inf and the values outside 1e-32 <= |v| < 1e13."""
    vals = _cases()
    before = native.FALLBACKS
    native.write_av_vels(str(tmp_path / "av"), vals)
    lines = (tmp_path / "av").read_text().splitlines(keepends=True)
    assert len(lines) == vals.size
    tiny = np.finfo(np.float32).tiny
    slow = 0
    for i, v in enumerate(vals.tolist()):
        if math.isfinite(v):
            want = "%.12E" % v
            exp10 = int(want[want.index("E") + 1:])
            slow += v != 0 and (abs(v) < tiny or not -32 <= exp10 <= 12)
        else:
            want = _libc_e12(v)
            slow += 1
        assert lines[i] == "%d:\t%s\n" % (i, want), (i, v)
    assert slow > 1000
    assert native.FALLBACKS - before == slow


def test_non_finite_and_subnormal_take_the_slow_path(tmp_path, built):
    vals = np.float32([np.nan, -np.nan, np.inf, -np.inf, 1e-45, -1e-40])
    before = native.FALLBACKS
    native.write_av_vels(str(tmp_path / "av"), vals)
    assert native.FALLBACKS - before == vals.size
    got = (tmp_path / "av").read_text().splitlines()
    assert got == [f"{i}:\t{_libc_e12(float(v))}" for i, v in enumerate(vals)]


def _golden_128():
    """The 128^2 deck's final planes (u_x, u_y, |u|, pressure) as float32,
    its mask, and its 40,000-step av series."""
    fs = np.loadtxt(GOLDEN / "128x128.final_state.dat")
    planes = [fs[:, c].astype(np.float32).reshape(128, 128)
              for c in (2, 3, 4, 5)]
    mask = fs[:, 6].reshape(128, 128).astype(bool)
    av = np.loadtxt(GOLDEN / "128x128.av_vels.dat",
                    usecols=[1]).astype(np.float32)
    assert av.shape == (40_000,)
    return planes, mask, av


def test_writers_give_identical_bytes_at_sweep_size(tmp_path, monkeypatch,
                                                    built):
    """The sweep's shape, a 128x128 field set and a 40,000-step av series,
    gives the same bytes on the native and pure-Python paths, with no value
    on the native path's slow path."""
    planes, mask, av = _golden_128()
    p = read_params(ROOT / "data" / "input_128x128.params")
    before = native.FALLBACKS
    writers.write_final_state(tmp_path / "n_fs", None, mask, p, fields=planes)
    writers.write_av_vels(tmp_path / "n_av", av)
    assert native.FALLBACKS == before
    monkeypatch.setattr(native, "available", lambda: False)
    writers.write_final_state(tmp_path / "p_fs", None, mask, p, fields=planes)
    writers.write_av_vels(tmp_path / "p_av", av)
    fs = (tmp_path / "n_fs").read_bytes()
    assert fs == (tmp_path / "p_fs").read_bytes()
    assert (tmp_path / "n_av").read_bytes() == (tmp_path / "p_av").read_bytes()
    assert fs.count(b"\n") == 128 * 128


def test_write_failure_raises(tmp_path, built):
    with pytest.raises(IOError):
        native.write_av_vels(str(tmp_path / "no" / "av"), np.float32([1.0]))


def test_library_name_follows_source_text(tmp_path, monkeypatch):
    """A library built from another source text has another file name, so
    the loader never takes it, however new its mtime."""
    text = native._SRC.read_bytes()
    src = tmp_path / "io_native.cpp"
    src.write_bytes(text)
    monkeypatch.setattr(native, "_SRC", src)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    first = native._lib_path()
    src.write_bytes(text + b"\n// another text\n")
    second = native._lib_path()
    assert first.parent == second.parent and first.name != second.name
    if shutil.which("g++") is None:
        pytest.skip("no g++: the libraries themselves are not built")
    src.write_bytes(text)
    assert native._build() == first and first.exists()
    src.write_bytes(text + b"\n// another text\n")
    future = src.stat().st_mtime + 3600
    os.utime(first, (future, future))
    assert native._build() == second and second.exists()
