"""Step-stamped checkpoint / resume: the npz half of
``tpulbm.sim.checkpoint``, numpy only.

A snapshot carries the full distribution state, the accumulated av_vels
prefix and the parameter deck, so a run resumes bitwise at its step. One
file a snapshot, ``ckpt_%08d.npz`` with the keys ``step``, ``f`` (the
(9, ny, nx) float32 state, gathered on the host), ``av_vels`` and
``params`` (the deck as JSON), written atomically by a rename: the file
name, keys and layout of the JAX package's, so a checkpoint written by
either package resumes in the other. The JAX package compresses its files;
these are stored uncompressed (``np.load`` reads both), since zlib took
seconds for a 1024^2 state, tens of times the write (PERF.md).
``AsyncCheckpointer`` writes on a thread, so the serialization overlaps
the next chunk. The orbax backend (sharded, multi-host saves) has no
counterpart yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Optional, Tuple

import numpy as np

from tpulbm_torch.core.params import LBMParams

_NAME_RE = re.compile(r"ckpt_(\d+)\.npz$")


def save(directory, step: int, f: np.ndarray, av_vels: np.ndarray,
         params: LBMParams) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        step=np.int64(step),
        f=np.asarray(f, dtype=np.float32),
        av_vels=np.asarray(av_vels, dtype=np.float32),
        params=json.dumps(dataclasses.asdict(params)),
    )
    os.replace(tmp, path)
    return path


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with the next compute chunk:
    ``submit`` hands the write to a writer thread; ``wait`` joins the
    in-flight write (called before the next submit and at shutdown). At
    most one write is in flight, so checkpoints are never reordered. The
    caller hands over a host copy of the state that nothing else writes."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._result: Optional[str] = None
        self._error: Optional[BaseException] = None

    def submit(self, directory, step, f, av_vels, params) -> None:
        self.wait()
        f = np.asarray(f)
        av_vels = np.array(av_vels, copy=True)

        def work():
            try:
                self._result = save(directory, step, f, av_vels, params)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> Optional[str]:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self._result


def latest(directory) -> str | None:
    if not os.path.isdir(directory):
        return None
    best = None
    best_step = -1
    for name in os.listdir(directory):
        m = _NAME_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(directory, name)
    return best


def restore(path_or_dir,
            params: LBMParams) -> Tuple[int, np.ndarray, np.ndarray]:
    """(step, f, av_vels) of a checkpoint file, or of the latest one in a
    directory; raises FileNotFoundError where there is none, and
    ValueError where its deck differs from ``params``."""
    path = str(path_or_dir)
    if os.path.isdir(path):
        path = latest(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {path_or_dir}")
    with np.load(path, allow_pickle=False) as z:
        step = int(z["step"])
        f = z["f"]
        av_vels = z["av_vels"]
        saved = json.loads(str(z["params"]))
    current = dataclasses.asdict(params)
    mismatched = {
        k: (saved[k], current[k])
        for k in saved
        # free_cells_inv depends on the obstacle file, checked via the grid;
        # max_iters may legitimately be overridden between sessions.
        if k not in ("free_cells_inv", "max_iters") and saved[k] != current[k]
    }
    if mismatched:
        detail = ", ".join(
            f"{k}: checkpoint={a!r} vs current={b!r}"
            for k, (a, b) in sorted(mismatched.items())
        )
        raise ValueError(f"checkpoint params do not match the deck ({detail})")
    return step, f, av_vels
