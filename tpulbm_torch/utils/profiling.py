"""Profiling hooks: the counterpart of ``tpulbm.utils.profiling``.

The reference brackets its step loop for TAU and Intel ITAC
(``MPI_Pcontrol(±1, "mainloop")``, d2q9-bgk.c:275-277,404-406); the JAX
package opens a ``jax.profiler`` trace annotation there. Here the region is
an NVTX range where a CUDA device is present (for a system-wide profiler),
else a ``torch.profiler.record_function``; with a trace directory it is
also recorded by ``torch.profiler`` (CUDA activity included on the card)
and exported there as a Chrome trace, ``<name>.pt.trace.json``.

Inside the package, ``span("lbm.<layer>.<what>")`` brackets the work of
each layer: the build and settling of a ``Simulation``, its runner calls,
their exchanges and sums, the readback and bookkeeping between calls, the
output planes and the text writers. A span is recorded into whatever
``torch.profiler`` session is open, as a host operation on the session's
clock, nested in the span around it on the same thread (a
``_RecordFunctionFast``, which puts nothing on a card's timeline, unlike a
``record_function``, whose range the profiler mirrors there); with no
session open it costs well under a microsecond and allocates no tensor.
Every span, traced or not, adds to a count and seconds per name in this
process: ``totals()``, ``reset_totals()``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
from time import perf_counter
from typing import Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile, record_function

# Each thread adds to a {name: [count, seconds]} of its own, so that no
# two threads update one entry; ``totals()`` adds them up.
_LOCAL = threading.local()
_PER_THREAD: list = []
_LOCK = threading.Lock()


def _thread_totals() -> dict:
    mine = {}
    with _LOCK:
        _PER_THREAD.append(mine)
    _LOCAL.totals = mine
    return mine


class span:
    """``with span("lbm.sim.run"): ...``: one named span (see the module
    docstring)."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._rf = _RecordFunctionFast(self.name)
            self._rf.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        seconds = perf_counter() - self._t0
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        try:
            mine = _LOCAL.totals
        except AttributeError:
            mine = _thread_totals()
        total = mine.get(self.name)
        if total is None:
            mine[self.name] = [1, seconds]
        else:
            total[0] += 1
            total[1] += seconds


def spanned(name: str):
    """A decorator: each call of the function is one ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def totals() -> dict:
    """{span name: (count, seconds)} of every span closed in this process
    since the last ``reset_totals()``, on any thread."""
    out = {}
    with _LOCK:
        parts = [list(part.items()) for part in _PER_THREAD]
    for items in parts:
        for name, (n, s) in items:
            count, seconds = out.get(name, (0, 0.0))
            out[name] = (count + n, seconds + s)
    return out


def reset_totals() -> None:
    with _LOCK:
        for part in _PER_THREAD:
            part.clear()


@contextlib.contextmanager
def trace_region(name: str, trace_dir: Optional[str] = None):
    """Scope a named trace region; if trace_dir is set, capture a full
    profiler trace of the region into it."""
    cuda = torch.cuda.is_available()
    with contextlib.ExitStack() as stack:
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if cuda:
                activities.append(ProfilerActivity.CUDA)
            prof = stack.enter_context(profile(activities=activities))
            stack.enter_context(record_function(name))
        if cuda:
            stack.enter_context(torch.cuda.nvtx.range(name))
        elif not trace_dir:
            stack.enter_context(record_function(name))
        yield
    if trace_dir:
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"{name}.pt.trace.json"))
