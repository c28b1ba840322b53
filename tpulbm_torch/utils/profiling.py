"""Profiling hooks: the counterpart of ``tpulbm.utils.profiling``.

The reference brackets its step loop for TAU and Intel ITAC
(``MPI_Pcontrol(±1, "mainloop")``, d2q9-bgk.c:275-277,404-406); the JAX
package opens a ``jax.profiler`` trace annotation there. Here the region is
an NVTX range where a CUDA device is present (for a system-wide profiler),
else a ``torch.profiler.record_function``; with a trace directory it is
also recorded by ``torch.profiler`` (CUDA activity included on the card)
and exported there as a Chrome trace, ``<name>.pt.trace.json``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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
