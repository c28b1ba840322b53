"""barrier_share.k2.sweep (%, csrc kernels: K2's step; moves sweep_mlups, in
sweep-128): the share of its warps' time that K2 spent waiting at the step
barrier for the slowest warp of its CTA, ``barrier_ns / warp_ns`` per
card, the mean over the cell's cards.

A warp times its wait from its arrival at the step's ``__syncthreads`` to
its release, in SM cycles, converted to ns by its CTA's life; a warp's
time is its CTA's life.

The numbers are K2's own clock readings, kept by the program
(``lbmbench/k2.py``), over the counting launches of the traced sub-window
alone: the program counts only while a profiler session is open, so the
counting's cost is in this run's time and in no untraced run's. None where
the program keeps no such counter or no counting launch ran. The same
reading as ``barrier_share.k2``, in the cell that reports sweep_mlups."""

from lbmbench import k2


def read(run):
    return k2.share(run, "barrier_ns")
