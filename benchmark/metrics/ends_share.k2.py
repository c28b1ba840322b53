"""ends_share.k2 (%, csrc kernels: K2's step; moves mlups, in solve-128): the
share of its warps' time that K2 spent at its launches' ends, ``ends_ns /
warp_ns`` per card, the mean over the cell's cards: the window's load
before the first step, and the last step's partial, the grid barrier and
the epilogue that reduces the partials after the last.

The numbers are K2's own clock readings, kept by the program
(``lbmbench/k2.py``), over the counting launches of the traced sub-window
alone: the program counts only while a profiler session is open, so the
counting's cost is in this run's time and in no untraced run's. None where
the program keeps no such counter or no counting launch ran.
``ends_share.k2.sweep`` reads the same in the cell that reports
sweep_mlups."""

from lbmbench import k2


def read(run):
    return k2.share(run, "ends_ns")
