"""handoff_share.k2 (%, csrc kernels: K2's step; moves mlups, in solve-128):
the share of its warps' time that K2 spent filling the halo of an edge
step from its eight neighbours' slot words, the spins on words not yet
carrying the epoch included, ``fill_ns / warp_ns`` per card, the mean over
the cell's cards.

A warp times a fill from its first load to its last word taken (its lanes
joined), in SM cycles, converted to ns by its CTA's life.

The numbers are K2's own clock readings, kept by the program
(``lbmbench/k2.py``), over the counting launches of the traced sub-window
alone: the program counts only while a profiler session is open, so the
counting's cost is in this run's time and in no untraced run's. None where
the program keeps no such counter or no counting launch ran.
``handoff_share.k2.sweep`` reads the same in the cell that reports
sweep_mlups."""

from lbmbench import k2


def read(run):
    return k2.share(run, "fill_ns")
