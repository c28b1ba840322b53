"""fill_wait_share.solve (%, csrc kernels: the grid kind's row stream;
moves mlups): the share of its CTAs' time that the stepping warps of K6's
grid kind, the one-card wide route, spent blocked awaiting level-0 ring
rows that the copy group had not landed, ``fill_ns / cta_ns`` per card,
the mean over the cell's cards.

Thread 0 of a CTA's stepping warps times each await of a ring row whose
first test fails, in SM cycles, converted to ns by the CTA's life, as the
producer's waits are (``lbmbench/waits.py``): the rows' loads from device
memory, or an item that the copy group has not been handed yet (a wait on
flags, which ``tile_wait_share.solve`` counts too while no item is in
flight). The program's own clock readings, over every grid-kind launch of
the run, the 2 warm-up calls included. None where the program keeps no
such word (a tree before it) or launched no K6."""

from lbmbench import waits


def read(run):
    counted = waits.counters() or {}
    if not all("fill_ns" in counted[c] for c in run.cards if c in counted):
        return None
    return waits.share(run, "fill_ns")
