"""tile_wait_share.solve (%, csrc kernels: the one-card tile graph; moves
mlups): the share of its CTAs' time that K6's grid kind, the one-card wide
route, spent blocked on neighbour tiles' flags of the chunk before,
``wait_ns / cta_ns`` per card, the mean over the cell's cards.

The grid kind's CTAs count their waits and lives as K6's ring does
(``lbmbench/waits.py``): the program's own clock readings, over every
launch of the run, the 2 warm-up calls included. None where the program
keeps no such counter or launched no K6 (a tree whose wide route is K4)."""

from lbmbench import waits


def read(run):
    return waits.share(run, "wait_ns")
