"""p2p_wait_share.rows4 (%, csrc kernels: K6's exchange; moves mlups): the
share of its CTAs' time that K6 spent blocked on its neighbour tiles'
flags, ``wait_ns / cta_ns`` per card, the mean over the cell's cards.

A CTA's producer warp times a wait from its first poll that fails to the
poll that finds every flag done (the stepping warps have nothing to step
then); a CTA's time runs from its entry to its exit. The numbers are K6's
own clock readings, kept by the program
(``lbmbench/waits.py``), over every K6 launch of the run, the 2 warm-up
calls included (~1.5 % of the calls), not the traced sub-window alone.
None where the program keeps no such counter or launched no K6."""

from lbmbench import waits


def read(run):
    return waits.share(run, "wait_ns")
