"""p2p_remote_share.rows4 (%, csrc kernels: K6's exchange; moves mlups):
the part of ``p2p_wait_share.rows4`` spent on waits that, at their first
failed poll, found a flag of another card not done yet: ``remote_ns /
cta_ns`` per card, the mean over the cell's cards. What is left of the
wait share waited on tiles of the card itself.

The numbers are K6's own clock readings, kept by the program
(``lbmbench/waits.py``), over every K6 launch of the run, the 2 warm-up
calls included (~1.5 % of the calls), not the traced sub-window alone.
None where the program keeps no such counter or launched no K6."""

from lbmbench import waits


def read(run):
    return waits.share(run, "remote_ns")
