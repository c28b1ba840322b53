"""idle_issue.solve (%, the ops and dist layers, the host's issue; moves
mlups): the share of the traced sub-window of whole runner calls in which
a card ran nothing while the host's innermost program span was one of the
runners' (``lbm.dist.*``: a runner call's issue of its chunks, the
exchanges, the sums, a runner's build), averaged over the cell's cards.
None where the program records no span."""

from lbmbench import spans


def read(run):
    return spans.idle_share(run, "lbm.dist.")
