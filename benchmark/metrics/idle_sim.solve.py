"""idle_sim.solve (%, the sim layer; moves mlups): the share of the traced
sub-window of whole runner calls in which a card ran nothing while the
host's innermost program span was one of ``Simulation``'s
(``lbm.sim.*``: the av readback, the bookkeeping between calls, the
result's history copy and Reynolds number), averaged over the cell's
cards. None where the program records no span."""

from lbmbench import spans


def read(run):
    return spans.idle_share(run, "lbm.sim.")
