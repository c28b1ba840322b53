"""ahead_share.rows4 (%, csrc kernels: K6's exchange; moves mlups): the
share of the items a CTA of K6's ring mode took after its first that its
producer warp issued while the item before was still stepping, so that
their windows loaded under that step: ``ahead_n / next_n`` per card, the
mean over the cell's cards.

The rest of the items waited for a flag after the step before had ended
(``p2p_wait_share.rows4`` times those waits). The numbers are K6's own
counts, kept by the program (``lbmbench/waits.py``), over every K6 launch
of the run, the 2 warm-up calls included, not the traced sub-window
alone. None where the program keeps no such count (a tree before it) or
launched no K6."""

from lbmbench import waits


def read(run):
    counted = waits.counters() or {}
    shares = [100.0 * counted[c]["ahead_n"] / counted[c]["next_n"]
              for c in run.cards
              if c in counted and counted[c].get("next_n", 0) > 0]
    if not shares:
        return None
    return sum(shares) / len(shares)
