"""K6's wait counters: what the program's cuda-p2p and torus kernels
measured of their own time, read after the run.

Each CTA of K6 (``csrc/ring_p2p.cu``) times its life by ``%globaltimer``
and every wait of its producer warp that blocks on a neighbour tile's
flag by its SM's cycle counter, converted to ns by the CTA's life in both
clocks, and adds them into counter words of its card's exchange block;
the program reads them with the error word at the end of each runner
call and adds them up per card in ``tpulbm_torch.ops.ring_p2p.WAITS``
(``{card: {"cta_ns", "wait_ns", "remote_ns", "launches"}}``). So the
numbers are the kernel's own clocks, not the profiler's, and they cover
every K6 launch of the run's process: the warm-up calls too, not only
the traced sub-window. A tree whose program keeps no such counter, or a
run that launched no K6 (the CPU, any other route), reads None, not 0.
"""

from __future__ import annotations


def counters():
    """The program's ``ring_p2p.WAITS``, or None where it has none."""
    try:
        from tpulbm_torch.ops import ring_p2p
    except ImportError:
        return None
    return getattr(ring_p2p, "WAITS", None)


def share(run, key: str):
    """100 ``key`` / ``cta_ns`` on each of the cell's cards that counted a
    K6 CTA, the mean over them; None where none did."""
    waits = counters() or {}
    shares = [100.0 * waits[c][key] / waits[c]["cta_ns"] for c in run.cards
              if c in waits and waits[c].get("cta_ns", 0) > 0]
    if not shares:
        return None
    return sum(shares) / len(shares)
