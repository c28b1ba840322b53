"""K2's counters: what the program's resident kernel measured of its own
warps, read after the run.

While a ``torch.profiler`` session is open, the program launches K2's
counting instance (``csrc/resident.cu``) in place of the plain one: the
same state and sums, each warp timing in SM cycles its cells, the halo
fill of an edge step (and the spinning in it on words not yet published),
its wait at the step barrier and the launch's ends (the window's load,
the epilogue), converted to ns by its CTA's life in ``%globaltimer`` and
cycles. The program adds them up per card in counter words and reads them
with ``tpulbm_torch.ops.resident.counters()`` (``{card: {"warp_ns",
"cell_ns", "fill_ns", "spin_ns", "barrier_ns", "ends_ns", "warp_steps",
"steps", "launches"}}``; ``warp_ns`` is the CTAs' lives times their
warps). So the numbers are the kernel's own clocks over a ``--trace 1``
run's traced sub-window, the counting's own cost included, and never an
untraced run's. A tree whose program keeps no such counters, or a run in
which no counting launch ran (any route but K2), reads None, not 0.
"""

from __future__ import annotations


def counters():
    """The program's ``resident.counters()``, or None where it has none."""
    try:
        from tpulbm_torch.ops import resident
    except ImportError:
        return None
    read = getattr(resident, "counters", None)
    return read() if read is not None else None


def mean(run, value):
    """``value(words)`` on each of the cell's cards whose K2 counted a
    launch, the mean over them; None where none did."""
    counted = counters() or {}
    got = [value(counted[c]) for c in run.cards
           if counted.get(c, {}).get("launches", 0) > 0
           and counted[c].get("warp_ns", 0) > 0]
    if not got:
        return None
    return sum(got) / len(got)


def share(run, key: str):
    """100 ``key`` / ``warp_ns``, the mean over the cards."""
    return mean(run, lambda w: 100.0 * w[key] / w["warp_ns"])


def step_ns(run):
    """(``warp_ns`` - ``ends_ns``) / ``warp_steps``: a step of a warp, its
    launch's ends left out, the mean over the cards."""
    return mean(run, lambda w: (w["warp_ns"] - w["ends_ns"])
                / w["warp_steps"])
