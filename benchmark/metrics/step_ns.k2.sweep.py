"""step_ns.k2.sweep (ns, csrc kernels: K2's step; moves sweep_mlups, in
sweep-128): a step of a warp of K2 as K2's own clocks read it, ``(warp_ns
- ends_ns) / warp_steps`` per card (the CTAs' lives times their warps,
less the launches' ends, over the steps times the warps), the mean over
the cell's cards.

Each warp of K2's counting instance times its own step, from the step
barrier's release before it to its release after it, in SM cycles,
converted to ns by its CTA's life in ``%globaltimer``.

The numbers are K2's own clock readings, kept by the program
(``lbmbench/k2.py``), over the counting launches of the traced sub-window
alone: the program counts only while a profiler session is open, so the
counting's cost is in this run's time and in no untraced run's. None where
the program keeps no such counter or no counting launch ran. The same
reading as ``step_ns.k2``, in the cell that reports sweep_mlups."""

from lbmbench import k2


def read(run):
    return k2.step_ns(run)
