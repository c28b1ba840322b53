"""stall_ckpt.ckpt (%, sim: the checkpoint path; moves mlups): the share of
the traced sub-window in which the card stepped no kernel while the
host's innermost program span was one of a save's (``lbm.ckpt.copy`` and
the joins of the writer thread inside it): the card idle or busy with the
state's copy to the host (a ``Memcpy``, which ``idle_ckpt.ckpt`` counts as
busy), averaged over the cell's cards. The join that ends a ``run()``, a
``lbm.ckpt.wait`` outside every ``lbm.ckpt.copy``, is left out: a long
``run()`` pays it once, and the traced sub-window is a ``run()`` of its
own. None where the program records no ``lbm.ckpt.copy`` span there (a
tree before it)."""

from collections import defaultdict

from lbmbench import devtrace, spans

COPY, WAIT = "lbm.ckpt.copy", "lbm.ckpt.wait"


def _saves_spans(found):
    """The program's spans less each ``lbm.ckpt.wait`` that no
    ``lbm.ckpt.copy`` holds (the join at a ``run()``'s end)."""
    copies = [(a, b) for name, a, b in found if name == COPY]
    return [(name, a, b) for name, a, b in found
            if name != WAIT or any(c <= a and b <= d for c, d in copies)]


def read(run):
    found = spans.program_spans(run.session) if run.session else []
    if not any(name == COPY for name, _, _ in found):
        return None
    named = spans.innermost(_saves_spans(found))
    lo, hi = named[0][0], named[-1][1]
    kernels = defaultdict(list)
    for card, name, a, b in run.session.device:
        if not name.startswith(("Memcpy", "Memset")):
            kernels[card].append((a, b))
    shares = []
    for card in run.session.intervals:
        stalled = devtrace.gaps(kernels[card], lo, hi)
        shares.append(sum(
            max(0.0, min(b, gb) - max(a, ga))
            for a, b, name in named if name.startswith("lbm.ckpt.")
            for ga, gb in stalled))
    return 100.0 * sum(shares) / len(shares) / run.session.window_s
