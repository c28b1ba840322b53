"""The program's own spans in a traced sub-window, and the device's idle
time put down to them.

``tpulbm_torch`` records a host operation named ``lbm.<layer>.<what>``
into the open profiler session at each of its layer boundaries
(``tpulbm_torch.utils.profiling.span``); they are among a stopped
session's ``host`` events, ``(name, start s, end s)``, on the clock of its
``device`` events. A tree whose program records none reads None from
every function here, not 0.
"""

from __future__ import annotations

from collections import defaultdict

from lbmbench import devtrace

PREFIX = "lbm."


def program_spans(session) -> list:
    """The session's ``(name, start, end)`` host events of the program."""
    return [e for e in session.host if e[0].startswith(PREFIX)]


def innermost(spans) -> list:
    """Disjoint ``(start, end, name)`` stretches, in time order, each named
    by the innermost of the spans that cover it: the one that began last
    (the spans of one thread nest). Stretches that no span covers are
    left out."""
    spans = sorted(spans, key=lambda e: (e[1], -e[2]))
    points = sorted({t for _, a, b in spans for t in (a, b)})
    out, active, i = [], [], 0
    for lo, hi in zip(points, points[1:]):
        while i < len(spans) and spans[i][1] <= lo:
            active.append(spans[i])
            i += 1
        active = [e for e in active if e[2] > lo]
        if not active:
            continue
        name = active[-1][0]
        if out and out[-1][2] == name and out[-1][1] == lo:
            out[-1] = (out[-1][0], hi, name)
        else:
            out.append((lo, hi, name))
    return out


def idle_by_span(session):
    """{card: {span name: seconds}}: each card's idle time (the ``gaps``
    of its device intervals) within the program's spans, put down to the
    innermost span at each instant; None without program spans or device
    events."""
    spans = program_spans(session)
    if not spans or not session.device:
        return None
    named = innermost(spans)
    lo, hi = named[0][0], named[-1][1]
    out = {}
    for card, intervals in session.intervals.items():
        idle = defaultdict(float)
        gaps, j = devtrace.gaps(intervals, lo, hi), 0
        for a, b, name in named:
            while j < len(gaps) and gaps[j][1] <= a:
                j += 1
            k = j
            while k < len(gaps) and gaps[k][0] < b:
                idle[name] += min(b, gaps[k][1]) - max(a, gaps[k][0])
                k += 1
        out[card] = dict(idle)
    return out


def idle_share(run, prefix: str):
    """The share (%) of the traced sub-window in which a card was idle while
    the host's innermost program span was one whose name starts with
    ``prefix``; the mean over the cell's cards."""
    s = run.session
    by_card = idle_by_span(s)
    if by_card is None:
        return None
    shares = [sum(t for name, t in idle.items() if name.startswith(prefix))
              for idle in by_card.values()]
    return 100.0 * sum(shares) / len(shares) / s.window_s


def ms_per_unit(run, names):
    """The wall time of the spans named in ``names`` in the traced
    sub-window, summed, over its whole calls or solves (ms)."""
    s = run.session
    spans = program_spans(s)
    if not spans or not s.units:
        return None
    total = sum(b - a for name, a, b in spans if name in names)
    return 1e3 * total / s.units
