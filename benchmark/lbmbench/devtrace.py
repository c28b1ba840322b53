"""One ``torch.profiler`` session over a sub-window of whole runner calls
or solves, and what the metric readers read from it.

The session traces the host and every card (CUPTI). A process opens one
session: a second loses events. Device activity is every event the trace
puts on a card, kernels, copies and memsets, whatever their names, but
the annotations that mirror the harness's spans (``bench.*``) there.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


def union(intervals) -> float:
    """Seconds covered by the (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def _events(prof):
    """(device events [(card, name, start s, end s)], host events [(name,
    start s, end s)]) of a stopped session."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if hasattr(ev, "start_ns"):
            a, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        else:
            a, d = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # the harness's spans are mirrored on the card's timeline as
            # annotations: they are no device activity
            if not name.startswith("bench."):
                device.append((ev.device_index(), name, a, a + d))
        elif not name.startswith(("PyTorch Profiler", "ProfilerStep")):
            host.append((name, a, a + d))
    return device, host


class Session:
    """A profiler session that starts and stops between whole calls;
    ``cards`` are the cell's CUDA device indices."""

    def __init__(self, cards):
        self.cards = list(cards)
        self.prof = None
        self.done = False
        self.steps = 0
        self.units = 0

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        for c in self.cards:
            torch.cuda.synchronize(c)
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.done = True
        self.device, self.host = _events(self.prof)
        self.prof = None
        by_card = defaultdict(list)
        for card, _, a, b in self.device:
            by_card[card].append((a, b))
        self.intervals = {c: by_card.get(c, []) for c in self.cards}
        self.busy = {c: union(v) for c, v in self.intervals.items()}

    def add(self, steps: int, units: int = 1) -> None:
        """Count ``units`` whole calls or solves of ``steps`` lattice steps
        in all."""
        self.steps += steps
        self.units += units

    @property
    def busy_s(self) -> float:
        return sum(self.busy.values()) / max(len(self.cards), 1)

    def breakdown(self) -> dict:
        """The ten device operations that took most time (summed over the
        cards) and the ten longest idle gaps of any card, each named by
        the harness's span and the innermost host operation at its
        middle."""
        ops = defaultdict(float)
        for _, name, a, b in self.device:
            ops[name] += b - a
        lo = min(a for _, a, _ in self.host)
        hi = max(b for _, _, b in self.host)
        found = []
        for card, spans in self.intervals.items():
            found += [(b - a, a, b, card) for a, b in gaps(spans, lo, hi)]
        named = []
        for length, a, b, card in sorted(found, reverse=True)[:10]:
            mid = (a + b) / 2
            over = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            spans = [n for _, n in sorted(over, reverse=True)
                     if n.startswith("bench.")]
            ops_at = [n for _, n in sorted(over) if not n.startswith("bench.")]
            what = spans[0] if spans else "outside the harness's spans"
            what += ": " + (ops_at[0] if ops_at else "host code")
            named.append([f"cuda:{card} {what}", length])
        return {"device_ops": sorted(([n, s] for n, s in ops.items()),
                                     key=lambda x: -x[1])[:10],
                "idle_gaps": named}
