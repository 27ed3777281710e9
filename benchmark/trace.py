"""Reading a torch.profiler trace of the window: device intervals per
card, the mapping kernels' time, the idle share and the idle gaps.

The harness profiles the window with CPU and CUDA activity and marks
it, and each job in it, with a `record_function` span ("bench.window",
"bench.job"); kineto puts host spans and device events on one clock in
its Chrome trace (microseconds).  A device event is a kernel, a copy or
a memset ("cat" kernel, gpu_memcpy, gpu_memset), on the card its
"device" argument names.  A card's busy time is the union of its
events' intervals inside the window, so events of two streams that
overlap count once, and each card is counted on its own.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window: tuple            # (start, end) in seconds
    jobs: list               # [(start, end)] of the jobs' spans
    # device events: (card, name, start, end) in seconds
    events: list = field(default_factory=list)

    def busy_s(self, card: int) -> float:
        lo, hi = self.window
        return union_length([(s, e) for c, _, s, e in self.events
                             if c == card], lo, hi)

    def idle_gaps(self, card: int) -> list:
        """[(start, end)] of the window's stretches in which `card` ran
        nothing."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in merged([(s, e) for c, _, s, e in self.events
                            if c == card], lo, hi):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def time_by_name(self) -> dict:
        """{name: seconds} of the device events inside the window."""
        lo, hi = self.window
        out: dict = {}
        for _, name, s, e in self.events:
            d = min(e, hi) - max(s, lo)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
        return out


def merged(intervals, lo: float, hi: float) -> list:
    """The intervals clipped to [lo, hi], sorted and merged."""
    out: list = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def union_length(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def from_chrome(path) -> Trace:
    """The Trace of a kineto Chrome trace written by the harness."""
    with open(path) as f:
        doc = json.load(f)
    window, jobs, events = None, [], []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        name = ev.get("name", "")
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            card = int((ev.get("args") or {}).get("device", 0))
            events.append((card, name, s, e))
        elif cat.startswith("gpu"):
            continue        # the device's copy of an annotation
        elif name == "bench.window":
            window = (s, e)
        elif name == "bench.job":
            jobs.append((s, e))
    if window is None:
        raise ValueError(f"{path}: no bench.window span")
    return Trace(window, sorted(jobs), events)
