"""The program's span recorder: its one timer of host work.

A span is a named stretch of one host thread's time:

    with spans.span("launch", batch=b):
        with spans.span("launch.card", batch=b, card=c):
            ...
            spans.count("bytes", n)     # into the innermost open span

One `Recorder` belongs to one run (`cli.main`, `run_pipeline`,
`run_pipeline_resumable`); `pipeline.TorchRunStats` holds it, and the
`--json-summary` legs (`parse_seconds`, `launch_seconds`, ...) are the
sums of its spans' wall time, by name (`TorchRunStats.LEGS`).

Off (the default) a recorder keeps only those sums: two clock reads and
one dict update a span.  On (`Recorder.on`: the run started under an
active torch.profiler, or with `--profile-dir`) it also keeps every
span: its name, host thread (`main`, the thread that made the recorder,
or `drain`), batch and card (-1 where none; a span given neither takes
its parent's), start and end on
`time.perf_counter()`, which on Linux is CLOCK_MONOTONIC, the clock of
`time.monotonic()` too, the CPU seconds of its thread
(`time.thread_time()`), its parent (the innermost span open on the same
thread when it opened) and its counters.  `trace()` gives them as the
`trace` block of `--json-summary`, one row a span.

The spans are kept here and not given to torch.profiler's
`record_function`: a worker thread started inside an active profiler
(the runner's drain thread) is not profiled, so its ranges would be
missing from the trace.  A reader places the rows on a trace's clock by
one offset (cli._profiled does so for `--profile-dir`).
"""

from __future__ import annotations

import threading
import time

CLOCK = "CLOCK_MONOTONIC"
FIELDS = ("name", "thread", "batch", "card", "start", "end", "cpu",
          "parent", "counters")


class Span:
    """One open or closed span; its seconds once closed."""

    __slots__ = ("rec", "name", "batch", "card", "thread", "start", "end",
                 "cpu", "parent", "counters")

    def __init__(self, rec, name, batch, card):
        self.rec, self.name, self.batch, self.card = rec, name, batch, card
        self.end = None

    def __enter__(self):
        rec = self.rec
        if rec.on:
            stack = rec._stack()
            self.parent = p = stack[-1] if stack else None
            if p is not None:
                # a span of no batch or card takes its parent's
                if self.batch < 0:
                    self.batch = p.batch
                if self.card < 0:
                    self.card = p.card
            self.thread = th = ("main" if threading.get_ident() == rec.owner
                                else "drain")
            if th not in rec.tids:
                rec.tids[th] = threading.get_native_id()
            self.counters = None
            stack.append(self)
            rec.rows.append(self)
            self.cpu = time.thread_time()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = t = time.perf_counter()
        rec = self.rec
        with rec.lock:
            rec.sums[self.name] = rec.sums.get(self.name, 0.0) + (
                t - self.start)
        if rec.on:
            self.cpu = time.thread_time() - self.cpu
            rec._stack().pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end if self.end is not None
                else time.perf_counter()) - self.start


class Recorder:
    """The spans of one run; see the module's docstring."""

    def __init__(self, on: bool = False):
        self.on = bool(on)
        self.owner = threading.get_ident()
        self.sums: dict = {}     # wall seconds by name, both threads
        self.lock = threading.Lock()
        self.rows: list = []
        self.tids: dict = {}     # host thread -> its system thread id
        self.next_batch = 0
        self._local = threading.local()

    @classmethod
    def for_run(cls, profile_dir=None) -> "Recorder":
        """A recorder that is on where an operator asked for a trace
        (`profile_dir`) or torch.profiler is active on this thread."""
        import torch

        return cls(bool(profile_dir)
                   or torch._C._autograd._profiler_enabled())

    def _stack(self) -> list:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def span(self, name: str, batch: int = -1, card: int = -1) -> Span:
        return Span(self, name, batch, card)

    def count(self, name: str, n) -> None:
        """Adds `n` to counter `name` of this thread's innermost open
        span (kept only when on)."""
        if not self.on:
            return
        stack = self._stack()
        if stack:
            sp = stack[-1]
            if sp.counters is None:
                sp.counters = {}
            sp.counters[name] = sp.counters.get(name, 0) + n

    def add(self, name: str, seconds: float) -> None:
        """Adds `seconds` to the sum of `name` without a span (a leg
        timed elsewhere, such as an older runner's)."""
        with self.lock:
            self.sums[name] = self.sums.get(name, 0.0) + seconds

    def total(self, *names: str) -> float:
        """Wall seconds of every closed span of these names."""
        return sum(self.sums.get(n, 0.0) for n in names)

    def batches(self, n: int) -> int:
        """The first of `n` batch ids, unique within the run."""
        b0 = self.next_batch
        self.next_batch += n
        return b0

    def trace(self) -> dict | None:
        """{"clock", "fields", "spans"}: the closed spans as rows in
        FIELDS order (parent: the row index of the parent span, -1 for
        none), or None when the recorder is off."""
        if not self.on:
            return None
        done = [s for s in list(self.rows) if s.end is not None]
        index = {id(s): i for i, s in enumerate(done)}
        return {"clock": CLOCK, "fields": list(FIELDS), "spans": [
            [s.name, s.thread, s.batch, s.card, s.start, s.end, s.cpu,
             index.get(id(s.parent), -1), s.counters or {}]
            for s in done]}
