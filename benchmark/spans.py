"""The program's own spans, read from the jobs' summaries and placed on
the device trace's clock.

Under the harness's torch.profiler each job's `--json-summary` carries
a `trace` block (dbgtpu_torch/spans.py): one row a span, with its name,
host thread (`main` or `drain`), batch, card, start and end in seconds
of CLOCK_MONOTONIC (`time.perf_counter()`), the CPU seconds of its
thread, its parent's row and its counters.  The harness stamps each
`Job` with `time.monotonic()`, the same clock, and marks the same job in
the trace by its `bench.job` range, so one offset a job,

    offset_i = run.trace.jobs[i][0] - run.jobs[i].start,

maps job i's spans onto the trace's clock.  The two stamps are taken
around the one `bench.job` entry (`Job.start` just before it,
`record_function`'s start inside it): the offset errs by the few
microseconds between them, far below the idle gaps it splits (a batch's
host legs take milliseconds).

Where a summary has no `trace` block (an untraced run, or a program
without the recorder) the readers here return None and raise nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

UNSPANNED = "unspanned"     # idle time covered by no span below `job`
ROOT = "job"                # the run's root span, left out of coverage
STALL = "stall"             # the main thread waiting for the drain


@dataclass
class Span:
    name: str
    thread: str
    batch: int
    card: int
    start: float
    end: float
    cpu: float
    parent: int
    counters: dict


def job_spans(job) -> list | None:
    """A job's spans on the host clock, or None without a trace block."""
    block = (job.summary or {}).get("trace")
    if not block:
        return None
    fields = block.get("fields") or list(Span.__dataclass_fields__)
    return [Span(**dict(zip(fields, row))) for row in block["spans"]]


def traced_jobs(run) -> list | None:
    """[(job, spans)] of the jobs that ran to their end, or None unless
    every one of them carries a trace block."""
    out = [(j, job_spans(j)) for j in run.done]
    if not out or any(s is None for _, s in out):
        return None
    return out


def span_sum(run, name: str, key: str = "wall") -> float | None:
    """Σ over the done jobs of the spans named `name`: their wall time,
    or their thread's CPU time (`key` "cpu"); None without spans."""
    jobs = traced_jobs(run)
    if jobs is None:
        return None
    return sum((s.end - s.start) if key == "wall" else s.cpu
               for _, spans in jobs for s in spans if s.name == name)


def on_trace(run) -> list | None:
    """Every job's spans shifted onto the trace's clock (one offset a
    job), or None without a trace, a trace block in every job, or one
    `bench.job` range per job."""
    tr = run.trace
    if tr is None or len(tr.jobs) != len(run.jobs):
        return None
    out = []
    for job, (t0, _) in zip(run.jobs, tr.jobs):
        if job.rc != 0 or not job.summary:
            continue
        spans = job_spans(job)
        if spans is None:
            return None
        off = t0 - job.start
        for s in spans:
            s.start += off
            s.end += off
            out.append(s)
    return out


def innermost(spans) -> list:
    """[(start, end, name)] of one thread's properly nested spans: each
    stretch labelled by the innermost span open in it, sorted, not
    overlapping; stretches with no span open are left out."""
    out: list = []
    stack: list = []          # (end, name), outermost first
    t = float("-inf")

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        close_until(s.start)
        if stack and s.start > t:
            out.append((t, s.start, stack[-1][1]))
        t = max(t, s.start)
        stack.append((s.end, s.name))
    close_until(float("inf"))
    return [(a, b, n) for a, b, n in out if b > a]


def labels(spans) -> list:
    """[(start, end, name)], sorted and not overlapping: at each moment
    the main thread's innermost span below `job`, except where that span
    is `stall` (the main thread waiting for the drain): there the drain
    thread's innermost span, or `stall` where the drain has none open."""
    main = innermost([s for s in spans
                      if s.thread == "main" and s.name != ROOT])
    drain = innermost([s for s in spans if s.thread != "main"])
    out, i = [], 0
    for a, b, name in main:
        if name != STALL:
            out.append((a, b, name))
            continue
        t = a
        while i < len(drain) and drain[i][1] <= a:
            i += 1
        j = i
        while j < len(drain) and drain[j][0] < b:
            da, db, dn = drain[j]
            lo, hi = max(da, a), min(db, b)
            if lo > t:
                out.append((t, lo, STALL))
            if hi > lo:
                out.append((lo, hi, dn))
            t = max(t, hi)
            j += 1
        if b > t:
            out.append((t, b, STALL))
    return out


def split(gaps, segs) -> dict:
    """{name: seconds} of the sorted, disjoint `gaps` [(start, end)] by
    the sorted, disjoint labelled `segs` [(start, end, name)]; the rest
    under UNSPANNED."""
    out: dict = {}
    j = 0
    for gs, ge in gaps:
        covered = 0.0
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < ge:
            d = min(ge, segs[k][1]) - max(gs, segs[k][0])
            if d > 0:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + d
                covered += d
            k += 1
        rest = (ge - gs) - covered
        if rest > 0:
            out[UNSPANNED] = out.get(UNSPANNED, 0.0) + rest
    return out


def idle_by_span(run) -> dict | None:
    """{span name: seconds} of the cards' idle gaps in the window (trace
    .py's `idle_gaps`), each stretch given to the span `labels` names
    there, mean over the cards; UNSPANNED holds what no span below `job`
    covers, the harness's time between jobs included.  None without a
    trace or the jobs' spans."""
    spans = on_trace(run)
    if spans is None:
        return None
    segs = labels(spans)
    out: dict = {}
    for card in range(run.cards):
        for name, s in split(run.trace.idle_gaps(card), segs).items():
            out[name] = out.get(name, 0.0) + s / run.cards
    return out
