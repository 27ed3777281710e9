"""Seconds per million reads of the output write: Σ `write` spans (the
joins of the batches' text and the two file writes) over Σ reads of the
jobs, times 1e6 (spans.py)."""

from benchmark import spans


def read(run):
    s = spans.span_sum(run, "write")
    reads = run.leg_sum("reads") if run.done else 0
    return s / reads * 1e6 if s is not None and reads else None
