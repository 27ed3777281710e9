"""Milliseconds per batch of the notAligned text (native): Σ of the
jobs' `format.na_text` spans over their batches (spans.py)."""

from benchmark import spans


def read(run):
    s, n = spans.span_sum(run, "format.na_text"), run.batches()
    return s / n * 1e3 if s is not None and n else None
