"""Milliseconds per batch of the paths text (native): Σ of the jobs'
`format.paths` spans over their batches (spans.py)."""

from benchmark import spans


def read(run):
    s, n = spans.span_sum(run, "format.paths"), run.batches()
    return s / n * 1e3 if s is not None and n else None
