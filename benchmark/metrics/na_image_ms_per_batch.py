"""Milliseconds per batch of the notAligned image (the reads' base
letters and N, in numpy, holding the GIL): Σ of the jobs'
`format.na_image` spans over their batches (spans.py)."""

from benchmark import spans


def read(run):
    s, n = spans.span_sum(run, "format.na_image"), run.batches()
    return s / n * 1e3 if s is not None and n else None
