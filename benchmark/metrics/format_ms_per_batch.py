"""Milliseconds of the runner's format leg per batch: Σ format_seconds of the
jobs' --json-summary over their batches."""


def read(run):
    n = run.batches()
    return run.leg_sum("format_seconds") / n * 1e3 if n else None
