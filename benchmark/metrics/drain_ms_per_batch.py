"""Milliseconds of the runner's drain leg per batch: Σ drain_seconds of the
jobs' --json-summary over their batches."""


def read(run):
    n = run.batches()
    return run.leg_sum("drain_seconds") / n * 1e3 if n else None
