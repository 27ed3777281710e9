"""Milliseconds of the runner's launch leg per batch: Σ launch_seconds of the
jobs' --json-summary over their batches."""


def read(run):
    n = run.batches()
    return run.leg_sum("launch_seconds") / n * 1e3 if n else None
