"""Milliseconds of the runner's stall leg per batch: Σ stall_seconds of the
jobs' --json-summary over their batches."""


def read(run):
    n = run.batches()
    return run.leg_sum("stall_seconds") / n * 1e3 if n else None
