"""Seconds of parse per million reads: Σ parse_seconds / Σ reads of the
jobs' --json-summary, times 1e6 (the native parser, before the
pipeline)."""


def read(run):
    reads = run.leg_sum("reads") if run.done else 0
    return run.leg_sum("parse_seconds") / reads * 1e6 if reads else None
