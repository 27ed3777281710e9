"""Reads of every job of the window over the time from the window's
start to the last job's end (host clock)."""


def read(run):
    start, end = run.window
    if not run.done or end <= start:
        return None
    return run.n_reads * len(run.done) / (end - start)
