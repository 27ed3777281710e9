"""100 x (1 - one card's busy time / the window), mean over the cell's
cards; busy is the union of the card's kernel, copy and memset
intervals in the trace (trace.py)."""


def read(run):
    return run.idle_pct()
