"""Mean over jobs of Σ `index.read` (spans.py): the saved index's
members read from the file (and inflated, in a compressed file), apart
from building the index's objects from them."""

from benchmark import spans


def read(run):
    s = spans.span_sum(run, "index.read")
    return s / len(run.done) if s is not None else None
