"""100 x the drain thread's CPU seconds over the wall seconds of its
`drain` spans (rebuild, recompute, format; its fetches, which wait for
the card, left out), all jobs (spans.py): under 100 the drain waited,
for the GIL or the OS."""

from benchmark import spans


def read(run):
    wall = spans.span_sum(run, "drain")
    if not wall:
        return None
    return 100.0 * spans.span_sum(run, "drain", "cpu") / wall
