"""100 x the cards' idle time in the window that no program span below
`job` covers (the harness's time between jobs included) over their idle
time (spans.py idle_by_span): what the program's spans leave unseen."""

from benchmark import spans


def read(run):
    idle = spans.idle_by_span(run)
    total = sum(idle.values()) if idle else 0.0
    return 100.0 * idle.get(spans.UNSPANNED, 0.0) / total if total else None
