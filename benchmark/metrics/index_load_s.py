"""Mean over jobs of index_seconds + upload_seconds (--json-summary):
with --load-index, index_seconds is the saved index's load."""


def read(run):
    if not run.done:
        return None
    return (run.leg_sum("index_seconds")
            + run.leg_sum("upload_seconds")) / len(run.done)
