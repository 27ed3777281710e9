"""Mean over jobs of index_seconds + device_index_seconds
(--json-summary): the host's graph build and device-index build."""


def read(run):
    if not run.done:
        return None
    return (run.leg_sum("index_seconds")
            + run.leg_sum("device_index_seconds")) / len(run.done)
