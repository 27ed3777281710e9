"""Mean wall of the window's jobs, host clock around each call of the
program's command line (graph and device-index build, upload, parse,
map, format, write)."""


def read(run):
    if not run.done:
        return None
    return sum(j.end - j.start for j in run.done) / len(run.done)
