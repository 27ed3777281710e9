"""Process start to the window's start (host clock): imports, CUDA
context, the cached graph files (built on a checkout's first run), the
read file, one warm-up job."""


def read(run):
    return run.setup_s
