"""Process start to the window's start (host clock): imports, the
kernel library loaded or built, the trace and the grid drawn, the
warm-up over the trace's head, which captures the block runner."""


def read(run):
    return run["setup_s"]
