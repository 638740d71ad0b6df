"""Lanes x events of every job finished in the window, over the window's
wall time (host clock, from the first job's start to the last job's
end, which ends in a synchronize)."""


def read(run):
    return run["lanes"] * run["events"] * run["jobs"] / run["window_s"]
