"""The continuation window's products (conditioning caches and CFG steps)
at the published peaks over the window's time."""

from benchmark.readers import step_mfu


def read(run):
    return step_mfu(run)
