"""Share of the traced TTA window in which no kernel ran (1 - the union of
kernel intervals over the window)."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
