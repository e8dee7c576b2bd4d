"""Share of the traced continuation window in which no kernel ran."""

from benchmark.readers import idle_share


def read(run):
    return idle_share(run)
