"""B1 (flash_fwd) in the continuation window: its launches' least time over
its device time."""

from benchmark.readers import roofline


def read(run):
    return roofline(run, "flash_fwd")
