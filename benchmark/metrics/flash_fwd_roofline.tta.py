"""B1 (flash_fwd) in the TTA window: its launches' least time over its
device time; remat's second forward is in the device time only."""

from benchmark.readers import roofline


def read(run):
    return roofline(run, "flash_fwd")
