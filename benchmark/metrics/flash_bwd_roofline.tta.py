"""B2 + B3 (flash_bwd_dq, flash_bwd_dkv) in the TTA window: their launches'
least time over their device time."""

from benchmark.readers import roofline


def read(run):
    return roofline(run, "flash_bwd_dq", "flash_bwd_dkv")
