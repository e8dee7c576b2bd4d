"""Share of the TTA window in the DiT blocks' own work: device self
seconds of dit.block (forward and remat recompute), what its op spans
leave (gates, residual adds, SiLU x mul, casts)."""

from benchmark.program import device_share


def read(run):
    return device_share(run, "dit.block", self_time=True)
