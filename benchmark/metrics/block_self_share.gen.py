"""Share of the continuation window in the DiT blocks' own work: device self
seconds of dit.block, what its op spans leave (gates, residual adds,
SiLU x mul, casts, the KV-cache concat)."""

from benchmark.program import device_share


def read(run):
    return device_share(run, "dit.block", self_time=True)
